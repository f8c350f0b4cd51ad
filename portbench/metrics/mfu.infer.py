"""The generator call's share of the card's peak: the least time of every
conv of the calls in the traced window, each at the peak of the dtype the
engine runs it in (int8 for the quantised trunk, bf16 for the rest),
counted from the configuration's shapes, over the window's length."""

LAYER, UNIT, SOURCE, MOVES = "engine", "%", "host_clock", "infer_img_s"


def read(rec):
    int8 = rec["cell"]["params"]["entry"] == "infer_step_int8"
    least = rec["counts"].infer_least_s(rec["cfg"], rec["batch"], int8)
    return 100.0 * rec["calls"] * least / rec["window_s"]
