"""The train step's share of the card's bf16 peak: the model FLOPs of the
steps in the traced window (G forward and backward, D's forwards and
backwards, counted from the configuration's shapes) at 989 TFLOP/s, over
the window's length."""

from portbench.counts.peaks import PEAK_OPS

LAYER, UNIT, SOURCE, MOVES = "train step", "%", "host_clock", "train_img_s"


def read(rec):
    flops = rec["counts"].train_flops(rec["cfg"], rec["batch"])
    return 100.0 * rec["steps"] * flops / PEAK_OPS["bf16"] / rec["window_s"]
