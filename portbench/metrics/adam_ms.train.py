"""Adam's device time a step: CUDA events at the train step's phase marks,
g_backward → g_adam plus d_forward_backward → d_adam, averaged over the
traced steps."""

LAYER, UNIT, SOURCE, MOVES = "train step", "ms", "program_span", \
    "train_img_s"


def read(rec):
    ms = rec.get("adam_ms") or []
    return sum(ms) / len(ms) if ms else None
