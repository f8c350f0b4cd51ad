"""The share of the traced window in which no kernel, copy or memset ran
on the card: the union of the device intervals of `torch.profiler`."""

from portbench.trace import idle_percent

LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "infer_img_s"


def read(rec):
    return idle_percent(rec)
