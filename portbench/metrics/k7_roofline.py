"""K7a + K7b's share of their roofline: the least time of their launches
in the traced window (each launch's bound from the configuration's
`counts` module) over the device time of the kernels the trace links to
`cistar::resblock_int8_tiled_a` and `_b`."""

from portbench.trace import roofline_percent

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "infer_img_s"
OPS = ("resblock_int8_tiled_a", "resblock_int8_tiled_b")


def read(rec):
    return roofline_percent(rec, OPS)
