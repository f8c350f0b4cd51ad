"""K8's share of its roofline: the least time of its launches in the
traced window (each launch's bound from the configuration's `counts`
module) over the device time of the kernels the trace links to
`cistar::msrb_branch_int8`."""

from portbench.trace import roofline_percent

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "infer_img_s"
OPS = ("msrb_branch_int8",)


def read(rec):
    return roofline_percent(rec, OPS)
