"""K8 (`msrb_branch_int8`): the operations and bytes of the four launches
of one MSRB block, the arithmetic of PERF.md's kernel table. Stage 1
reads the block's int8 input and writes int8; stage 2 reads both stage-1
outputs (2C channels) and writes bf16."""

from portbench.counts.peaks import bound_s


def block_bounds_s(n: int, h: int, w: int, c: int):
    """Least seconds of each of one block's four launches at (n, h, w, c):
    stage 1 3×3, 5×5, stage 2 3×3, 5×5."""
    out = []
    for cin, quant_out in ((c, True), (2 * c, False)):
        for kk in (3, 5):
            ops = 2.0 * n * h * w * kk * kk * cin * c
            nbytes = (n * h * w * (cin + c * (1 if quant_out else 2))
                      + kk * kk * cin * c + 2 * c * 4)
            out.append(bound_s(ops, nbytes, "int8"))
    return out
