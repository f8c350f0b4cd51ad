"""Model FLOPs of the `UNet` (MSRB) generator of p2phd_r2l_msrb7_512 and
of its train step, from the configuration's shapes. The int8 engine runs
the MSRB branch convs in int8 (K8) and every other conv in bf16."""

from portbench.counts import k8, pix2pixhd_d
from portbench.counts.peaks import conv_flops, convt_flops, least_s


def generator_convs(cfg: dict, n: int, int8: bool):
    """(flops, dtype) of every conv of one forward on ``n`` frames."""
    s, f = cfg["fineSize"], cfg["ngf"]
    trunk = "int8" if int8 else "bf16"
    out = [(conv_flops(n, s, s, cfg["input_nc"], f, 7), "bf16")]
    for i in range(3):
        h = s // 2 ** (i + 1)
        out.append((conv_flops(n, h, h, f * 2 ** i, f * 2 ** (i + 1), 7),
                    "bf16"))
    nf, h = f * 8, s // 8
    for _ in range(cfg["n_blocks_global"]):
        out += [(conv_flops(n, h, h, nf, nf, 3), trunk),
                (conv_flops(n, h, h, nf, nf, 5), trunk),
                (conv_flops(n, h, h, 2 * nf, nf, 3), trunk),
                (conv_flops(n, h, h, 2 * nf, nf, 5), trunk),
                (conv_flops(n, h, h, 2 * nf, nf, 1), "bf16")]
    for i in range(3):
        hi = h * 2 ** i
        out.append((convt_flops(n, hi, hi, 2 * nf // 2 ** i,
                                nf // 2 ** (i + 1), 3), "bf16"))
    out.append((conv_flops(n, s, s, f, cfg["output_nc"], 7), "bf16"))
    return out


def infer_least_s(cfg: dict, n: int, int8: bool) -> float:
    """Least seconds of one generator call on ``n`` frames at the peaks."""
    return least_s(generator_convs(cfg, n, int8))


def kernel_bounds(cfg: dict, n: int) -> dict:
    """Least seconds of one launch of each port kernel op the int8 engine
    runs on ``n`` frames, by op name: K8 on the MSRB trunk (at
    ``fineSize`` / 8, 8 × ``ngf`` features), the mean of a block's four
    launches, which come in fours."""
    h = cfg["fineSize"] // 8
    block = k8.block_bounds_s(n, h, h, 8 * cfg["ngf"])
    return {"msrb_branch_int8": sum(block) / len(block)}


def train_flops(cfg: dict, n: int) -> float:
    """One step at batch ``n``: G forward and backward (3 forwards), D in
    G's loss (forward on fake and real, backward to the fake: 3 image
    forwards) and D's own step (forward and backward on both: 6)."""
    g = sum(fl for fl, _ in generator_convs(cfg, n, False))
    return 3 * g + 9 * pix2pixhd_d.forward_flops(cfg, n, cfg["fineSize"])
