"""Model FLOPs of pix2pixHD's `global` generator of p2phd_global_512,
from the configuration's shapes. The int8 engine runs the resnet blocks'
convs in int8 (K7a, K7b) and every other conv in bf16."""

from portbench.counts import k7
from portbench.counts.peaks import conv_flops, convt_flops, least_s


def generator_convs(cfg: dict, n: int, int8: bool):
    """(flops, dtype) of every conv of one forward on ``n`` frames."""
    s, f, nd = cfg["fineSize"], cfg["ngf"], cfg["n_downsample_global"]
    trunk = "int8" if int8 else "bf16"
    out = [(conv_flops(n, s, s, cfg["input_nc"], f, 7), "bf16")]
    for i in range(nd):
        h = s // 2 ** (i + 1)
        out.append((conv_flops(n, h, h, f * 2 ** i, f * 2 ** (i + 1), 3),
                    "bf16"))
    c, h = f * 2 ** nd, s // 2 ** nd
    out += [(conv_flops(n, h, h, c, c, 3), trunk)] \
        * (2 * cfg["n_blocks_global"])
    for i in range(nd):
        ci, hi = c // 2 ** i, h * 2 ** i
        out.append((convt_flops(n, hi, hi, ci, ci // 2, 3), "bf16"))
    out.append((conv_flops(n, s, s, f, cfg["output_nc"], 7), "bf16"))
    return out


def infer_least_s(cfg: dict, n: int, int8: bool) -> float:
    """Least seconds of one generator call on ``n`` frames at the peaks."""
    return least_s(generator_convs(cfg, n, int8))


def kernel_bounds(cfg: dict, n: int) -> dict:
    """Least seconds of one launch of each port kernel op the int8 engine
    runs on ``n`` frames, by op name: K7a and K7b on the resnet trunk."""
    nd = cfg["n_downsample_global"]
    h, c = cfg["fineSize"] // 2 ** nd, cfg["ngf"] * 2 ** nd
    return {f"resblock_int8_tiled_{half}": k7.half_bound_s(n, h, h, c, half)
            for half in "ab"}
