"""Model FLOPs of pix2pixHD's `local` generator (`LocalEnhancer`) of
p2phd_local_1024, from the configuration's shapes: the global G, without
its head, at ngf·2^n_local_enhancers on the input pooled
n_local_enhancers times (`p2phd_global_512`'s counts at that size and
width), then each enhancer's convs and the head. The int8 engine runs the
global G's resnet convs in int8 (K7a, K7b) and every other conv, the
fine stream's included, in bf16."""

from portbench.counts import k7, p2phd_global_512
from portbench.counts.peaks import conv_flops, convt_flops, least_s


def _global(cfg: dict) -> dict:
    """The global G's configuration: its size and its ngf."""
    ne = cfg["n_local_enhancers"]
    return dict(cfg, fineSize=cfg["fineSize"] // 2 ** ne,
                ngf=cfg["ngf"] * 2 ** ne)


def generator_convs(cfg: dict, n: int, int8: bool):
    """(flops, dtype) of every conv of one forward on ``n`` frames."""
    out = p2phd_global_512.generator_convs(_global(cfg), n, int8)[:-1]
    ne, cin = cfg["n_local_enhancers"], cfg["input_nc"]
    for e in range(1, ne + 1):
        s = cfg["fineSize"] // 2 ** (ne - e)
        f = cfg["ngf"] * 2 ** (ne - e)
        out.append((conv_flops(n, s, s, cin, f, 7), "bf16"))
        out.append((conv_flops(n, s // 2, s // 2, f, 2 * f, 3), "bf16"))
        out += [(conv_flops(n, s // 2, s // 2, 2 * f, 2 * f, 3), "bf16")] \
            * (2 * cfg["n_blocks_local"])
        out.append((convt_flops(n, s // 2, s // 2, 2 * f, f, 3), "bf16"))
    s = cfg["fineSize"]
    out.append((conv_flops(n, s, s, cfg["ngf"], cfg["output_nc"], 7),
                "bf16"))
    return out


def infer_least_s(cfg: dict, n: int, int8: bool) -> float:
    """Least seconds of one generator call on ``n`` frames at the peaks."""
    return least_s(generator_convs(cfg, n, int8))


def kernel_bounds(cfg: dict, n: int) -> dict:
    """Least seconds of one launch of each port kernel op the int8 engine
    runs on ``n`` frames, by op name: K7a and K7b on the global G's
    resnet trunk."""
    g = _global(cfg)
    nd = g["n_downsample_global"]
    h, c = g["fineSize"] // 2 ** nd, g["ngf"] * 2 ** nd
    return {f"resblock_int8_tiled_{half}": k7.half_bound_s(n, h, h, c, half)
            for half in "ab"}
