"""Model FLOPs of pix2pixHD's multiscale PatchGAN discriminator (4×4
convs, zero padding 2), counted from its shapes."""

from portbench.counts.peaks import conv_flops


def forward_flops(cfg: dict, n: int, size: int) -> float:
    """One forward of D on ``n`` images of ``size``²."""
    total, h = 0.0, size
    nf = [cfg["ndf"]]
    for _ in range(cfg["n_layers_D"]):
        nf.append(min(nf[-1] * 2, 512))
    for _ in range(cfg["num_D"]):
        cin, hh = cfg["input_nc"] + cfg["output_nc"], h
        layers = [(nf[0], 2)] + [(nf[i], 2 if i < cfg["n_layers_D"] else 1)
                                 for i in range(1, cfg["n_layers_D"] + 1)]
        layers.append((1, 1))
        for cout, stride in layers:
            hh = hh // 2 + 1 if stride == 2 else hh + 1
            total += conv_flops(n, hh, hh, cin, cout, 4)
            cin = cout
        h = (h - 1) // 2 + 1       # 3×3 stride-2 average pool, padding 1
    return total
