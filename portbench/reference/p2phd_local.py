"""Plain fp32 pix2pixHD `LocalEnhancer` (`netG local`, pix2pixHD's
`models/networks.py::LocalEnhancer`): the input average-pooled
``n_local_enhancers`` times (3×3, stride 2, padding 1,
``count_include_pad=False``); on the coarsest level pix2pixHD's
`GlobalGenerator` at ngf·2^n_local_enhancers without its head (c7s1,
stride-2 3×3 downs, resnet blocks, transposed-conv ups, each with instance
norm and ReLU); then each enhancer n: c7s1 and a stride-2 3×3 down on its
level, summed with the coarser output, ``n_blocks_local`` resnet blocks,
a transposed-conv up, and after the last the 7×7 reflect head with tanh.

The ops are those of :mod:`.p2phd` (NCHW float32 through
`torch.nn.functional`, two-pass instance norm); it imports nothing of the
program, and callers turn TF32 off (`fp32_exact`). Parameters are keyed
by the names that :func:`generator_spec` lists, those of the port's
``LocalEnhancer`` state dict (``global.*``, ``enh{n}_*``, ``head.conv``).

Departures from pix2pixHD: none at the configuration's settings (instance
norm, reflect padding; pix2pixHD's `ResnetBlock` has ``use_dropout``
false there). The `Precision` parts: ``trunk`` is the global G's resnet
convs, which the int8 engine quantises; ``rest`` every other conv,
the fine stream's resnet blocks and the head included.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

# fp32_exact, FP32 and Precision: the interface the traffic modules call
from .p2phd import (FP32, Params, Precision, Spec, _conv_spec, conv, conv_t,
                    fp32_exact, inorm)

__all__ = ["FP32", "Precision", "fp32_exact", "generator_spec", "generator",
           "generate_nhwc"]


def _widths(cfg: dict):
    """The global G's ngf, and each enhancer's (1 … n_local_enhancers)."""
    ne = cfg["n_local_enhancers"]
    return (cfg["ngf"] * 2 ** ne,
            [cfg["ngf"] * 2 ** (ne - n) for n in range(1, ne + 1)])


def generator_spec(cfg: dict) -> Spec:
    """G's parameters, names and shapes."""
    cin, cout = cfg["input_nc"], cfg["output_nc"]
    fg, fe = _widths(cfg)
    nd = cfg["n_downsample_global"]
    s = _conv_spec("global.stem.conv", fg, cin, 7)
    for i in range(nd):
        s += _conv_spec(f"global.down.{i}.conv", fg * 2 ** (i + 1),
                        fg * 2 ** i, 3)
    c = fg * 2 ** nd
    for i in range(cfg["n_blocks_global"]):
        s += (_conv_spec(f"global.res.{i}.conv1", c, c, 3)
              + _conv_spec(f"global.res.{i}.conv2", c, c, 3))
    for i in range(nd):
        ci = fg * 2 ** (nd - i)
        s += [(f"global.up.{i}.convt.weight", (ci, ci // 2, 3, 3)),
              (f"global.up.{i}.convt.bias", (ci // 2,))]
    for n, f in enumerate(fe, start=1):
        e = f"enh{n}_"
        s += _conv_spec(e + "stem.conv", f, cin, 7)
        s += _conv_spec(e + "down.conv", 2 * f, f, 3)
        for i in range(cfg["n_blocks_local"]):
            s += (_conv_spec(f"{e}res_{i}.conv1", 2 * f, 2 * f, 3)
                  + _conv_spec(f"{e}res_{i}.conv2", 2 * f, 2 * f, 3))
        s += [(e + "up.convt.weight", (2 * f, f, 3, 3)),
              (e + "up.convt.bias", (f,))]
    return s + _conv_spec("head.conv", cout, cfg["ngf"], 7)


def pyramid(cfg: dict, x: torch.Tensor) -> List[torch.Tensor]:
    """[x, x/2, …]: ``n_local_enhancers`` average pools."""
    pyr = [x]
    for _ in range(cfg["n_local_enhancers"]):
        pyr.append(F.avg_pool2d(pyr[-1], 3, 2, 1, count_include_pad=False))
    return pyr


def _resnet(p: Params, b: str, h: torch.Tensor, prec: Precision,
            part: str) -> torch.Tensor:
    r = F.relu(inorm(conv(h, p, b + "conv1", prec, pad=1, reflect=True,
                          part=part)))
    return h + inorm(conv(r, p, b + "conv2", prec, pad=1, reflect=True,
                          part=part))


def global_without_head(cfg: dict, p: Params, x: torch.Tensor,
                        prec: Precision = FP32) -> torch.Tensor:
    """The global G on the coarsest level, up to its last up."""
    h = F.relu(inorm(conv(x, p, "global.stem.conv", prec, pad=3,
                          reflect=True)))
    nd = cfg["n_downsample_global"]
    for i in range(nd):
        h = F.relu(inorm(conv(h, p, f"global.down.{i}.conv", prec, stride=2,
                              pad=1)))
    for i in range(cfg["n_blocks_global"]):
        h = _resnet(p, f"global.res.{i}.", h, prec, "trunk")
    for i in range(nd):
        h = F.relu(inorm(conv_t(h, p, f"global.up.{i}.convt", prec)))
    return h


def enhance(cfg: dict, p: Params, h: torch.Tensor,
            pyr: List[torch.Tensor], prec: Precision = FP32) -> torch.Tensor:
    """The fine stream on the pyramid's finer levels, from the global G's
    output ``h``: each enhancer, then the head and tanh."""
    ne = cfg["n_local_enhancers"]
    for n in range(1, ne + 1):
        e = f"enh{n}_"
        d = F.relu(inorm(conv(pyr[ne - n], p, e + "stem.conv", prec, pad=3,
                              reflect=True)))
        d = F.relu(inorm(conv(d, p, e + "down.conv", prec, stride=2,
                              pad=1)))
        h = d + h
        for i in range(cfg["n_blocks_local"]):
            h = _resnet(p, f"{e}res_{i}.", h, prec, "rest")
        h = F.relu(inorm(conv_t(h, p, e + "up.convt", prec)))
    return torch.tanh(conv(h, p, "head.conv", prec, pad=3, reflect=True))


def generator(cfg: dict, p: Params, x: torch.Tensor,
              prec: Precision = FP32) -> torch.Tensor:
    """G on NCHW ``x``: NCHW out in [-1, 1]."""
    pyr = pyramid(cfg, x)
    return enhance(cfg, p, global_without_head(cfg, p, pyr[-1], prec), pyr,
                   prec)


def generate_nhwc(cfg: dict, p: Params, x: torch.Tensor,
                  prec: Precision = FP32, block: int = 1) -> torch.Tensor:
    """G on NHWC ``x`` in blocks of ``block`` images (one 1024² frame's
    fine stream holds 128 MB a tensor), without autograd: NHWC
    float32."""
    outs = []
    with torch.no_grad():
        for i in range(0, x.shape[0], block):
            xb = x[i:i + block].permute(0, 3, 1, 2).float().contiguous()
            outs.append(generator(cfg, p, xb, prec).permute(0, 2, 3, 1))
    return torch.cat(outs)
