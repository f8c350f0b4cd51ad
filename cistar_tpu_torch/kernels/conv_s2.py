"""Wrapper of K10, the UNet's 7×7 stride-2 zero-pad-3 conv in bf16
(``csrc/conv_s2.cu``), and its shape rule:

  * :func:`conv7x7s2_bf16` — the kernel: bf16 (N,H,W,Cin) ``x``, bf16
    (Cout, 49·Cin) ``wk`` (k = tap·Cin + cin, tap = 7·dy + dx), optional
    fp32 (Cout,) ``bias`` → bf16 (N,H/2,W/2,Cout), the plain op's roundings
    (``ops/nn.py::conv2d`` with stride 2, pad 3: the sum to bf16, then +
    the bias in bf16);
  * :func:`shape_ok` — which shapes it takes (the library's
    ``s2_shape_ok``);
  * :func:`variant_card` — the BN the library runs a shape at, 0 where it
    does not take it.

It takes CUDA tensors only and launches on PyTorch's current stream; the
CPU path of the ``cistar::conv7x7s2_bf16`` op is the plain version
(:mod:`.custom_ops`). ``launches`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from cistar_tpu_torch.kernels import build, wgmma_conv
from cistar_tpu_torch.kernels.build import (I, P, check_same_device,
                                            check_tensor, raise_on, stream)

KK, STRIDE, PAD = 7, 2, 3
KE = wgmma_conv.KBYTES // 2   # bf16 channels a K stage: Cin is a multiple
BM = wgmma_conv.BM            # output pixels a tile

launches: Dict[str, int] = {"conv7x7s2_bf16": 0}

_SIGS = {
    "cistar_conv7x7s2_bf16_variant": ((I, I, I, I, I), I),
    "cistar_conv7x7s2_bf16": ((P, P, P, P, I, I, I, I, I, P), I),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib():
    return build.bind(build.load("conv_s2"), _SIGS)


def shape_ok(n: int, h: int, w: int, cin: int, cout: int) -> bool:
    """``s2_shape_ok``: H and W even, Cin a multiple of 64 (a K stage lies
    in one tap), Cout a multiple of 128, and the ``wgmma`` conv's tile rule
    on the (H/2, W/2) output: a tile is whole output rows (W/2 divides 128)
    or 128 pixels of one (128 divides W/2), in one image."""
    if n <= 0 or h < 2 or w < 2 or h % 2 or w % 2 or cin <= 0 or cin % KE \
            or cout <= 0 or cout % 128:
        return False
    ho, wo = h // 2, w // 2
    rows = (wo <= BM and BM % wo == 0) or wo % BM == 0
    return rows and (ho * wo) % BM == 0


def variant_card(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """``s2_variant``: the BN K10 runs at this shape, or 0 where
    ``s2_shape_ok`` does not hold: 256 where Cout allows it and BN 128 would
    take more waves of 132 blocks, else 128."""
    return _lib().cistar_conv7x7s2_bf16_variant(n, h, w, cin, cout)


def conv7x7s2_bf16(x: torch.Tensor, wk: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K10: bf16 (N,H,W,Cin) ``x``, bf16 (Cout, 49·Cin) ``wk``, fp32
    (Cout,) ``bias`` or None → bf16 (N,H/2,W/2,Cout) conv + bias, zero pad
    3, stride 2; raises on anything else."""
    check_tensor(x, "x", torch.bfloat16)
    n, h, w, cin = x.shape
    cout = wk.shape[0]
    check_tensor(wk, "wk", torch.bfloat16, (cout, KK * KK * cin))
    if bias is not None:
        check_tensor(bias, "bias", torch.float32, (cout,))
        check_same_device(x.device, bias)
    check_same_device(x.device, wk)
    if not shape_ok(n, h, w, cin, cout):
        raise ValueError(f"K10 does not take (N,H,W,Cin) = {tuple(x.shape)}, "
                         f"Cout {cout}")
    lib = _lib()
    out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.bfloat16,
                      device=x.device)
    err = lib.cistar_conv7x7s2_bf16(
        x.data_ptr(), wk.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, stream())
    raise_on(err, "conv7x7s2_bf16")
    launches["conv7x7s2_bf16"] += 1
    return out
