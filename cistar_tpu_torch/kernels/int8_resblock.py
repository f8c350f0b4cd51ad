"""Wrappers of the CUDA int8 residual-block kernels (``csrc/int8_resblock.cu``).

  * :func:`conv3x3_reflect_s8` — the int8 reflect-pad-1 3×3 conv, int32
    accumulators out (the conv of ``quant_pallas.py::_conv9_int8``)
  * :func:`resblock_int8_bf16io` — K1 (``_resblock_int8_bf16io_kernel``),
    with ``bn=True`` its BatchNorm form (counted as
    ``resblock_int8_bf16io_bn``)
  * :func:`resblock_int8` — K2 (``_resblock_int8_kernel``)
  * :func:`conv_variant` — which conv a shape takes (``wgmma_conv.py``'s
    rule), and :func:`conv_variant_card`, the library's own answer

Each takes CUDA tensors only and launches on PyTorch's current stream; the
CPU path is the plain version in :mod:`cistar_tpu_torch.ops.quant_int8`.
The library is built on the first call (:mod:`.build`). ``launches`` counts
the calls that launched each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from cistar_tpu_torch.kernels import build, wgmma_conv
from cistar_tpu_torch.kernels.build import (I, F, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"conv3x3_reflect_s8": 0, "resblock_int8_bf16io": 0,
                            "resblock_int8_bf16io_bn": 0, "resblock_int8": 0}

_SIGS = {
    "cistar_resblock_workspace_bytes": ((I, I, I, I), ctypes.c_size_t),
    "cistar_resblock_conv_variant": ((I, I, I, I), I),
    "cistar_conv3x3_reflect_s8_acc": ((P, P, P, P, I, I, I, I, P), I),
    "cistar_resblock_int8_bf16io": (
        (P, I, P, P, P, P, P, I, I, I, I, F, I, P), I),
    "cistar_resblock_int8": (
        (P, P, P, P, P, P, P, P, I, I, I, I, F, P), I),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("int8_resblock"), _SIGS)


def conv_variant(n: int, h: int, w: int, c: int) -> int:
    """The conv K1, K2 and :func:`conv3x3_reflect_s8` run at (N, H, W, C):
    the BN of the ``wgmma`` conv, or 0 for the ``mma.sync`` one
    (``conv_s8_kernel``)."""
    return wgmma_conv.variant(n, h, w, c, c, 1)


def conv_variant_card(n: int, h: int, w: int, c: int) -> int:
    """:func:`conv_variant` as the built library answers it."""
    return _lib().cistar_resblock_conv_variant(n, h, w, c)


def _check_shape(x: torch.Tensor) -> Tuple[int, int, int, int]:
    n, h, w, c = x.shape
    if c % 128 or (h * w) % 128 or h < 2 or w < 2:
        raise ValueError(
            f"int8 res-block kernels take C % 128 == 0 and H*W % 128 == 0, "
            f"got (N,H,W,C) = {tuple(x.shape)}")
    return n, h, w, c


def _weights(qblk, c: int, device) -> Tuple[torch.Tensor, ...]:
    w1k, w2k, sb = qblk["w1k"], qblk["w2k"], qblk["sb"]
    for t, name in ((w1k, "w1k"), (w2k, "w2k")):
        check_tensor(t, name, torch.int8, (c, 9 * c))
    check_tensor(sb, "sb", torch.float32, (4, c))
    check_same_device(device, w1k, w2k, sb)
    return w1k, w2k, sb


def _workspace(lib, n: int, h: int, w: int, c: int, device) -> torch.Tensor:
    return build.workspace(lib.cistar_resblock_workspace_bytes(n, h, w, c),
                           device)


def conv3x3_reflect_s8(xq: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """int8 (N,H,W,C) ``xq`` and (C, 9·C) ``wk`` → int32 (N,H,W,C)."""
    check_tensor(xq, "xq", torch.int8)
    n, h, w, c = _check_shape(xq)
    check_tensor(wk, "wk", torch.int8, (c, 9 * c))
    lib = _lib()
    acc = torch.empty((n, h, w, c), dtype=torch.int32, device=xq.device)
    xpad = torch.empty((n, h + 2, w + 2, c), dtype=torch.int8,
                       device=xq.device)
    err = lib.cistar_conv3x3_reflect_s8_acc(
        xq.data_ptr(), wk.data_ptr(), acc.data_ptr(), xpad.data_ptr(),
        n, h, w, c, stream())
    raise_on(err, "conv3x3_reflect_s8")
    launches["conv3x3_reflect_s8"] += 1
    return acc


def resblock_int8_bf16io(hx: torch.Tensor, qblk, eps: float,
                         bn: bool = False) -> torch.Tensor:
    """K1: bf16 or fp32 (N,H,W,C) carrier in, same dtype out. ``bn``: the
    BatchNorm form, its affine folded into ``sb`` (no IN)."""
    if hx.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or fp32 carrier, got {hx.dtype}")
    check_tensor(hx, "hx", hx.dtype)
    n, h, w, c = _check_shape(hx)
    w1k, w2k, sb = _weights(qblk, c, hx.device)
    lib = _lib()
    out = torch.empty_like(hx)
    ws = _workspace(lib, n, h, w, c, hx.device)
    err = lib.cistar_resblock_int8_bf16io(
        hx.data_ptr(), int(hx.dtype == torch.bfloat16), w1k.data_ptr(),
        w2k.data_ptr(), sb.data_ptr(), out.data_ptr(), ws.data_ptr(),
        n, h, w, c, eps, int(bn), stream())
    name = "resblock_int8_bf16io_bn" if bn else "resblock_int8_bf16io"
    raise_on(err, name)
    launches[name] += 1
    return out


def resblock_int8(hq: torch.Tensor, hs: torch.Tensor, qblk,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: int8 (N,H,W,C) + (N,1) fp32 scale in, the same pair out."""
    check_tensor(hq, "hq", torch.int8)
    n, h, w, c = _check_shape(hq)
    check_tensor(hs, "hs", torch.float32, (n, 1))
    w1k, w2k, sb = _weights(qblk, c, hq.device)
    lib = _lib()
    outq = torch.empty_like(hq)
    outs = torch.empty((n, 1), dtype=torch.float32, device=hq.device)
    ws = _workspace(lib, n, h, w, c, hq.device)
    err = lib.cistar_resblock_int8(
        hq.data_ptr(), hs.data_ptr(), w1k.data_ptr(), w2k.data_ptr(),
        sb.data_ptr(), outq.data_ptr(), outs.data_ptr(), ws.data_ptr(),
        n, h, w, c, eps, stream())
    raise_on(err, "resblock_int8")
    launches["resblock_int8"] += 1
    return outq, outs
