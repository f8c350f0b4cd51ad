"""Wrappers of the CUDA int8 atrous kernels (``csrc/int8_atrous.cu``).

  * :func:`conv3x3_dilated_s8` — the int8 zero-pad 3×3 conv at a dilation,
    int32 accumulators out (the branch conv of the atrous kernels)
  * :func:`atrous_resblock_int8` — K5 (``_atrous_resblock_int8_kernel``)
  * :func:`multi_atrous_stage_int8` — K6
    (``_multi_atrous_stage_int8_kernel``)

Each takes CUDA tensors only and launches on PyTorch's current stream; the
CPU path is the plain version in :mod:`cistar_tpu_torch.ops.quant_int8`.
The library is built on the first call (:mod:`.build`). ``launches`` counts
the calls that launched each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from cistar_tpu_torch.kernels import build
from cistar_tpu_torch.kernels.build import (I, F, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"conv3x3_dilated_s8": 0,
                            "atrous_resblock_int8": 0,
                            "multi_atrous_stage_int8": 0}

_SIGS = {
    "cistar_atrous_workspace_bytes": ((I, I, I, I, I), ctypes.c_size_t),
    "cistar_conv3x3_zero_s8_acc": ((P, P, P, I, I, I, I, I, I, P), I),
    "cistar_atrous_resblock_int8": (
        (P, I, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P), I),
    "cistar_multi_atrous_stage_int8": (
        (P, I, I, I, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P), I),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("int8_atrous"), _SIGS)


def _check_shape(n: int, h: int, w: int, cin: int, cout: int) -> None:
    if cin % 32 or cout % 64 or (h * w) % 128 or h < 2 or w < 2:
        raise ValueError(
            "int8 atrous kernels take Cin % 32 == 0, Cout % 64 == 0 and "
            f"H*W % 128 == 0 at the output, got (N,H,W) = {(n, h, w)}, "
            f"Cin {cin}, Cout {cout}")


def _check_rates(rates: Sequence[int]) -> Tuple[int, int, int, int]:
    if len(rates) != 4 or any(int(r) < 1 for r in rates):
        raise ValueError(f"four dilations >= 1 expected, got {rates}")
    return tuple(int(r) for r in rates)


def _check_carrier(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes a bf16 or fp32 input, got {x.dtype}")
    check_tensor(x, "x", x.dtype)


def _workspace(lib, n: int, h: int, w: int, cin: int, cout: int, device
               ) -> torch.Tensor:
    return build.workspace(
        lib.cistar_atrous_workspace_bytes(n, h, w, cin, cout), device)


def conv3x3_dilated_s8(xq: torch.Tensor, wk: torch.Tensor, rate: int
                       ) -> torch.Tensor:
    """int8 (N,H,W,Cin) ``xq`` and (Cout, 9·Cin) ``wk`` → int32
    (N,H,W,Cout): zero padding ``rate``, dilation ``rate``."""
    check_tensor(xq, "xq", torch.int8)
    n, h, w, cin = xq.shape
    cout = wk.shape[0]
    _check_shape(n, h, w, cin, cout)
    check_tensor(wk, "wk", torch.int8, (cout, 9 * cin))
    if rate < 1:
        raise ValueError(f"dilation must be >= 1, got {rate}")
    lib = _lib()
    acc = torch.empty((n, h, w, cout), dtype=torch.int32, device=xq.device)
    err = lib.cistar_conv3x3_zero_s8_acc(
        xq.data_ptr(), wk.data_ptr(), acc.data_ptr(), n, h, w, cin, cout,
        int(rate), stream())
    raise_on(err, "conv3x3_dilated_s8")
    launches["conv3x3_dilated_s8"] += 1
    return acc


def atrous_resblock_int8(hx: torch.Tensor, qblk, rates: Sequence[int],
                         eps: float) -> torch.Tensor:
    """K5: bf16 or fp32 (N,H,W,C) carrier in, same dtype out."""
    _check_carrier(hx, "K5")
    n, h, w, c = hx.shape
    _check_shape(n, h, w, c, c)
    r = _check_rates(rates)
    wbk, wck, sb = qblk["wbk"], qblk["wck"], qblk["sb"]
    check_tensor(wbk, "wbk", torch.int8, (4, c, 9 * c))
    check_tensor(wck, "wck", torch.int8, (c, 9 * c))
    check_tensor(sb, "sb", torch.float32, (10, c))
    check_same_device(hx.device, wbk, wck, sb)
    lib = _lib()
    out = torch.empty_like(hx)
    ws = _workspace(lib, n, h, w, c, c, hx.device)
    err = lib.cistar_atrous_resblock_int8(
        hx.data_ptr(), int(hx.dtype == torch.bfloat16), wbk.data_ptr(),
        wck.data_ptr(), sb.data_ptr(), out.data_ptr(), ws.data_ptr(),
        n, h, w, c, *r, eps, stream())
    raise_on(err, "atrous_resblock_int8")
    launches["atrous_resblock_int8"] += 1
    return out


def multi_atrous_stage_int8(x: torch.Tensor, qstage, rates2: Sequence[int],
                            eps: float) -> torch.Tensor:
    """K6: the full-resolution bf16 or fp32 (N,H,W,Cin) stage input, read at
    ``x[:, ::2, ::2]``, → (N, ⌈H/2⌉, ⌈W/2⌉, Cout) in ``x.dtype``.
    ``rates2`` are the dilations on the subsampled image."""
    _check_carrier(x, "K6")
    n, hin, win, cin = x.shape
    h, w = (hin + 1) // 2, (win + 1) // 2
    wbk, sb = qstage["wbk"], qstage["sb"]
    cout = wbk.shape[1]
    _check_shape(n, h, w, cin, cout)
    r = _check_rates(rates2)
    check_tensor(wbk, "wbk", torch.int8, (4, cout, 9 * cin))
    check_tensor(sb, "sb", torch.float32, (8, cout))
    check_same_device(x.device, wbk, sb)
    lib = _lib()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ws = _workspace(lib, n, h, w, cin, cout, x.device)
    err = lib.cistar_multi_atrous_stage_int8(
        x.data_ptr(), int(x.dtype == torch.bfloat16), hin, win,
        wbk.data_ptr(), sb.data_ptr(), out.data_ptr(), ws.data_ptr(),
        n, h, w, cin, cout, *r, eps, stream())
    raise_on(err, "multi_atrous_stage_int8")
    launches["multi_atrous_stage_int8"] += 1
    return out
