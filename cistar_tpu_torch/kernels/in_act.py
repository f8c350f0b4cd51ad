"""Wrapper of the CUDA instance-norm + activation kernel (``csrc/in_act.cu``):

  * :func:`in_act` — K4 (``pallas_kernels.py::_in_act_kernel`` /
    ``_in_act_res_kernel``)

It takes CUDA tensors only and launches on PyTorch's current stream; the
CPU path is the plain version in :mod:`cistar_tpu_torch.ops.fused`. The
library is built on the first call (:mod:`.build`). ``launches`` counts the
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from cistar_tpu_torch.kernels import build
from cistar_tpu_torch.kernels.build import I, F, P, check_tensor, raise_on, stream

launches: Dict[str, int] = {"in_act": 0}

_SIGS = {"cistar_in_act": ((P, I, P, P, I, I, I, I, F, F, P), I)}
_ACT_CODES = {"none": 0, "relu": 1, "leaky": 2, "tanh": 3}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("in_act"), _SIGS)


def in_act(x: torch.Tensor, act: str, slope: float,
           residual: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """K4: bf16 or fp32 (N,H,W,C) ``x`` (C % 8 == 0), optional
    ``residual`` of the same shape and dtype → IN + act (+ residual) in
    ``x.dtype``. With a residual, ``"tanh"`` applies no activation, as the
    TPU kernel does."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 takes bf16 or fp32, got {x.dtype}")
    check_tensor(x, "x", x.dtype)
    n, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"K4 takes C % 8 == 0, got {tuple(x.shape)}")
    if residual is not None:
        check_tensor(residual, "residual", x.dtype, x.shape)
    lib = _lib()
    out = torch.empty_like(x)
    err = lib.cistar_in_act(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        0 if residual is None else residual.data_ptr(), out.data_ptr(),
        n, h * w, c, _ACT_CODES[act], slope, eps, stream())
    raise_on(err, "in_act")
    launches["in_act"] += 1
    return out
