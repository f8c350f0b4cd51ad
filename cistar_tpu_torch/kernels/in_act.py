"""Wrapper of the CUDA instance-norm + activation kernel (``csrc/in_act.cu``):

  * :func:`in_act` — K4 (``pallas_kernels.py::_in_act_kernel`` /
    ``_in_act_res_kernel``)
  * :func:`variant` — which kernel a shape takes: the CTAs of the
    thread-block cluster that holds one (image, channel slice) on chip, or
    0 for the three-pass kernel (the Python mirror of
    ``cistar_in_act_variant``, which :func:`variant_card` asks);
    :func:`slice_channels`, :func:`share` and :func:`smem_bytes` mirror the
    launch's slice, the pixels of each rank and its shared memory

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

_SIGS = {"cistar_in_act": ((P, I, P, P, I, I, I, I, F, F, P), I),
         "cistar_in_act_variant": ((I, I, I), I)}
_ACT_CODES = {"none": 0, "relu": 1, "leaky": 2, "tanh": 3}

THREADS = 256               # threads of a CTA
MAX_CS = 64                 # channels of one slice
CL_MAX = 16                 # CTAs of a cluster (16 is non-portable)
SHARE_BYTES = 64 * 1024     # a CTA's share of the slice, clusters below 16
SHARE_BYTES_16 = 128 * 1024
STATIC_SMEM = (THREADS * 8 + 4 * MAX_CS) * 4  # the reduction and the sums


def slice_channels(c: int) -> int:
    """``slice_channels``: the widest of 64, 32, 16, 8 that divides C."""
    cs = MAX_CS
    while c % cs:
        cs //= 2
    return cs


def variant(h: int, w: int, c: int, elem: int) -> int:
    """``in_act_cluster_size``: the CTAs of the cluster (the least power
    of two, at most 16, that brings a share of one (image, slice) within
    64 KB, or within 128 KB at 16), or 0 where none does (the three-pass
    kernel). ``elem``: bytes of one value (2 bf16, 4 fp32)."""
    hw, row = h * w, slice_channels(c) * elem
    cl = 1
    while cl < CL_MAX:
        if -(-hw // cl) * row <= SHARE_BYTES:
            return cl
        cl *= 2
    return CL_MAX if -(-hw // CL_MAX) * row <= SHARE_BYTES_16 else 0


def share(hw: int, cl: int, rank: int) -> range:
    """The pixels of the CTA of ``rank`` in a cluster of ``cl``."""
    return range(rank * hw // cl, (rank + 1) * hw // cl)


def smem_bytes(h: int, w: int, c: int, elem: int) -> int:
    """Shared memory of one CTA of the cluster kernel (dynamic + static)."""
    cl = variant(h, w, c, elem)
    return -(-h * w // cl) * slice_channels(c) * elem + STATIC_SMEM


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("in_act"), _SIGS)


def variant_card(h: int, w: int, c: int, elem: int) -> int:
    """:func:`variant` as the built library answers it."""
    return _lib().cistar_in_act_variant(h * w, c, int(elem == 2))


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
