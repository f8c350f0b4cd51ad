"""Wrapper of the CUDA cout=1 7×7 reflect head-conv kernel
(``csrc/head_cout1.cu``):

  * :func:`head_cout1` — K9, one kernel for the four TPU kernels of the
    same function (``pallas_kernels.py::conv2d_reflect_cout1``,
    ``_masked``, ``_loop`` and ``head_conv.py::head_conv_tanh_pallas``)
  * :func:`tiles`, :func:`blocks` and :data:`SMEM_BYTES` — the launch of
    its bf16 kernel (the tensor-core tap matmul; fp32 takes the FMA
    kernel), mirrored; :func:`smem_bytes_card` is the library's own
    shared-memory size

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
from cistar_tpu_torch.kernels.build import (I, F, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"head_cout1": 0}

_SIGS = {
    "cistar_head_cout1_workspace_bytes": ((I, I), ctypes.c_size_t),
    "cistar_head_cout1": ((P, I, P, P, P, P, I, I, I, I, I, I, F, P), I),
    "cistar_head_cout1_smem_bytes": ((), I),
}

TILE_H, TILE_W = 16, 26     # output tile of the tensor-core kernel
SPAN_H, SPAN_W = TILE_H + 6, TILE_W + 6   # its staged halo: 22 x 32
CHUNK = 64                  # channels a staged chunk
ROWS = TILE_H * SPAN_W      # plane rows (y < 16, x < 32): 32 m-tiles of 16
PLANE_STRIDE = ROWS + 4     # floats between two dx planes
BLOCKS_PER_SM = 2
# the halo of 128-byte pixels and the 7 fp32 dx planes
SMEM_BYTES = SPAN_H * SPAN_W * CHUNK * 2 + 7 * PLANE_STRIDE * 4


def tiles(n: int, h: int, w: int) -> int:
    """The (image, 16 × 26 output tile) pairs of one launch."""
    return n * -(-h // TILE_H) * -(-w // TILE_W)


def blocks(n: int, h: int, w: int, sms: int = 132) -> int:
    """Persistent blocks of the tensor-core kernel: two an SM."""
    return min(tiles(n, h, w), BLOCKS_PER_SM * sms)


def smem_bytes_card() -> int:
    """:data:`SMEM_BYTES` as the built library answers it."""
    return _lib().cistar_head_cout1_smem_bytes()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("head_cout1"), _SIGS)


def head_cout1(x: torch.Tensor, wt: torch.Tensor,
               bias: Optional[torch.Tensor], tanh: bool, pre_in: bool,
               eps: float) -> torch.Tensor:
    """K9: bf16 or fp32 (N,H,W,Cin) ``x`` (Cin % 8 == 0, Cin ≤ 2048,
    H, W > 3), fp32 (49, Cin) ``wt`` (the taps, tap = 7·dy + dx, already
    rounded to ``x.dtype``), optional fp32 (1,) ``bias`` → (N,H,W,1) in
    ``x.dtype``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K9 takes bf16 or fp32, got {x.dtype}")
    check_tensor(x, "x", x.dtype)
    n, h, w, cin = x.shape
    if cin % 8 or cin > 2048 or h <= 3 or w <= 3:
        raise ValueError(f"K9 takes Cin % 8 == 0, Cin <= 2048 and H, W > 3, "
                         f"got {tuple(x.shape)}")
    check_tensor(wt, "wt", torch.float32, (49, cin))
    check_same_device(x.device, wt)
    if bias is not None:
        check_tensor(bias, "bias", torch.float32, (1,))
        check_same_device(x.device, bias)
    lib = _lib()
    out = torch.empty((n, h, w, 1), dtype=x.dtype, device=x.device)
    ws = build.workspace(lib.cistar_head_cout1_workspace_bytes(n, cin),
                         x.device)
    err = lib.cistar_head_cout1(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wt.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n, h, w, cin, int(tanh), int(pre_in), eps, stream())
    raise_on(err, "head_cout1")
    launches["head_cout1"] += 1
    return out
