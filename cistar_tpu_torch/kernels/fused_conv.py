"""Wrapper of the CUDA fused conv + instance-norm kernel
(``csrc/conv3x3_in_act.cu``):

  * :func:`conv3x3_in_act` — K3 (the TPU kernel of
    ``pallas_kernels.py::fused_conv3x3_in_act``)

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

launches: Dict[str, int] = {"conv3x3_in_act": 0}

_SIGS = {
    "cistar_conv3x3_in_act_workspace_bytes": ((I, I, I, I), ctypes.c_size_t),
    "cistar_conv3x3_in_act": (
        (P, I, P, I, P, P, P, P, I, I, I, I, I, I, I, F, P), I),
}
_FLOAT = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("conv3x3_in_act"), _SIGS)


def conv3x3_in_act(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                   relu: bool, residual: Optional[torch.Tensor],
                   reflect: bool, eps: float) -> torch.Tensor:
    """K3: bf16 or fp32 (N,H,W,Cin) ``x``; (Cout, 9·Cin) ``wk`` in bf16 or
    fp32, K-contiguous with k = tap·Cin + cin; fp32 (Cout,) ``bias``;
    optional ``residual`` (N,H,W,Cout) in ``x.dtype`` → (N,H,W,Cout) in
    ``x.dtype``. Cout % 8 == 0. bf16 ``x`` and ``wk`` with Cin % 32 == 0,
    Cout % 64 == 0 and H·W % 128 == 0 take the tensor cores; anything else
    the FFMA loop."""
    if x.dtype not in _FLOAT or wk.dtype not in _FLOAT:
        raise TypeError(f"K3 takes bf16 or fp32, got x {x.dtype}, "
                        f"w {wk.dtype}")
    check_tensor(x, "x", x.dtype)
    n, h, w, cin = x.shape
    cout = wk.shape[0]
    if cout % 8:
        raise ValueError(f"K3 takes Cout % 8 == 0, got {cout}")
    check_tensor(wk, "wk", wk.dtype, (cout, 9 * cin))
    check_tensor(bias, "bias", torch.float32, (cout,))
    check_same_device(x.device, wk, bias)
    if residual is not None:
        check_tensor(residual, "residual", x.dtype, (n, h, w, cout))
    lib = _lib()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ws = build.workspace(
        lib.cistar_conv3x3_in_act_workspace_bytes(n, h, w, cout), x.device)
    err = lib.cistar_conv3x3_in_act(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wk.data_ptr(),
        int(wk.dtype == torch.bfloat16), bias.data_ptr(),
        0 if residual is None else residual.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n, h, w, cin, cout, int(reflect), int(relu), eps,
        stream())
    raise_on(err, "conv3x3_in_act")
    launches["conv3x3_in_act"] += 1
    return out
