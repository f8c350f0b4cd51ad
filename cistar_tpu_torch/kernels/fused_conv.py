"""Wrapper of the CUDA fused conv + instance-norm kernel
(``csrc/conv3x3_in_act.cu``):

  * :func:`conv3x3_in_act` — K3 (the TPU kernel of
    ``pallas_kernels.py::fused_conv3x3_in_act``)
  * :func:`conv3x3_bf16_f32` — K3's tensor-core conv alone, conv + bias in
    fp32 (its plain version: ``ops/fused.py::conv3x3_bias_plain``)
  * :func:`conv_variant` — which conv K3 runs at a shape
    (``wgmma_conv.py``'s rule), and :func:`conv_variant_card`, the
    library's own answer

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

from cistar_tpu_torch.kernels import build, wgmma_conv
from cistar_tpu_torch.kernels.build import (I, F, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"conv3x3_in_act": 0, "conv3x3_bf16_f32": 0}

_SIGS = {
    "cistar_conv3x3_in_act_workspace_bytes": ((I, I, I, I, I, I, I, I),
                                              ctypes.c_size_t),
    "cistar_conv3x3_in_act_variant": ((I, I, I, I, I, I, I), I),
    "cistar_conv3x3_bf16_f32": ((P, P, P, P, P, I, I, I, I, I, I, P), I),
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


def conv_variant(n: int, h: int, w: int, cin: int, cout: int,
                 x_bf16: bool, w_bf16: bool) -> int:
    """The conv K3 runs: the BN of the ``wgmma`` conv for bf16 ``x`` and
    ``wk`` on a shape that meets its rule, else 0 (the FFMA loop)."""
    return wgmma_conv.variant(n, h, w, cin, cout, 2) \
        if x_bf16 and w_bf16 else 0


def conv_variant_card(n: int, h: int, w: int, cin: int, cout: int,
                      x_bf16: bool, w_bf16: bool) -> int:
    """:func:`conv_variant` as the built library answers it."""
    return _lib().cistar_conv3x3_in_act_variant(n, h, w, cin, cout,
                                                int(x_bf16), int(w_bf16))


def conv3x3_bf16_f32(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                     reflect: bool) -> torch.Tensor:
    """K3's conv alone: bf16 (N,H,W,Cin) ``x``, bf16 (Cout, 9·Cin) ``wk``,
    fp32 (Cout,) ``bias`` → fp32 (N,H,W,Cout) conv + bias, reflect or zero
    pad 1; shapes that meet the ``wgmma`` conv's rule only."""
    check_tensor(x, "x", torch.bfloat16)
    n, h, w, cin = x.shape
    cout = wk.shape[0]
    check_tensor(wk, "wk", torch.bfloat16, (cout, 9 * cin))
    check_tensor(bias, "bias", torch.float32, (cout,))
    check_same_device(x.device, wk, bias)
    if not conv_variant(n, h, w, cin, cout, True, True):
        raise ValueError(f"the wgmma conv does not take (N,H,W,Cin) = "
                         f"{tuple(x.shape)}, Cout {cout}")
    lib = _lib()
    f = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    xpad = torch.empty((n, h + 2, w + 2, cin), dtype=torch.bfloat16,
                       device=x.device) if reflect else None
    err = lib.cistar_conv3x3_bf16_f32(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), f.data_ptr(),
        0 if xpad is None else xpad.data_ptr(), n, h, w, cin, cout,
        int(reflect), stream())
    raise_on(err, "conv3x3_bf16_f32")
    launches["conv3x3_bf16_f32"] += 1
    return f


def conv3x3_in_act(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                   relu: bool, residual: Optional[torch.Tensor],
                   reflect: bool, eps: float) -> torch.Tensor:
    """K3: bf16 or fp32 (N,H,W,Cin) ``x``; (Cout, 9·Cin) ``wk`` in bf16 or
    fp32, K-contiguous with k = tap·Cin + cin; fp32 (Cout,) ``bias``;
    optional ``residual`` (N,H,W,Cout) in ``x.dtype`` → (N,H,W,Cout) in
    ``x.dtype``. Cout % 8 == 0. bf16 ``x`` and ``wk`` on a shape that meets
    the ``wgmma`` conv's rule (:func:`conv_variant`) take the tensor cores;
    anything else the FFMA loop."""
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
    x_bf16, w_bf16 = int(x.dtype == torch.bfloat16), \
        int(wk.dtype == torch.bfloat16)
    ws = build.workspace(lib.cistar_conv3x3_in_act_workspace_bytes(
        n, h, w, cin, cout, x_bf16, w_bf16, int(reflect)), x.device)
    err = lib.cistar_conv3x3_in_act(
        x.data_ptr(), x_bf16, wk.data_ptr(), w_bf16, bias.data_ptr(),
        0 if residual is None else residual.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n, h, w, cin, cout, int(reflect), int(relu), eps,
        stream())
    raise_on(err, "conv3x3_in_act")
    launches["conv3x3_in_act"] += 1
    return out
