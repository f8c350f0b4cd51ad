"""The generator head, 7×7 reflect conv to one channel + tanh (counterpart
of ``cistar_tpu/ops/head_conv.py``).

  * :func:`head_conv_tanh_prenorm` (``head_conv_tanh_shift_prenorm``, the
    engines' default head): relu(IN(x)) → conv → + b → tanh, the IN+ReLU of
    the last stage inside it.
  * :func:`head_conv_tanh_shift` (``head_conv_tanh_shift``): the same conv
    on an input already normalized.
  * :func:`head_conv_tanh_pallas` (``head_conv_tanh_pallas``, the TPU kernel
    ``_head_kernel``): K9, optionally with the IN+ReLU of its input
    (``pre_in``).

The JAX versions' stride-8 shift-channel and tap-matrix reformulations are
TPU lane workarounds (one output channel uses 1/128 of the MXU lanes) and
are not carried over; the values are the same: the normalize rounds to the
activation dtype before the ReLU, the taps are summed in fp32, and bias and
tanh run in fp32 before the cast back. The first two are plain PyTorch on
every device; the third is K9 (:mod:`cistar_tpu_torch.ops.fused`).
"""

from __future__ import annotations

from typing import Optional

import torch

from cistar_tpu_torch.ops.fused import EPS, _cout1, reflect_conv_fp32


def head_conv_tanh_prenorm(x: torch.Tensor, mean: torch.Tensor,
                           rsigma: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC ``x`` (raw stage output), fp32 (N,1,1,C) ``mean`` / ``rsigma``
    from :func:`cistar_tpu_torch.ops.nn.instance_norm_stats`, OIHW ``w``
    with one output channel → NHWC (N,H,W,1) in ``x.dtype``."""
    xn = torch.relu(((x.float() - mean) * rsigma).to(x.dtype))
    return reflect_conv_fp32(xn, w, b, "tanh")


def head_conv_tanh_shift(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None,
                         act: str = "tanh") -> torch.Tensor:
    """The head conv of an already normalized NHWC ``x`` → (N,H,W,1)."""
    return reflect_conv_fp32(x, w, b, act)


def head_conv_tanh_pallas(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          act: str = "tanh", pre_in: bool = False,
                          eps: float = EPS) -> torch.Tensor:
    """K9d: the head conv, with ``pre_in`` the single-pass IN + ReLU of
    ``x`` first. A CUDA tensor launches the K9 kernel (or raises), a CPU
    tensor takes its plain version."""
    return _cout1(x, w, b, act, pre_in, eps)
