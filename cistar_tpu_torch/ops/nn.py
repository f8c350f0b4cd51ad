"""NHWC primitives with PyTorch weight layouts (counterpart of
``cistar_tpu/ops/nn.py``).

Activations are NHWC at every public function, as in the JAX package.
Inside, each op permutes to an NCHW *view* for ``F.conv2d``; an NHWC-
contiguous tensor viewed that way is ``channels_last`` in memory, so no
copy is made. Weights keep PyTorch's layouts: conv OIHW, transpose conv
``(in, out, kh, kw)``. Compute dtype follows the input, as in JAX: bf16 in,
bf16 out; instance-norm statistics are always fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _add_bias(out: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    # The bias is added after the conv in the activation dtype, as the JAX
    # ops do (bf16 convs round once for the conv and once for the bias).
    return out if b is None else out + b.to(out.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2-D convolution: NHWC ``x``, OIHW ``w`` (``ops/nn.py::conv2d``)."""
    out = F.conv2d(_nchw(x), w.to(x.dtype), None, stride=stride,
                   padding=padding)
    return _add_bias(_nhwc(out), b)


def conv2d_reflect(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 "same" conv with reflection padding (``conv2d_reflect``).

    Reflect-pad then conv: the JAX version's border-strip assembly only
    avoids a padded copy in XLA and computes the same values."""
    p = (w.shape[-1] - 1) // 2
    xp = F.pad(_nchw(x), (p, p, p, p), mode="reflect")
    out = F.conv2d(xp, w.to(x.dtype), None)
    return _add_bias(_nhwc(out), b)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0
                     ) -> torch.Tensor:
    """Transposed conv, ``w`` in PyTorch's ``(in, out, kh, kw)`` layout."""
    out = F.conv_transpose2d(_nchw(x), w.to(x.dtype), None, stride=stride,
                             padding=padding, output_padding=output_padding)
    return _add_bias(_nhwc(out), b)


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(mean, rsigma)`` of shape (N,1,1,C): single-pass moments
    E[x²]−E[x]², clamped at 0 (``ops/nn.py::instance_norm_stats``)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    mean_sq = (xf * xf).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free instance norm over H, W; statistics in fp32, result cast
    back to the input dtype (``ops/nn.py::instance_norm``)."""
    mean, rsigma = instance_norm_stats(x, eps)
    return ((x.float() - mean) * rsigma).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)
