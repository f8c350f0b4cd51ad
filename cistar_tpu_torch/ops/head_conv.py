"""The generator head with its input normalize fused in (counterpart of
``cistar_tpu/ops/head_conv.py::head_conv_tanh_shift_prenorm``).

relu(IN(x)) → 7×7 reflect conv to one channel → + b → tanh. The JAX
version's stride-8 shift-channel reformulation is a TPU lane workaround
(one output channel uses 1/128 of the MXU lanes) and is not carried over;
the values are the same: the normalize rounds to the activation dtype
before the ReLU, the taps are summed in fp32, and bias and tanh run in fp32
before the cast back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def head_conv_tanh_prenorm(x: torch.Tensor, mean: torch.Tensor,
                           rsigma: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC ``x`` (raw stage output), fp32 (N,1,1,C) ``mean`` / ``rsigma``
    from :func:`cistar_tpu_torch.ops.nn.instance_norm_stats`, OIHW ``w``
    with one output channel → NHWC (N,H,W,1) in ``x.dtype``."""
    dt = x.dtype
    xn = torch.relu(((x.float() - mean) * rsigma).to(dt))
    p = w.shape[-1] // 2
    xp = F.pad(xn.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    # Inputs rounded to dt, products and sums in fp32 (JAX:
    # preferred_element_type=f32). bf16 values are exact in TF32, so for a
    # bf16 x cuDNN's TF32 (PyTorch's default) gives the same products on
    # tensor cores; with TF32 off this conv is a plain fp32 one, several
    # times slower.
    y = F.conv2d(xp.float(), w.to(dt).float())
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return torch.tanh(y).permute(0, 2, 3, 1).to(dt)
