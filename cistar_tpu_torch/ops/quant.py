"""Int8 inference with plain integer arithmetic (counterpart of
``cistar_tpu/ops/quant.py``), beside the kernel path of ``ops/quant_int8.py``.

The JAX module computes its convs with XLA on int8 operands and int32
accumulation, outside any Pallas kernel; this one computes the same
integers:

  * weights: static per-output-channel symmetric int8
    (:func:`quantize_weight_int8`, once, :func:`quantize_conv_tree`);
  * activations: dynamic per-tensor symmetric int8;
  * convs: an im2col of the int8 activations times the int8 weights, an
    int32-exact product — ``torch._int_mm`` on the card (K and N
    zero-padded to multiples of 8, M to at least 32, as cuBLASLt's int8
    GEMM takes them), an int32 matmul on the CPU — dequantized into fp32
    (``acc · (x_scale · w_scale) + b``, JAX's order).

:func:`resnet_generator_int8_apply` runs the CycleGAN ``ResnetGenerator``
(``models/cyclegan.py``) from its quantized convs. Weights keep PyTorch's
layouts: a conv's OIHW, a transpose conv's ``(in, out, kh, kw)``, each
quantized per output channel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, ReflectConv2d

QConv = Dict[str, torch.Tensor]


def quantize_weight_int8(w: torch.Tensor, out_axis: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a conv weight whose output
    channels are on ``out_axis`` (0: OIHW; 1: a transpose conv's ``(in,
    out, kh, kw)``): ``(wq, scale)``, ``scale`` (O,) = max(|w|, 1e-8) /
    127 over the other axes, ``wq = clip(round(w / scale), ±127)``."""
    w = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != out_axis)
    absmax = torch.amax(w.abs(), dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def quantize_conv_tree(model: nn.Module) -> Dict[str, QConv]:
    """Every conv of ``model`` quantized, by module path: ``{"wq",
    "scale"}``, and the fp32 bias ``"b"`` where the conv has one; biases
    stay fp32."""
    out: Dict[str, QConv] = {}
    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, ReflectConv2d, ConvTranspose2d)):
            wq, scale = quantize_weight_int8(
                m.weight, 1 if isinstance(m, ConvTranspose2d) else 0)
            q = {"wq": wq, "scale": scale}
            if m.bias is not None:
                q["b"] = m.bias.detach().float()
            out[name] = q
    return out


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: ``(xq, scale)``."""
    absmax = torch.amax(x.abs())
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return xq, scale


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32, exact."""
    if a.device.type != "cuda":
        return torch.mm(a.int(), b.int())
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_up(m, 8), 32), _up(k, 8), _up(n, 8)
    a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = F.pad(b.t(), (0, kp - k, 0, np_ - n)).contiguous()   # (N, K)
    return torch._int_mm(a, bt.t())[:m, :n]


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1
             ) -> torch.Tensor:
    """The int32 accumulators of a VALID conv of NHWC int8 ``xq`` (padded
    already) with OIHW int8 ``wq``: the im2col (taps row-major, then
    channels) times the (kh·kw·C, O) weights."""
    n, h, w, c = xq.shape
    o, _, kh, kw = wq.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    cols = torch.cat([xq[:, dy:dy + (ho - 1) * stride + 1:stride,
                         dx:dx + (wo - 1) * stride + 1:stride]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    wk = wq.permute(2, 3, 1, 0).reshape(kh * kw * c, o)
    acc = int_matmul(cols.reshape(n * ho * wo, kh * kw * c), wk)
    return acc.reshape(n, ho, wo, o)


def _dequant(acc: torch.Tensor, x_scale: torch.Tensor, q: QConv
             ) -> torch.Tensor:
    out = acc.float() * (x_scale * q["scale"])
    return out + q["b"] if "b" in q else out


def _reflect_pad(xq: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect padding of H and W by index (any dtype)."""
    def idx(n):
        i = torch.arange(-p, n + p, device=xq.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)
    return xq[:, idx(xq.shape[1])][:, :, idx(xq.shape[2])]


def int8_conv2d(x: torch.Tensor, q: QConv, stride: int = 1) -> torch.Tensor:
    """Dynamic-activation int8 conv, zero "same" padding, fp32 out."""
    xq, x_scale = quantize_act(x.float())
    p = (q["wq"].shape[-1] - 1) // 2
    acc = conv_acc(F.pad(xq, (0, 0, p, p, p, p)), q["wq"], stride)
    return _dequant(acc, x_scale, q)


def int8_conv_transpose2d(x: torch.Tensor, q: QConv) -> torch.Tensor:
    """The k3 / s2 / p1 / op1 transpose conv on int8 operands: the input
    dilated by 2, padded (1, 2), convolved with the flipped kernel."""
    xq, x_scale = quantize_act(x.float())
    n, h, w, c = xq.shape
    xd = xq.new_zeros((n, 2 * h - 1, 2 * w - 1, c))
    xd[:, ::2, ::2] = xq
    wf = torch.flip(q["wq"], (2, 3)).transpose(0, 1)   # → (out, in, kh, kw)
    acc = conv_acc(F.pad(xd, (0, 0, 1, 2, 1, 2)), wf)
    return _dequant(acc, x_scale, q)


def int8_conv2d_reflect(x: torch.Tensor, q: QConv) -> torch.Tensor:
    """Reflect-padded stride-1 conv: quantize once, reflect the int8
    values (the reflection of quantized values is the quantization of
    reflected ones)."""
    xq, x_scale = quantize_act(x.float())
    p = (q["wq"].shape[-1] - 1) // 2
    acc = conv_acc(_reflect_pad(xq, p), q["wq"])
    return _dequant(acc, x_scale, q)


def resnet_generator_int8_apply(q: Dict[str, QConv], x: torch.Tensor,
                                n_residual_blocks: int = 9) -> torch.Tensor:
    """The int8 forward of ``models/cyclegan.py::ResnetGenerator`` from
    :func:`quantize_conv_tree` of it; fp32 out."""
    h = tnn.relu(tnn.instance_norm(int8_conv2d_reflect(x, q["init_conv"])))
    for i in range(3):
        h = tnn.relu(tnn.instance_norm(int8_conv2d(h, q[f"down.{i}"],
                                                   stride=2)))
    for i in range(n_residual_blocks):
        r = tnn.relu(tnn.instance_norm(int8_conv2d_reflect(
            h, q[f"res.{i}.conv1"])))
        h = h + tnn.instance_norm(int8_conv2d_reflect(r, q[f"res.{i}.conv2"]))
    for i in range(3):
        h = tnn.relu(tnn.instance_norm(int8_conv_transpose2d(h,
                                                             q[f"up.{i}"])))
    return tnn.tanh(int8_conv2d_reflect(h, q["out_conv"]))
