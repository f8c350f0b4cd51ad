"""Fused instance-norm and conv blocks (counterpart of
``cistar_tpu/ops/pallas_kernels.py``).

Three kernels, each with its plain PyTorch version here:

  * K4 :func:`fused_instance_norm_act` (TPU kernels ``_in_act_kernel`` /
    ``_in_act_res_kernel``): affine-free IN with the two-pass centered
    variance, then none / relu / leaky / tanh; the residual form adds the
    residual after the norm, in fp32, and has no tanh.
  * K3 :func:`fused_conv3x3_in_act` (the TPU kernel inside it): 3×3 conv
    (reflect or zero pad 1) + bias into an fp32 accumulator, IN with the
    single-pass E[x²]−E[x]² clamped at 0, optional fp32 residual after the
    norm, optional ReLU, one cast to ``x.dtype``.
  * K9 :func:`conv2d_reflect_cout1`, :func:`conv2d_reflect_cout1_masked`,
    :func:`conv2d_reflect_cout1_loop` (and ``head_conv_tanh_pallas`` in
    :mod:`cistar_tpu_torch.ops.head_conv`): the 7×7 reflect conv to one
    channel, taps rounded to ``x.dtype`` and summed in fp32, + b, tanh or
    none in fp32. The four TPU kernels compute one function; one Hopper
    kernel serves them all.

Routing. The JAX package runs K3 and K4 only where its TPU kernel fits
VMEM (:func:`conv3x3_in_act_fits`, :func:`in_act_fits`), and the plain
composition everywhere else. The two round differently, so the port keeps
the TPU routing on every device: where the rule says kernel, the
``cistar`` custom op (:mod:`cistar_tpu_torch.kernels.custom_ops`) runs: on
a CUDA tensor it launches the hand-written kernel (or raises), on a CPU
tensor it takes the kernel's plain version; where it says composition,
both take the composition.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

import cistar_tpu_torch.kernels  # noqa: F401  (registers the ops)
from cistar_tpu_torch.device import on_cuda
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.quant_int8 import EPS, _div

ACTS = ("none", "relu", "leaky", "tanh")

# The TPU kernels' VMEM budgets (``pallas_kernels.py:28-29``, :152-153).
_IN_BLOCK_BYTES = 2 * 1024 * 1024
_IN_BLOCK_BYTES_RES = 1 * 1024 * 1024
_CONV_BLOCK_BYTES = 9 * 1024 * 1024


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


# --------------------------------------------------------------------------- #
# K4: instance norm + activation (+ residual)
# --------------------------------------------------------------------------- #
def in_act_fits(x: torch.Tensor, residual: Optional[torch.Tensor] = None
                ) -> bool:
    """The JAX rule for K4 (``pallas_kernels.py:65-91``): one image of
    ``x`` within 2 MiB (1 MiB with a residual) and at least 8 pixels."""
    n, h, w, c = x.shape
    budget = _IN_BLOCK_BYTES_RES if residual is not None else _IN_BLOCK_BYTES
    return h * w * c * x.element_size() <= budget and h * w >= 8


def _act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return torch.where(y >= 0, y, y * slope)
    if act == "tanh":
        return torch.tanh(y)
    return y


def fused_instance_norm_act_plain(x: torch.Tensor, act: str = "none",
                                  eps: float = EPS,
                                  negative_slope: float = 0.2,
                                  residual: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain K4, the math of ``_in_act_kernel`` / ``_in_act_res_kernel``:
    mean, then the centered variance, in fp32; with a residual, relu and
    leaky only (the TPU kernel has no tanh branch there: ROADMAP queue 3)."""
    xf = x.float()
    hw = float(x.shape[1] * x.shape[2])
    mean = _div(xf.sum(dim=(1, 2), keepdim=True), hw)
    cen = xf - mean
    var = _div((cen * cen).sum(dim=(1, 2), keepdim=True), hw)
    y = cen * torch.rsqrt(var + eps)
    if residual is not None:
        y = y + residual.float()
        if act == "tanh":
            act = "none"
    return _act(y, act, negative_slope).to(x.dtype)


def _in_act_composition(x, act, eps, slope, residual):
    """The JAX fallback (``pallas_kernels.py:93-103``), in ``x.dtype``."""
    y = tnn.instance_norm(x, eps)
    if residual is not None:
        y = y + residual
    if act == "relu":
        return tnn.relu(y)
    if act == "leaky":
        return tnn.leaky_relu(y, slope)
    if act == "tanh":
        return tnn.tanh(y)
    return y


def fused_instance_norm_act(x: torch.Tensor, act: str = "none",
                            eps: float = EPS, negative_slope: float = 0.2,
                            residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K4 where :func:`in_act_fits`, else the composition
    (``fused_instance_norm_act``). NHWC in and out, ``x.dtype``."""
    _check_act(act)
    if not in_act_fits(x, residual):
        return _in_act_composition(x, act, eps, negative_slope, residual)
    on_cuda(x)
    return torch.ops.cistar.in_act(
        x.contiguous(), act, negative_slope,
        None if residual is None else residual.contiguous(), eps)


# --------------------------------------------------------------------------- #
# K3: 3×3 conv + instance norm + activation (+ residual)
# --------------------------------------------------------------------------- #
def conv3x3_in_act_fits(x: torch.Tensor, w: torch.Tensor,
                        residual: Optional[torch.Tensor] = None) -> bool:
    """The JAX rule for K3 (``pallas_kernels.py:150-159``): the padded
    image, the fp32 accumulator and the weights of one grid step within
    9 MiB, and the residual (if any) of the output's shape. It reads the
    weights' dtype: at 32² × 512 bf16 weights fit (8.0 MB), fp32 do not
    (12.7 MB)."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    need = (h + 2) * (wd + 2) * cin * x.element_size() \
        + h * wd * cout * 4 + 9 * cin * cout * w.element_size()
    return need <= _CONV_BLOCK_BYTES and (
        residual is None or tuple(residual.shape) == (n, h, wd, cout))


def _pad1(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """NHWC → padded NCHW view, reflect or zero, 1 pixel."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode="reflect" if pad_mode == "reflect" else "constant")


def conv3x3_bias_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       pad_mode: str = "reflect") -> torch.Tensor:
    """The conv of plain K3: NHWC ``x`` values times OIHW ``w`` values,
    summed in fp32, + b → fp32 NHWC (the plain version of
    ``kernels/fused_conv.py::conv3x3_bf16_f32``; on the card run it with
    TF32 off)."""
    acc = F.conv2d(_pad1(x, pad_mode).float(), w.float()).permute(0, 2, 3, 1)
    return acc if b is None else acc + b.float()


def fused_conv3x3_in_act_plain(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None,
                               act: str = "relu",
                               residual: Optional[torch.Tensor] = None,
                               pad_mode: str = "reflect",
                               eps: float = EPS) -> torch.Tensor:
    """Plain K3, the math of the TPU kernel: ``x`` values times ``w``
    values (OIHW), each in its own dtype, summed in fp32 (on the card run
    it with TF32 off where either is fp32), + b, single-pass IN, residual,
    ReLU for ``act == "relu"``, cast to ``x.dtype``."""
    n, h, wd, _ = x.shape
    acc = conv3x3_bias_plain(x, w, b, pad_mode)
    hw = float(h * wd)
    mean = _div(acc.sum(dim=(1, 2), keepdim=True), hw)
    msq = _div((acc * acc).sum(dim=(1, 2), keepdim=True), hw)
    var = torch.clamp(msq - mean * mean, min=0.0)
    y = (acc - mean) * torch.rsqrt(var + eps)
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def _conv_in_act_composition(x, w, b, act, residual, pad_mode, eps):
    """The JAX fallback (``pallas_kernels.py:160-167``), in ``x.dtype``."""
    y = tnn.conv2d_reflect(x, w, b) if pad_mode == "reflect" \
        else tnn.conv2d(x, w, b, padding=1)
    y = tnn.instance_norm(y, eps)
    if residual is not None:
        y = y + residual
    if act == "relu":
        y = tnn.relu(y)
    return y


def fused_conv3x3_in_act(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None, act: str = "relu",
                         residual: Optional[torch.Tensor] = None,
                         pad_mode: str = "reflect",
                         eps: float = EPS) -> torch.Tensor:
    """K3 where :func:`conv3x3_in_act_fits`, else the composition
    (``fused_conv3x3_in_act``). NHWC ``x``, OIHW (Cout, Cin, 3, 3) ``w``;
    returns ``x.dtype``."""
    if pad_mode not in ("reflect", "zero"):
        raise ValueError(f"pad_mode must be 'reflect' or 'zero', "
                         f"got {pad_mode!r}")
    if not conv3x3_in_act_fits(x, w, residual):
        return _conv_in_act_composition(x, w, b, act, residual, pad_mode, eps)
    on_cuda(x)
    wk = w.detach().permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()
    bias = None if b is None else b.detach().float().contiguous()
    return torch.ops.cistar.conv3x3_in_act(
        x.contiguous(), wk, bias, act == "relu",
        None if residual is None else residual.contiguous(),
        pad_mode == "reflect", eps)


# --------------------------------------------------------------------------- #
# K9: 7×7 reflect conv to one channel (+ tanh), optionally after IN + ReLU
# --------------------------------------------------------------------------- #
def reflect_conv_fp32(xn: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """Reflect-pad "same" conv of NHWC ``xn`` with OIHW ``w`` rounded to
    ``xn.dtype``, products and sums in fp32 (JAX:
    ``preferred_element_type=f32``), + b and tanh (``act == "tanh"``) in
    fp32, then the cast back. bf16 values are exact in TF32, so for a bf16
    ``xn`` cuDNN's TF32 (PyTorch's default) gives the same products on
    tensor cores; with TF32 off this conv is a plain fp32 one."""
    dt = xn.dtype
    p = w.shape[-1] // 2
    xp = F.pad(xn.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    y = F.conv2d(xp.float(), w.to(dt).float())
    if b is not None:
        y = y + b.float()[None, :, None, None]
    if act == "tanh":
        y = torch.tanh(y)
    return y.permute(0, 2, 3, 1).to(dt)


def conv2d_reflect_cout1_plain(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None,
                               act: str = "none", pre_in: bool = False,
                               eps: float = EPS) -> torch.Tensor:
    """Plain K9. ``pre_in``: relu(IN(x)) first, with single-pass
    statistics, normalized and ReLU'd in fp32, rounded to ``x.dtype``
    (``head_conv.py::_head_kernel``)."""
    if pre_in:
        mean, rsigma = tnn.instance_norm_stats(x, eps)
        x = torch.relu((x.float() - mean) * rsigma).to(x.dtype)
    return reflect_conv_fp32(x, w, b, act)


def _cout1(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           act: str, pre_in: bool = False, eps: float = EPS) -> torch.Tensor:
    """K9 on any of its TPU callers' arguments: NHWC (N,H,W,Cin) ``x``,
    OIHW (1, Cin, 7, 7) ``w`` → (N,H,W,1) in ``x.dtype``."""
    n, h, wd, cin = x.shape
    if tuple(w.shape) != (1, cin, 7, 7) or h <= 3 or wd <= 3:
        raise ValueError(f"K9 takes a (1, Cin, 7, 7) weight and H, W > 3, "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if act not in ("none", "tanh"):
        raise ValueError(f"K9 takes act 'none' or 'tanh', got {act!r}")
    on_cuda(x)
    wt = w.detach()[0].permute(1, 2, 0).reshape(49, cin).to(x.dtype) \
        .float().contiguous()
    bias = None if b is None else b.detach().float().contiguous()
    return torch.ops.cistar.head_cout1(x.contiguous(), wt, bias,
                                       act == "tanh", pre_in, eps)


def conv2d_reflect_cout1(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None,
                         act: str = "none") -> torch.Tensor:
    """K9a (``pallas_kernels.py::conv2d_reflect_cout1``). K9b
    (``conv2d_reflect_cout1_masked``) and K9c (``conv2d_reflect_cout1_loop``)
    compute the same function and are this one."""
    return _cout1(x, w, b, act)


conv2d_reflect_cout1_masked = conv2d_reflect_cout1_loop = conv2d_reflect_cout1
