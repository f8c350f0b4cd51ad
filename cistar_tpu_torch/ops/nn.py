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

import functools
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
           stride: int = 1, padding: int = 0, dilation: int = 1
           ) -> torch.Tensor:
    """2-D convolution: NHWC ``x``, OIHW ``w`` (``ops/nn.py::conv2d``)."""
    out = F.conv2d(_nchw(x), w.to(x.dtype), None, stride=stride,
                   padding=padding, dilation=dilation)
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


def conv2d_reflect_thin(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reflect-pad conv for one-channel ends, the c7s1 stem of a grayscale
    input and the one-channel head (``ops/nn.py::conv2d_reflect_thin``),
    with the JAX version's arithmetic, OIHW ``w``:

      * Cout = 1: one (C → k²) matmul, then the k² shifted maps added in
        ``x.dtype``, in tap order, from zeros (in bf16, one rounding per
        tap);
      * Cin = 1: the k² shifted maps stacked, then one (k² → Cout) matmul.

    Any other conv is :func:`conv2d_reflect`."""
    k = w.shape[-1]
    if w.shape[-2] != k or k % 2 == 0 or k < 3:
        return conv2d_reflect(x, w, b)
    p = k // 2
    n, h, wd = x.shape[:3]
    cout, cin = w.shape[:2]
    if cout == 1 and cin > 1:                   # head: many → 1
        wm = w[0].reshape(cin, k * k)           # (C, k²), tap = ky·k + kx
        z = torch.matmul(x, wm.to(x.dtype))     # (n, h, w, k²)
        zp = _nhwc(F.pad(_nchw(z), (p, p, p, p), mode="reflect"))
        out = torch.zeros(n, h, wd, dtype=x.dtype, device=x.device)
        for t in range(k * k):
            dy, dx = t // k, t % k
            out = out + zp[:, dy:dy + h, dx:dx + wd, t]
        out = out[..., None]
    elif cin == 1 and cout > 1:                 # stem: 1 → many
        xp = F.pad(x[None, ..., 0], (p, p, p, p), mode="reflect")[0]
        cols = torch.stack([xp[:, t // k:t // k + h, t % k:t % k + wd]
                            for t in range(k * k)], dim=-1)   # (n,h,w,k²)
        wm = w[:, 0].reshape(cout, k * k).t()                  # (k², Cout)
        out = torch.matmul(cols, wm.to(x.dtype))
    else:
        return conv2d_reflect(x, w, b)
    return _add_bias(out, b)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0,
                     dilation: int = 1) -> torch.Tensor:
    """Transposed conv, ``w`` in PyTorch's ``(in, out, kh, kw)`` layout, no
    flip (``ops/nn.py::conv_transpose2d``). Output size per dim: ``(n-1)·s
    − 2p + d·(k−1) + op + 1``, the JAX version's input-dilated form."""
    out = F.conv_transpose2d(_nchw(x), w.to(x.dtype), None, stride=stride,
                             padding=padding, output_padding=output_padding,
                             dilation=dilation)
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


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Instance norm over H, W; statistics in fp32, result cast back to the
    input dtype (``ops/nn.py::instance_norm``). Affine when given the (C,)
    ``gamma`` (γ itself) and ``beta``, applied in fp32 in that order."""
    mean, rsigma = instance_norm_stats(x, eps)
    out = (x.float() - mean) * rsigma
    if gamma is not None:
        out = out * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


def instance_norm_act(x: torch.Tensor, act: str = "none",
                      residual: Optional[torch.Tensor] = None,
                      eps: float = 1e-5,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Instance norm + activation (+ residual) through K4 where the JAX
    rule puts it (``ops/nn.py::instance_norm_act``; see
    :func:`cistar_tpu_torch.ops.fused.fused_instance_norm_act`)."""
    from cistar_tpu_torch.ops.fused import fused_instance_norm_act

    return fused_instance_norm_act(x, act=act, eps=eps,
                                   negative_slope=negative_slope,
                                   residual=residual)


def batch_norm_inference(x: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """BatchNorm with given (C,) statistics, inference form, NHWC:
    ``(x − mean) · rsqrt(var + eps) · gamma + beta`` in fp32, cast back
    (``ops/nn.py::batch_norm_inference``)."""
    out = (x.float() - mean) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def max_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """Max pool with −inf padding (``ops/nn.py::max_pool2d``); a max is
    exact in any order. Its backward is PyTorch's, which routes a tied
    window's gradient to its first maximum in row-major order, the rule of
    JAX's ``_max_pool_2x2_bwd`` (the forward keeps an index only on a
    strictly greater value): held to JAX with tied windows on the CPU in
    NCHW and channels_last, fp32 and bf16 (``tests/test_torch_gatys.py``),
    and on the card to the CPU (``chip_smoke.py``, phase 32)."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel, stride or kernel, padding))


@functools.lru_cache(maxsize=None)
def _pool_counts(h: int, w: int, k: int, s: int, p: int,
                 device: torch.device) -> torch.Tensor:
    """Reciprocal valid-element counts of each output pixel of a padded
    average pool, (ho, wo, 1) fp32 (``ops/nn.py::_pool_counts``). Made
    outside inference mode: the cached table also serves train steps,
    which autograd may not save an inference tensor for."""
    with torch.inference_mode(False):
        padded = torch.zeros(h + 2 * p, w + 2 * p)
        padded[p:p + h, p:p + w] = 1.0
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        cnt = torch.zeros(ho, wo)
        for dy in range(k):
            for dx in range(k):
                cnt += padded[dy:dy + (ho - 1) * s + 1:s,
                              dx:dx + (wo - 1) * s + 1:s]
        return (torch.ones_like(cnt) / cnt)[..., None].to(device)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """Average pool as ``nn.AvgPool2d(count_include_pad=False)``, the form
    pix2pixHD uses (``ops/nn.py::avg_pool2d``), with the JAX version's
    arithmetic: the fp32 window sum (zero padding, taps in row-major
    order), then times the reciprocal-count table (divided by k² without
    padding); cast back."""
    k, s, p = kernel, stride or kernel, padding
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    summed = torch.zeros(n, ho, wo, c, device=x.device)
    for dy in range(k):
        for dx in range(k):
            summed = summed + xp[:, dy:dy + (ho - 1) * s + 1:s,
                                 dx:dx + (wo - 1) * s + 1:s]
    if p == 0:
        out = summed / torch.full_like(summed, k * k)
    else:
        out = summed * _pool_counts(h, w, k, s, p, x.device)
    return out.to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Global spatial mean in fp32, cast back to the input dtype: the
    PatchGAN pooled head (``ops/nn.py::global_avg_pool``)."""
    return x.float().mean(dim=(1, 2), keepdim=keepdim).to(x.dtype)


def upsample_bilinear(x: torch.Tensor, scale_factor: int = 2) -> torch.Tensor:
    """Bilinear upsample, half-pixel centres (``align_corners=False``,
    ``nn.Upsample``'s default; ``ops/nn.py::upsample_bilinear``)."""
    out = F.interpolate(_nchw(x), scale_factor=scale_factor, mode="bilinear",
                        align_corners=False)
    return _nhwc(out)


def _up_taps() -> torch.Tensor:
    """(2, 3, 3) ``A``: ``A[p, t, o + 1]`` is the weight of ``x[i + o]`` in
    ``up[2i + p + t - 1]``, the row that tap ``t`` of a 3×3 conv reads at
    output phase ``p``, where ``up`` is the 2× bilinear upsample
    (``up[2j] = 0.25·x[j-1] + 0.75·x[j]``, ``up[2j+1] = 0.75·x[j] +
    0.25·x[j+1]``). Built as ``ops/nn.py::upconv2x_bilinear`` builds it."""
    rows = []
    u = ({-1: 0.25, 0: 0.75}, {0: 0.75, 1: 0.25})
    for p in (0, 1):
        for t in range(3):
            s = p + t - 1
            j_off, pp = s >> 1, s & 1
            row = [0.0, 0.0, 0.0]
            for d, coef in u[pp].items():
                row[j_off + d + 1] += coef
            rows.append(row)
    return torch.tensor(rows, dtype=torch.float32).reshape(2, 3, 3)


def upconv2x_bilinear(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv2d(upsample_bilinear(x, 2), w, padding=1)`` as one conv on the
    low-resolution grid (``ops/nn.py::upconv2x_bilinear``), OIHW ``w``.

    The 3×3 conv of the 2× upsample is, at each of the four output phases,
    a 3×3 conv of ``x``: one conv to ``4·Cout`` channels, then a depth-to-
    space. The upsample's edge clamp and the conv's zero pad make the two
    outer rows and columns differ; they are recomputed from 3-row / 3-col
    slabs of the two-op path and pasted over, top and bottom first, then
    left and right, which overwrite the corners (the JAX order)."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if h < 3 or wd < 3:
        return conv2d(upsample_bilinear(x, 2), w, b, padding=1)
    a = _up_taps().to(x.device)
    # eff[p, q, o, i, a, b] = Σ_ty,tx w[o, i, ty, tx]·A[p, ty, a]·A[q, tx, b]
    eff = torch.einsum("oiyx,pya,qxb->pqoiab", w.float(), a, a)
    y4 = conv2d(x, eff.reshape(4 * cout, cin, 3, 3).to(x.dtype), None,
                padding=1)
    y = y4.reshape(n, h, wd, 2, 2, cout).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * h, 2 * wd, cout)

    def strip(xs):
        return conv2d(xs, w, None, padding=1)

    y[:, :2] = strip(upsample_bilinear(x[:, :3], 2)[:, :3])[:, :2]
    y[:, -2:] = strip(upsample_bilinear(x[:, h - 3:], 2)[:, -3:])[:, -2:]
    y[:, :, :2] = strip(upsample_bilinear(x[:, :, :3], 2)[:, :, :3])[:, :, :2]
    y[:, :, -2:] = strip(
        upsample_bilinear(x[:, :, wd - 3:], 2)[:, :, -3:])[:, :, -2:]
    return _add_bias(y, b)
