"""Int8 quantizers and the int8 blocks (counterpart of
``cistar_tpu/ops/quant_pallas.py``).

Four fused blocks, each computing one block of a CycleGAN generator with
int8 convolutions:

  * K1 :func:`resblock_int8_bf16io` (TPU kernel
    ``_resblock_int8_bf16io_kernel``): a residual block, full-precision
    carrier in and out.
  * K2 :func:`resblock_int8` (TPU kernel ``_resblock_int8_kernel``): the
    same with an int8 carrier and one scale per image.
  * K5 :func:`atrous_resblock_int8` (TPU kernel
    ``_atrous_resblock_int8_kernel``): a ``ResidualBlockAtrous``, full-
    precision carrier.
  * K6 :func:`multi_atrous_stage_int8` (TPU kernel
    ``_multi_atrous_stage_int8_kernel``): a stride-2 ``MultiAtrousConv``
    encoder stage.
  * K7 :func:`resblock_int8_tiled` (TPU kernels ``_resblock_a_kernel`` and
    ``_resblock_b_kernel``): a residual block tiled over its output
    channels, with per-(image, tile) requantization scales (pix2pixHD's
    1024-channel GlobalGenerator trunk).

K1 and K7 take ``bn=True`` for a BatchNorm ``ResnetBlock`` (pix2pixHD's
MultiscaleGlobalGenerator): its inference affine is folded into the ``sb``
rows by :func:`quantize_resblock_bn`, and the blocks run no IN.
  * K8 :func:`msrb_stage` (TPU kernel ``_msrb_branch_kernel``, once per
    branch): one stage of an MSRB block, its 3×3 and 5×5 zero-pad branches
    with per-input-group scales (the UNet-MSRB trunk).

Each is called through its ``cistar`` custom op
(:mod:`cistar_tpu_torch.kernels.custom_ops`): on a CUDA tensor it launches
the hand-written kernels of
:mod:`cistar_tpu_torch.kernels.int8_resblock` /
:mod:`~cistar_tpu_torch.kernels.int8_atrous` /
:mod:`~cistar_tpu_torch.kernels.int8_tiled` /
:mod:`~cistar_tpu_torch.kernels.int8_msrb` (or raises); on a CPU tensor it
runs the plain PyTorch version here, which mirrors the JAX emulation
(``_resblock_int8_bf16io_emulate``, ``_resblock_int8_emulate``,
``_atrous_resblock_int8_emulate``, ``_multi_atrous_stage_int8_emulate``,
``_resblock_int8_tiled_emulate``, ``_msrb_stage_emulate``) op for op.

Numerics kept exactly as in JAX:

  * every division is tensor by tensor (:func:`_div`). PyTorch computes
    ``127.0 / t`` (Python scalar numerator) as ``127 * reciprocal(t)``, and
    on CUDA ``t / 127.0`` as ``t * (1 / 127)``; both miss IEEE division by
    one ulp in about a quarter of cases, which flips quantized LSBs.
  * ``torch.round`` rounds half to even, like ``jnp.round``.
  * the dequantize keeps JAX's op order, ``f * (x_scale * w_scale) + bias``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

import cistar_tpu_torch.kernels  # noqa: F401  (registers the ops)
from cistar_tpu_torch.device import on_cuda

cistar = torch.ops.cistar   # the kernels' custom ops (kernels/custom_ops.py)

EPS = 1e-5   # instance-norm epsilon (``nn.InstanceNorm2d``'s default)
RATES = (2, 4, 6, 8)   # the atrous branches' dilations (``MultiAtrousConv``)

QBlock = Dict[str, torch.Tensor]


def _div(a: Union[torch.Tensor, float], b: Union[torch.Tensor, float]
         ) -> torch.Tensor:
    """IEEE ``a / b`` with both operands as full tensors (see module doc)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


# --------------------------------------------------------------------------- #
# Quantizers
# --------------------------------------------------------------------------- #
def quantize_kernel_taps(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OIHW (Cout, Cin, 3, 3) → ``(wq, scale, wk)`` (``_quantize_kernel_taps``).

    ``wq`` is (9, Cin, Cout) int8 as in JAX, ``scale`` (Cout,) fp32, and
    ``wk`` the same int8 values as the GEMM operand the CUDA conv reads:
    (Cout, 9·Cin), K-contiguous, K = tap·Cin + cin."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    scale = _div(torch.clamp(absmax, min=1e-8), 127.0)
    q = _to_int8(_div(w, scale[:, None, None, None].expand_as(w)))
    cout, cin, kh, kw = q.shape
    wq = q.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout).contiguous()
    wk = q.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin).contiguous()
    return wq, scale, wk


def quantize_resblock(blk) -> QBlock:
    """Quantize one :class:`~cistar_tpu_torch.ops.blocks.ResidualBlock`
    (``quantize_resblock``). ``sb`` rows: [w1_scale, b1, w2_scale, b2]."""
    w1q, s1, w1k = quantize_kernel_taps(blk.conv1.weight)
    w2q, s2, w2k = quantize_kernel_taps(blk.conv2.weight)
    sb = torch.stack([s1, blk.conv1.bias.detach().float(),
                      s2, blk.conv2.bias.detach().float()], dim=0)
    return {"w1q": w1q, "w2q": w2q, "sb": sb.contiguous(),
            "w1k": w1k, "w2k": w2k}


def quantize_resblock_bn(blk, eps: float = EPS) -> QBlock:
    """Quantize a BatchNorm pix2pixHD ``ResnetBlock`` with the norm folded
    (``quantize_resblock_bn``): the running-stats affine goes into the
    ``sb`` rows as scale ``s·inv`` and bias ``(b − μ)·inv + β``, with
    ``inv = γ / sqrt(σ² + eps)``; the blocks then run with ``bn=True``."""
    w1q, s1, w1k = quantize_kernel_taps(blk.conv1.weight)
    w2q, s2, w2k = quantize_kernel_taps(blk.conv2.weight)

    def fold(s, conv, norm):
        inv = _div(norm.weight.detach().float(),
                   torch.sqrt(norm.running_var.float() + eps))
        return s * inv, (conv.bias.detach().float()
                         - norm.running_mean.float()) * inv \
            + norm.bias.detach().float()

    sc1, bias1 = fold(s1, blk.conv1, blk.norm1)
    sc2, bias2 = fold(s2, blk.conv2, blk.norm2)
    sb = torch.stack([sc1, bias1, sc2, bias2], dim=0)
    return {"w1q": w1q, "w2q": w2q, "sb": sb.contiguous(),
            "w1k": w1k, "w2k": w2k}


def quantize_resnet_trunk(gen) -> List[QBlock]:
    """Quantize the residual blocks of a port ``ResnetGenerator``
    (``quantize_resnet_trunk``)."""
    return [quantize_resblock(b) for b in gen.res]


def quantize_global_trunk(gen) -> List[QBlock]:
    """Quantize the residual blocks of a port ``GlobalGenerator``, which
    live under ``trunk`` (``quantize_global_trunk``)."""
    return [quantize_resblock(b) for b in gen.trunk.res]


def quantize_msrb(blk) -> QBlock:
    """Quantize one :class:`~cistar_tpu_torch.ops.blocks.MSRB`
    (``quantize_msrb``): ``w3a`` (9, n, n), ``w5a`` (25, n, n), ``w3b``
    (9, 2n, n), ``w5b`` (25, 2n, n) int8 and the stages' ``sb1`` / ``sb2``
    rows [s3, b3, s5, b5]; ``w*k`` (n, kk²·Cin) are the CUDA conv's
    operands. The 1×1 ``out_conv`` stays fp32: ``w1x1`` (2n, n), ``b1x1``."""
    q: QBlock = {}
    for stage, (c3, c5) in (("a", (blk.b00_conv, blk.b01_conv)),
                            ("b", (blk.b10_conv, blk.b11_conv))):
        rows = []
        for kk, conv in ((3, c3), (5, c5)):
            wq, s, wk = quantize_kernel_taps(conv.weight)
            q[f"w{kk}{stage}"], q[f"w{kk}{stage}k"] = wq, wk
            rows += [s, conv.bias.detach().float()]
        q["sb1" if stage == "a" else "sb2"] = torch.stack(rows).contiguous()
    w1x1 = blk.out_conv.weight.detach().float()[:, :, 0, 0]
    q["w1x1"] = w1x1.t().contiguous()
    q["b1x1"] = blk.out_conv.bias.detach().float()
    return q


def _quantize_branches(mac) -> Tuple[List[torch.Tensor], ...]:
    """Per branch of a ``MultiAtrousConv``: int8 taps, GEMM operand, and
    the [scale, bias] rows of ``sb``."""
    wqs, wks, rows = [], [], []
    for conv in mac.branches():
        wq, s, wk = quantize_kernel_taps(conv.weight)
        wqs.append(wq)
        wks.append(wk)
        rows += [s, conv.bias.detach().float()]
    return wqs, wks, rows


def quantize_atrous_resblock(blk) -> QBlock:
    """Quantize one :class:`~cistar_tpu_torch.ops.blocks.ResidualBlockAtrous`
    (``quantize_atrous_resblock``). ``wbq`` (4, 9, C, C), ``wcq`` (9, C, C),
    ``sb`` (10, C) rows [s0, b0, …, s3, b3, sc, bc]; ``wbk`` (4, C, 9·C) and
    ``wck`` (C, 9·C) are the CUDA conv's operands."""
    wqs, wks, rows = _quantize_branches(blk.atrous)
    wcq, sc, wck = quantize_kernel_taps(blk.conv.weight)
    rows += [sc, blk.conv.bias.detach().float()]
    return {"wbq": torch.stack(wqs), "wcq": wcq,
            "sb": torch.stack(rows).contiguous(),
            "wbk": torch.stack(wks), "wck": wck}


def quantize_multi_atrous_stage(stage) -> QBlock:
    """Quantize one :class:`~cistar_tpu_torch.ops.blocks.MultiAtrousConv`
    (``quantize_multi_atrous_stage``). ``wbq`` (4, 9, Cin, Cout), ``sb``
    (8, Cout) rows [s0, b0, …, s3, b3]; ``wbk`` (4, Cout, 9·Cin)."""
    wqs, wks, rows = _quantize_branches(stage)
    return {"wbq": torch.stack(wqs), "sb": torch.stack(rows).contiguous(),
            "wbk": torch.stack(wks)}


def atrous_stage_fits(h: int, w: int, cin: int, cout: int,
                      max_r2: int = 4) -> bool:
    """The JAX engine's routing rule for an encoder stage
    (``quant_pallas.py::atrous_stage_fits``): whether its whole-image stage
    kernel fits the scoped VMEM of a TPU v5e at the post-stride (h, w).
    Hopper has no such limit, but a stage that does not fit runs in bf16,
    not int8, in the JAX engine, so the port routes the same way to give
    the same result (ROADMAP queue 3)."""
    units = math.ceil(cin / 128) + 3.5 * math.ceil(cout / 128)
    scoped_bytes = 4 * h * w * 128 * (units + 0.03)
    return scoped_bytes <= 15 * 1024 * 1024 \
        and h > 2 * max_r2 and w > 2 * max_r2


def whole_image_resblock_fits(h: int, w: int, c: int) -> bool:
    """The JAX engine's rule between the whole-image res-block chain (K1)
    and the cout-tiled one (K7) (``whole_image_resblock_fits``): whether
    the whole-image TPU kernel fits a TPU v5e's VMEM. The two chains give
    different numbers (one requantization scale per image, or per tile),
    so the port routes the same way."""
    return (h * w * c * 14 + 2 * 9 * c * c + 16 * c
            <= 13 * 1024 * 1024 and h >= 3 and w >= 3)


def pick_cout_tile(hw: int, c: int, budget: int = 12 * 1024 * 1024) -> int:
    """The JAX kernel path's cout tile (``pick_cout_tile``): the largest of
    512/256/128/64 that divides C and whose TPU kernel-B working set fits
    ``budget``. The tile sets the requantization groups, so it is a
    numerical parameter; raises ValueError where no tile fits."""
    for ct in (512, 256, 128, 64):
        if ct <= c and c % ct == 0 \
                and 2.2 * hw * c + 9 * c * ct + 12 * hw * ct <= budget:
            return ct
    raise ValueError(
        f"no cout tile in (512,256,128,64) both divides C={c} and fits the "
        f"VMEM budget ({budget} B) at hw={hw}")


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image symmetric int8: (B,H,W,C) → (int8 (B,H,W,C), (B,1) scale)
    (``quantize_act``)."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=(1, 2, 3)), min=1e-6)
    inv = _div(127.0, absmax)[:, None, None, None]
    return _to_int8(xf * inv), _div(absmax, 127.0)[:, None]


# --------------------------------------------------------------------------- #
# Plain versions of the kernels
# --------------------------------------------------------------------------- #
def _reflect_index(n: int, device) -> torch.Tensor:
    return torch.tensor([1] + list(range(n)) + [n - 2], device=device)


def _conv_plain(xp: torch.Tensor, wq: torch.Tensor, h: int, w: int,
                kk: int, rate: int = 1, groups: int = 1) -> torch.Tensor:
    """The kk² taps, ``rate`` apart, of a kk×kk conv over a padded int8 NHWC
    ``xp`` with (kk², Cin, Cout) ``wq`` → int32 (groups, N, h, w, Cout), the
    partial sum over each group of Cin / groups input channels.

    Products are summed in float64, which holds every partial sum of
    ≤ kk²·Cin products of int8 values exactly (|sum| < 2^53), in any
    order."""
    n, c = xp.shape[0], xp.shape[-1]
    cg = c // groups
    out = []
    for g in range(groups):
        lo = g * cg
        acc = torch.zeros(n * h * w, wq.shape[-1], dtype=torch.float64,
                          device=xp.device)
        for k in range(kk * kk):
            dy, dx = (k // kk) * rate, (k % kk) * rate
            patch = xp[:, dy:dy + h, dx:dx + w, lo:lo + cg].reshape(n * h * w,
                                                                   cg)
            acc += patch.double() @ wq[k, lo:lo + cg].double()
        out.append(acc.to(torch.int32).reshape(n, h, w, -1))
    return torch.stack(out)


def _conv9_plain(xp: torch.Tensor, wq: torch.Tensor, h: int, w: int,
                 rate: int) -> torch.Tensor:
    """:func:`_conv_plain` of a 3×3 conv, one group → int32 (N,h,w,Cout)."""
    return _conv_plain(xp, wq, h, w, 3, rate)[0]


def _reflect_pad1(xq: torch.Tensor) -> torch.Tensor:
    n, h, w, c = xq.shape
    return xq[:, _reflect_index(h, xq.device)][:, :,
                                                _reflect_index(w, xq.device)]


def _zero_pad(xq: torch.Tensor, p: int) -> torch.Tensor:
    n, h, w, c = xq.shape
    xp = xq.new_zeros(n, h + 2 * p, w + 2 * p, c)
    xp[:, p:p + h, p:p + w] = xq
    return xp


def conv3x3_reflect_s8_plain(xq: torch.Tensor, wq: torch.Tensor
                             ) -> torch.Tensor:
    """Reflect-pad-1 3×3 conv of int8 NHWC ``xq`` with (9, Cin, Cout) int8
    ``wq`` → int32 (N,H,W,Cout) (``_conv9_int8``)."""
    n, h, w, c = xq.shape
    return _conv9_plain(_reflect_pad1(xq), wq, h, w, 1)


def conv3x3_reflect_grouped_s8_plain(xq: torch.Tensor, wq: torch.Tensor,
                                     groups: int) -> torch.Tensor:
    """:func:`conv3x3_reflect_s8_plain` with one int32 partial per group of
    C / groups input channels → (groups, N,H,W,Cout) (the K loop of K7b)."""
    n, h, w, c = xq.shape
    return _conv_plain(_reflect_pad1(xq), wq, h, w, 3, 1, groups)


def conv_zero_grouped_s8_plain(xq: torch.Tensor, wq: torch.Tensor, kk: int,
                               groups: int) -> torch.Tensor:
    """Zero-pad (kk // 2) kk×kk conv of int8 NHWC ``xq`` with (kk², Cin,
    Cout) ``wq``, one int32 partial per group of input channels → (groups,
    N,H,W,Cout) (the K loop of K8)."""
    n, h, w, c = xq.shape
    return _conv_plain(_zero_pad(xq, kk // 2), wq, h, w, kk, 1, groups)


def conv3x3_dilated_s8_plain(xq: torch.Tensor, wq: torch.Tensor, rate: int
                             ) -> torch.Tensor:
    """Zero-pad 3×3 conv at dilation ``rate`` (padding ``rate``, same size)
    of int8 NHWC ``xq`` with (9, Cin, Cout) int8 ``wq`` → int32
    (N,H,W,Cout) (the branch conv of ``_atrous_resblock_int8_emulate``)."""
    n, h, w, c = xq.shape
    return _conv9_plain(_zero_pad(xq, rate), wq, h, w, rate)


def _inorm(f: torch.Tensor) -> torch.Tensor:
    """IN over axis 1 of (n, hw, c): single-pass moments, clamped ≥ 0."""
    hw = f.shape[1]
    mean = _div(f.sum(dim=1, keepdim=True), float(hw))
    msq = _div((f * f).sum(dim=1, keepdim=True), float(hw))
    var = torch.clamp(msq - mean * mean, min=0.0)
    return (f - mean) * torch.rsqrt(var + EPS)


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, hw, c) fp32 → (int8, (n,1,1) scale), one absmax per image."""
    amax = torch.clamp(x.abs().amax(dim=(1, 2), keepdim=True), min=1e-6)
    return _to_int8(x * _div(127.0, amax)), _div(amax, 127.0)


def _conv_dequant(q: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, bias: torch.Tensor,
                  rate: int = 0) -> torch.Tensor:
    """Int8 conv → (n, hw, Cout) fp32 ``f * (x_scale * w_scale) + bias``;
    reflect pad 1 for ``rate`` 0, else zero pad at dilation ``rate``."""
    n, h, w, c = q.shape
    acc = conv3x3_reflect_s8_plain(q, wq) if rate == 0 \
        else conv3x3_dilated_s8_plain(q, wq, rate)
    f = acc.float().reshape(n, h * w, -1)
    return f * (x_scale * w_scale[None, None, :]) + bias[None, None, :]


def _branch_sum(q: torch.Tensor, wbq: torch.Tensor, x_scale: torch.Tensor,
                sb: torch.Tensor, rates: Sequence[int]) -> torch.Tensor:
    """Σ_b relu(IN(dequant(conv_b(q)))), added in branch order from 0:
    (n, hw, Cout) fp32."""
    ssum = None
    for bi, r in enumerate(rates):
        f = _conv_dequant(q, wbq[bi], x_scale, sb[2 * bi], sb[2 * bi + 1], r)
        g = torch.relu(_inorm(f))
        ssum = g if ssum is None else ssum + g
    return ssum


def _norm(f: torch.Tensor, bn: bool) -> torch.Tensor:
    """IN, or nothing where a BatchNorm is folded into ``sb`` (``bn``)."""
    return f if bn else _inorm(f)


def resblock_int8_bf16io_plain(hx: torch.Tensor, qblk: QBlock,
                               bn: bool = False) -> torch.Tensor:
    """Plain K1, mirroring ``_resblock_int8_bf16io_emulate``."""
    n, h, w, c = hx.shape
    sb = qblk["sb"]
    hf = hx.float().reshape(n, h * w, c)
    hq, x_scale = _quant_rows(hf)
    f = _conv_dequant(hq.reshape(n, h, w, c), qblk["w1q"], x_scale,
                      sb[0], sb[1])
    rq, r_scale = _quant_rows(torch.relu(_norm(f, bn)))
    f2 = _conv_dequant(rq.reshape(n, h, w, c), qblk["w2q"], r_scale,
                       sb[2], sb[3])
    return (_norm(f2, bn) + hf).reshape(n, h, w, c).to(hx.dtype)


def resblock_int8_plain(hq: torch.Tensor, hs: torch.Tensor, qblk: QBlock
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2, mirroring ``_resblock_int8_emulate``: int8 ``hq`` + (N,1)
    scale ``hs`` in, the next block's int8 tensor and scale out."""
    n, h, w, c = hq.shape
    sb = qblk["sb"]
    x_scale = hs[:, :, None]
    f = _conv_dequant(hq, qblk["w1q"], x_scale, sb[0], sb[1])
    rq, r_scale = _quant_rows(torch.relu(_inorm(f)))
    f2 = _conv_dequant(rq.reshape(n, h, w, c), qblk["w2q"], r_scale,
                       sb[2], sb[3])
    hnew = _inorm(f2) + hq.reshape(n, h * w, c).float() * x_scale
    outq, out_s = _quant_rows(hnew)
    return outq.reshape(n, h, w, c), out_s.reshape(n, 1)


def atrous_resblock_int8_plain(hx: torch.Tensor, qblk: QBlock,
                               rates: Sequence[int] = RATES) -> torch.Tensor:
    """Plain K5, mirroring ``_atrous_resblock_int8_emulate``."""
    n, h, w, c = hx.shape
    sb = qblk["sb"]
    hf = hx.float().reshape(n, h * w, c)
    hq, x_scale = _quant_rows(hf)
    ssum = _branch_sum(hq.reshape(n, h, w, c), qblk["wbq"], x_scale, sb, rates)
    sq, s_scale = _quant_rows(ssum)
    nb = 2 * len(rates)
    f2 = _conv_dequant(sq.reshape(n, h, w, c), qblk["wcq"], s_scale,
                       sb[nb], sb[nb + 1])
    return (_inorm(f2) + hf).reshape(n, h, w, c).to(hx.dtype)


def multi_atrous_stage_int8_plain(xs: torch.Tensor, qstage: QBlock,
                                  rates2: Sequence[int]) -> torch.Tensor:
    """Plain K6 on the subsampled stage input ``xs``, mirroring
    ``_multi_atrous_stage_int8_emulate``."""
    n, h, w, cin = xs.shape
    xq, x_scale = _quant_rows(xs.float().reshape(n, h * w, cin))
    ssum = _branch_sum(xq.reshape(n, h, w, cin), qstage["wbq"], x_scale,
                       qstage["sb"], rates2)
    return ssum.reshape(n, h, w, -1).to(xs.dtype)


def _group_sum(acc: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Σ_g float(acc[g]) · scales[:, g], in fp32 in group order from 0:
    (groups, N,H,W,C) int32 and (N, groups) → (N, H·W, C)."""
    groups, n = acc.shape[:2]
    f = torch.zeros(n, acc[0, 0].numel() // acc.shape[-1], acc.shape[-1],
                    dtype=torch.float32, device=acc.device)
    for g in range(groups):
        f = f + acc[g].float().reshape(f.shape) * scales[:, g, None, None]
    return f


def _quant_tiles(r: torch.Tensor, ct: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, hw, C) fp32 → (int8 (n, hw, C), (n, C/ct) scales), one absmax
    per (image, tile of ct channels)."""
    n, hw, c = r.shape
    rt = r.reshape(n, hw, c // ct, ct)
    amax = torch.clamp(rt.abs().amax(dim=(1, 3), keepdim=True), min=1e-6)
    q = _to_int8(rt * _div(127.0, amax)).reshape(n, hw, c)
    return q, _div(amax, 127.0).reshape(n, c // ct)


def resblock_tiled_a_plain(hx: torch.Tensor, qblk: QBlock, ct: int,
                           bn: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K7a, the first half of ``_resblock_int8_tiled_emulate``: the
    int8 relu(IN(conv 1)) (N,H,W,C) (``bn``: relu(conv 1)) and its
    (N, C/ct) tile scales."""
    n, h, w, c = hx.shape
    sb = qblk["sb"]
    hq, hs = quantize_act(hx)
    f = _conv_dequant(hq, qblk["w1q"], hs[:, :, None], sb[0], sb[1])
    rq, rs = _quant_tiles(torch.relu(_norm(f, bn)), ct)
    return rq.reshape(n, h, w, c), rs


def resblock_tiled_b_plain(rq: torch.Tensor, rs: torch.Tensor,
                           hx: torch.Tensor, qblk: QBlock, ct: int,
                           bn: bool = False) -> torch.Tensor:
    """Plain K7b, the second half of ``_resblock_int8_tiled_emulate``:
    conv 2 group by group, each group's int32 partial times its tile scale,
    then the weight scale and bias, IN (not with ``bn``) and the skip
    ``hx``."""
    n, h, w, c = hx.shape
    sb = qblk["sb"]
    acc = conv3x3_reflect_grouped_s8_plain(rq, qblk["w2q"], c // ct)
    f2 = _group_sum(acc, rs) * sb[2] + sb[3]
    return (_norm(f2, bn) + hx.float().reshape(n, h * w, c)) \
        .reshape(n, h, w, c).to(hx.dtype)


def resblock_int8_tiled_plain(hx: torch.Tensor, qblk: QBlock, ct: int,
                              bn: bool = False) -> torch.Tensor:
    """Plain K7, mirroring ``_resblock_int8_tiled_emulate``."""
    rq, rs = resblock_tiled_a_plain(hx, qblk, ct, bn)
    return resblock_tiled_b_plain(rq, rs, hx, qblk, ct, bn)


def msrb_branch_plain(xq: torch.Tensor, xscales: torch.Tensor,
                      wq: torch.Tensor, sb: torch.Tensor, sb_row: int,
                      kk: int, ct: int, quant_out: bool,
                      out_dtype: Optional[torch.dtype]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K8, one branch of ``_msrb_stage_emulate``: the kk×kk zero-pad
    conv of int8 ``xq`` group by group with the (N, gin) ``xscales``, then
    ``f * sb[2r] + sb[2r + 1]`` and ReLU → (int8, (N, Cout/ct) scales) with
    ``quant_out``, else (``out_dtype``, ones)."""
    n, h, w, _ = xq.shape
    nf = wq.shape[-1]
    acc = conv_zero_grouped_s8_plain(xq, wq, kk, xscales.shape[1])
    f = torch.relu(_group_sum(acc, xscales) * sb[2 * sb_row]
                   + sb[2 * sb_row + 1])
    if not quant_out:
        return (f.reshape(n, h, w, nf).to(out_dtype),
                torch.ones(n, nf // ct, device=xq.device))
    q, s = _quant_tiles(f, ct)
    return q.reshape(n, h, w, nf), s


def msrb_stage_plain(xq: torch.Tensor, xscales: torch.Tensor,
                     w3q: torch.Tensor, w5q: torch.Tensor, sb: torch.Tensor,
                     ct: int, quant_out: bool,
                     out_dtype: Optional[torch.dtype]
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain MSRB stage, mirroring ``_msrb_stage_emulate``: (o3, o5, s3,
    s5), the 3×3 branch on ``sb`` rows 0-1, the 5×5 on rows 2-3."""
    o3, s3 = msrb_branch_plain(xq, xscales, w3q, sb, 0, 3, ct, quant_out,
                               out_dtype)
    o5, s5 = msrb_branch_plain(xq, xscales, w5q, sb, 1, 5, ct, quant_out,
                               out_dtype)
    return o3, o5, s3, s5


# --------------------------------------------------------------------------- #
# Dispatch (the custom ops): CPU tensors → plain version; CUDA → kernels;
# ``on_cuda`` raises for any other device before the op is reached.
# --------------------------------------------------------------------------- #
def resblock_int8_bf16io(hx: torch.Tensor, qblk: QBlock, bn: bool = False
                         ) -> torch.Tensor:
    """K1: one int8 residual block with a full-precision carrier; ``bn``:
    its BatchNorm form (``sb`` from :func:`quantize_resblock_bn`)."""
    on_cuda(hx)
    return cistar.resblock_int8_bf16io(hx.contiguous(), qblk["w1k"],
                                       qblk["w2k"], qblk["sb"], EPS, bn)


def resblock_int8(hq: torch.Tensor, hs: torch.Tensor, qblk: QBlock
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: one int8 residual block with an int8 carrier."""
    on_cuda(hq)
    return cistar.resblock_int8(hq.contiguous(), hs.contiguous(),
                                qblk["w1k"], qblk["w2k"], qblk["sb"], EPS)


def resblock_chain_int8_bf16io(x: torch.Tensor, qblocks: Sequence[QBlock],
                               bn: bool = False) -> torch.Tensor:
    """Res-block chain through K1 (``resblock_chain_int8_bf16io``)."""
    for qblk in qblocks:
        x = resblock_int8_bf16io(x, qblk, bn)
    return x


def resblock_chain_int8(x: torch.Tensor, qblocks: Sequence[QBlock]
                        ) -> torch.Tensor:
    """Res-block chain through K2 (``resblock_chain_int8``): quantize once,
    stay int8 between blocks, dequantize at the end."""
    hq, hs = quantize_act(x)
    for qblk in qblocks:
        hq, hs = resblock_int8(hq, hs, qblk)
    return (hq.float() * hs[:, :, None, None]).to(x.dtype)


def atrous_resblock_int8(hx: torch.Tensor, qblk: QBlock,
                         rates: Sequence[int] = RATES) -> torch.Tensor:
    """K5: one int8 atrous residual block with a full-precision carrier."""
    on_cuda(hx)
    return cistar.atrous_resblock_int8(hx.contiguous(), qblk["wbk"],
                                       qblk["wck"], qblk["sb"],
                                       [int(r) for r in rates], EPS)


def atrous_resblock_chain_int8(x: torch.Tensor, qblocks: Sequence[QBlock],
                               rates: Sequence[int] = RATES) -> torch.Tensor:
    """Atrous res-block chain through K5 (``atrous_resblock_chain_int8``)."""
    for qblk in qblocks:
        x = atrous_resblock_int8(x, qblk, rates)
    return x


def multi_atrous_stage_int8(x: torch.Tensor, qstage: QBlock,
                            rates: Sequence[int] = RATES, stride: int = 2
                            ) -> torch.Tensor:
    """K6: one stride-2 ``MultiAtrousConv`` stage of the full-resolution
    (N,H,W,Cin) ``x`` → (N,⌈H/2⌉,⌈W/2⌉,Cout) (``multi_atrous_stage_int8``).

    Stride 2 with even rates reads only the even pixels, so the stage is
    the halved rates on ``x[:, ::2, ::2]``, exactly."""
    if stride != 2 or any(r % 2 for r in rates):
        raise NotImplementedError("stage kernel requires stride=2 and even "
                                  f"rates; got stride={stride} rates={rates}")
    on_cuda(x)
    return cistar.multi_atrous_stage_int8(x.contiguous(), qstage["wbk"],
                                          qstage["sb"],
                                          [int(r) // 2 for r in rates], EPS)


def resblock_int8_tiled(hx: torch.Tensor, qblk: QBlock, ct: int,
                        bn: bool = False) -> torch.Tensor:
    """K7: one cout-tiled int8 residual block, full-precision carrier; on
    CUDA its two kernels, K7a then K7b; ``bn``: their BatchNorm form."""
    on_cuda(hx)
    hx = hx.contiguous()
    rq, rs = cistar.resblock_int8_tiled_a(hx, qblk["w1k"], qblk["sb"], ct,
                                          EPS, bn)
    return cistar.resblock_int8_tiled_b(rq, rs, hx, qblk["w2k"], qblk["sb"],
                                        ct, EPS, bn)


def resblock_chain_int8_tiled(x: torch.Tensor, qblocks: Sequence[QBlock],
                              cout_tile: Optional[int] = None,
                              bn: bool = False) -> torch.Tensor:
    """Res-block chain through K7 (``resblock_chain_int8_tiled``).

    ``cout_tile=None`` takes the JAX kernel path's tile on every device:
    :func:`pick_cout_tile`, and where that raises, the first of
    512/256/128/64 that divides C. (JAX off the TPU takes the first divisor
    alone, which differs at the 1024-channel trunk and at 64²×512: ROADMAP
    queue 3.) ``bn``: the BatchNorm form of K7."""
    n, h, w, c = x.shape
    if cout_tile is None:
        try:
            cout_tile = pick_cout_tile(h * w, c)
        except ValueError:
            cout_tile = next((ct for ct in (512, 256, 128, 64)
                              if ct <= c and c % ct == 0), c)
    if c % cout_tile:
        raise ValueError(f"cout_tile {cout_tile} must divide C={c}")
    for qblk in qblocks:
        x = resblock_int8_tiled(x, qblk, cout_tile, bn)
    return x


def msrb_stage(xq: torch.Tensor, xscales: torch.Tensor, qblk: QBlock,
               stage: str, ct: int, quant_out: bool,
               out_dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, ...]:
    """K8 twice: stage ``"a"`` (1) or ``"b"`` (2) of an MSRB block, its 3×3
    and 5×5 branches → (o3, o5, s3, s5) (``_run_msrb_stage``)."""
    on_cuda(xq)
    sb = qblk["sb1" if stage == "a" else "sb2"]
    outs = []
    for row, kk in ((0, 3), (1, 5)):
        outs.append(cistar.msrb_branch_int8(
            xq.contiguous(), xscales.contiguous(), qblk[f"w{kk}{stage}k"], sb,
            row, kk, ct, quant_out,
            torch.float32 if out_dtype is None else out_dtype))
    (o3, s3), (o5, s5) = outs
    return o3, o5, s3, s5


def _msrb_block(x: torch.Tensor, qblk: QBlock, cout_tile: int, stage
                ) -> torch.Tensor:
    nf = qblk["w3a"].shape[-1]
    ct = min(cout_tile, nf)
    if nf % ct:
        raise ValueError(f"cout_tile {ct} must divide the MSRB width {nf}")
    xq, xs = quantize_act(x)
    o3, o5, s3, s5 = stage(xq, xs, qblk, "a", ct, True, None)
    c3, c5, _, _ = stage(torch.cat([o3, o5], dim=-1),
                         torch.cat([s3, s5], dim=1), qblk, "b", ct, False,
                         x.dtype)
    cat2 = torch.cat([c3, c5], dim=-1).float()
    return (torch.matmul(cat2, qblk["w1x1"]) + qblk["b1x1"]).to(x.dtype)


def msrb_block_int8(x: torch.Tensor, qblk: QBlock, cout_tile: int = 128
                    ) -> torch.Tensor:
    """One MSRB block with both conv stages in int8 (K8, four launches on
    CUDA) and the 1×1 fuse in fp32 plain ops (``msrb_block_int8``): stage
    1 on ``x`` quantized per image, stage 2 on its two int8 outputs side by
    side with their tile scales as group scales. ``torch.matmul`` runs the
    fuse in full fp32 under PyTorch's default matmul precision, as XLA does
    in JAX. Returns ``x.dtype``."""
    return _msrb_block(x, qblk, cout_tile, msrb_stage)


def msrb_block_int8_plain(x: torch.Tensor, qblk: QBlock,
                          cout_tile: int = 128) -> torch.Tensor:
    """:func:`msrb_block_int8` with the plain K8 on any device."""
    def stage(xq, xscales, q, st, ct, quant_out, out_dtype):
        return msrb_stage_plain(xq, xscales, q[f"w3{st}"], q[f"w5{st}"],
                                q["sb1" if st == "a" else "sb2"], ct,
                                quant_out, out_dtype)
    return _msrb_block(x, qblk, cout_tile, stage)
