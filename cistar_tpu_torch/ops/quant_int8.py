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

On a CUDA tensor each launches the hand-written kernels of
:mod:`cistar_tpu_torch.kernels.int8_resblock` /
:mod:`~cistar_tpu_torch.kernels.int8_atrous` (or raises); on a CPU tensor it
runs the plain PyTorch version here, which mirrors the JAX emulation
(``_resblock_int8_bf16io_emulate``, ``_resblock_int8_emulate``,
``_atrous_resblock_int8_emulate``, ``_multi_atrous_stage_int8_emulate``) op
for op.

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
from typing import Dict, List, Sequence, Tuple, Union

import torch

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


def quantize_resnet_trunk(gen) -> List[QBlock]:
    """Quantize the residual blocks of a port ``ResnetGenerator``
    (``quantize_resnet_trunk``)."""
    return [quantize_resblock(b) for b in gen.res]


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


def _conv9_plain(xp: torch.Tensor, wq: torch.Tensor, h: int, w: int,
                 rate: int) -> torch.Tensor:
    """The 9 taps, ``rate`` apart, of a 3×3 conv over a padded int8 NHWC
    ``xp`` → int32 (N, h, w, Cout).

    Products are summed in float64, which holds every partial sum of
    ≤ 9·Cin products of int8 values exactly (|sum| < 2^53), in any order."""
    n, c = xp.shape[0], xp.shape[-1]
    acc = torch.zeros(n * h * w, wq.shape[-1], dtype=torch.float64,
                      device=xp.device)
    for k in range(9):
        dy, dx = (k // 3) * rate, (k % 3) * rate
        patch = xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
        acc += patch.double() @ wq[k].double()
    return acc.to(torch.int32).reshape(n, h, w, -1)


def conv3x3_reflect_s8_plain(xq: torch.Tensor, wq: torch.Tensor
                             ) -> torch.Tensor:
    """Reflect-pad-1 3×3 conv of int8 NHWC ``xq`` with (9, Cin, Cout) int8
    ``wq`` → int32 (N,H,W,Cout) (``_conv9_int8``)."""
    n, h, w, c = xq.shape
    xp = xq[:, _reflect_index(h, xq.device)][:, :, _reflect_index(w, xq.device)]
    return _conv9_plain(xp, wq, h, w, 1)


def conv3x3_dilated_s8_plain(xq: torch.Tensor, wq: torch.Tensor, rate: int
                             ) -> torch.Tensor:
    """Zero-pad 3×3 conv at dilation ``rate`` (padding ``rate``, same size)
    of int8 NHWC ``xq`` with (9, Cin, Cout) int8 ``wq`` → int32
    (N,H,W,Cout) (the branch conv of ``_atrous_resblock_int8_emulate``)."""
    n, h, w, c = xq.shape
    xp = xq.new_zeros(n, h + 2 * rate, w + 2 * rate, c)
    xp[:, rate:rate + h, rate:rate + w] = xq
    return _conv9_plain(xp, wq, h, w, rate)


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


def resblock_int8_bf16io_plain(hx: torch.Tensor, qblk: QBlock
                               ) -> torch.Tensor:
    """Plain K1, mirroring ``_resblock_int8_bf16io_emulate``."""
    n, h, w, c = hx.shape
    sb = qblk["sb"]
    hf = hx.float().reshape(n, h * w, c)
    hq, x_scale = _quant_rows(hf)
    f = _conv_dequant(hq.reshape(n, h, w, c), qblk["w1q"], x_scale,
                      sb[0], sb[1])
    rq, r_scale = _quant_rows(torch.relu(_inorm(f)))
    f2 = _conv_dequant(rq.reshape(n, h, w, c), qblk["w2q"], r_scale,
                       sb[2], sb[3])
    return (_inorm(f2) + hf).reshape(n, h, w, c).to(hx.dtype)


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


# --------------------------------------------------------------------------- #
# Dispatch: CPU tensors → plain version; CUDA tensors → the kernels.
# --------------------------------------------------------------------------- #
def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the int8 blocks run on cuda or cpu, got {x.device}")


def resblock_int8_bf16io(hx: torch.Tensor, qblk: QBlock) -> torch.Tensor:
    """K1: one int8 residual block with a full-precision carrier."""
    if _on_cuda(hx):
        from cistar_tpu_torch.kernels import int8_resblock
        return int8_resblock.resblock_int8_bf16io(hx.contiguous(), qblk, EPS)
    return resblock_int8_bf16io_plain(hx, qblk)


def resblock_int8(hq: torch.Tensor, hs: torch.Tensor, qblk: QBlock
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: one int8 residual block with an int8 carrier."""
    if _on_cuda(hq):
        from cistar_tpu_torch.kernels import int8_resblock
        return int8_resblock.resblock_int8(hq.contiguous(), hs.contiguous(),
                                           qblk, EPS)
    return resblock_int8_plain(hq, hs, qblk)


def resblock_chain_int8_bf16io(x: torch.Tensor, qblocks: Sequence[QBlock]
                               ) -> torch.Tensor:
    """Res-block chain through K1 (``resblock_chain_int8_bf16io``)."""
    for qblk in qblocks:
        x = resblock_int8_bf16io(x, qblk)
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
    if _on_cuda(hx):
        from cistar_tpu_torch.kernels import int8_atrous
        return int8_atrous.atrous_resblock_int8(hx.contiguous(), qblk, rates,
                                                EPS)
    return atrous_resblock_int8_plain(hx, qblk, rates)


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
    rates2 = tuple(r // 2 for r in rates)
    if _on_cuda(x):
        from cistar_tpu_torch.kernels import int8_atrous
        return int8_atrous.multi_atrous_stage_int8(x.contiguous(), qstage,
                                                   rates2, EPS)
    return multi_atrous_stage_int8_plain(x[:, ::2, ::2], qstage, rates2)
