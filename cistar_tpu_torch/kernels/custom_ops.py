"""The port's kernels as ``torch.library`` custom ops (namespace ``cistar``).

Each block-level kernel entry is one op, so that ``torch.export`` can trace
a forward that runs it: the tracer sees the op and its ``register_fake``
shape function, not the ``ctypes`` call behind it. Every op has two
implementations, and the dispatcher picks one by the device of its
tensors, which is the rule of :func:`cistar_tpu_torch.device.on_cuda`:

  * ``cuda``: the wrapper of :mod:`cistar_tpu_torch.kernels` (it checks
    its arguments, allocates outputs and workspace, launches on PyTorch's
    current stream, counts the launch, and raises on what the kernel does
    not take);
  * ``cpu``: the plain PyTorch version of :mod:`cistar_tpu_torch.ops`.

Any other device has no implementation and raises. The ops take the
kernels' operands: the weights as the CUDA conv's (Cout, taps·Cin) GEMM
operand (``w*k``), from which the CPU implementation takes the plain
version's layout by a reshape of the same int8 values, so both
implementations read one set of tensors.

  ==============================  =====  ================================
  op                              id     kernel wrapper
  ==============================  =====  ================================
  ``resblock_int8_bf16io``        K1     ``int8_resblock`` (``bn``: K1-bn)
  ``resblock_int8``               K2     ``int8_resblock``
  ``atrous_resblock_int8``        K5     ``int8_atrous``
  ``multi_atrous_stage_int8``     K6     ``int8_atrous``
  ``resblock_int8_tiled_a`` /     K7a /  ``int8_tiled`` (``bn``: the
  ``resblock_int8_tiled_b``       K7b    bn forms)
  ``msrb_branch_int8``            K8     ``int8_msrb``
  ``conv3x3_in_act``              K3     ``fused_conv``
  ``in_act``                      K4     ``in_act``
  ``head_cout1``                  K9     ``head_cout1``
  ``conv7x7s2_bf16``              K10    ``conv_s2``
  ==============================  =====  ================================

:data:`KERNEL_IDS` maps each op's name to its id.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from cistar_tpu_torch.kernels import (conv_s2, fused_conv, head_cout1,
                                      in_act, int8_atrous, int8_msrb,
                                      int8_resblock, int8_tiled)

KERNEL_IDS = {"resblock_int8_bf16io": "K1", "resblock_int8": "K2",
              "atrous_resblock_int8": "K5", "multi_atrous_stage_int8": "K6",
              "resblock_int8_tiled_a": "K7a", "resblock_int8_tiled_b": "K7b",
              "msrb_branch_int8": "K8", "conv3x3_in_act": "K3",
              "in_act": "K4", "head_cout1": "K9", "conv7x7s2_bf16": "K10"}

Pair = Tuple[torch.Tensor, torch.Tensor]


def _taps(wk: torch.Tensor, kk: int) -> torch.Tensor:
    """(Cout, kk²·Cin) GEMM operand → the plain versions' (kk², Cin, Cout)
    taps, the same values."""
    cout = wk.shape[0]
    return wk.reshape(cout, kk * kk, -1).permute(1, 2, 0)


def _branch_taps(wbk: torch.Tensor) -> torch.Tensor:
    """(4, Cout, 9·Cin) → (4, 9, Cin, Cout)."""
    return torch.stack([_taps(w, 3) for w in wbk])


def _plain():
    # the plain versions import this module's package; bound at call time
    from cistar_tpu_torch.ops import fused, quant_int8
    return quant_int8, fused


def _op(name: str, fake, cpu, cuda) -> None:
    """Register ``cistar::name`` with its fake, CPU and CUDA functions (the
    schema from ``cpu``'s annotations); callers reach it as
    ``torch.ops.cistar.<name>``."""
    op = torch.library.custom_op(f"cistar::{name}", cpu, mutates_args=(),
                                 device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)


# --------------------------------------------------------------------------- #
# K1 / K2
# --------------------------------------------------------------------------- #
def _k1_cpu(hx: torch.Tensor, w1k: torch.Tensor, w2k: torch.Tensor,
            sb: torch.Tensor, eps: float, bn: bool) -> torch.Tensor:
    q, _ = _plain()
    return q.resblock_int8_bf16io_plain(
        hx, {"w1q": _taps(w1k, 3), "w2q": _taps(w2k, 3), "sb": sb}, bn)


def _k1_cuda(hx, w1k, w2k, sb, eps, bn):
    return int8_resblock.resblock_int8_bf16io(
        hx, {"w1k": w1k, "w2k": w2k, "sb": sb}, eps, bn)


_op(
    "resblock_int8_bf16io",
    lambda hx, w1k, w2k, sb, eps, bn: torch.empty_like(hx), _k1_cpu,
    _k1_cuda)


def _k2_cpu(hq: torch.Tensor, hs: torch.Tensor, w1k: torch.Tensor,
            w2k: torch.Tensor, sb: torch.Tensor, eps: float) -> Pair:
    q, _ = _plain()
    return q.resblock_int8_plain(
        hq, hs, {"w1q": _taps(w1k, 3), "w2q": _taps(w2k, 3), "sb": sb})


def _k2_cuda(hq, hs, w1k, w2k, sb, eps):
    return int8_resblock.resblock_int8(
        hq, hs, {"w1k": w1k, "w2k": w2k, "sb": sb}, eps)


_op(
    "resblock_int8",
    lambda hq, hs, w1k, w2k, sb, eps: (
        torch.empty_like(hq),
        hq.new_empty((hq.shape[0], 1), dtype=torch.float32)),
    _k2_cpu, _k2_cuda)


# --------------------------------------------------------------------------- #
# K5 / K6
# --------------------------------------------------------------------------- #
def _k5_cpu(hx: torch.Tensor, wbk: torch.Tensor, wck: torch.Tensor,
            sb: torch.Tensor, rates: List[int], eps: float) -> torch.Tensor:
    q, _ = _plain()
    return q.atrous_resblock_int8_plain(
        hx, {"wbq": _branch_taps(wbk), "wcq": _taps(wck, 3), "sb": sb},
        rates)


def _k5_cuda(hx, wbk, wck, sb, rates, eps):
    return int8_atrous.atrous_resblock_int8(
        hx, {"wbk": wbk, "wck": wck, "sb": sb}, rates, eps)


_op(
    "atrous_resblock_int8",
    lambda hx, wbk, wck, sb, rates, eps: torch.empty_like(hx),
    _k5_cpu, _k5_cuda)


def _k6_cpu(x: torch.Tensor, wbk: torch.Tensor, sb: torch.Tensor,
            rates2: List[int], eps: float) -> torch.Tensor:
    q, _ = _plain()
    return q.multi_atrous_stage_int8_plain(
        x[:, ::2, ::2], {"wbq": _branch_taps(wbk), "sb": sb}, rates2)


def _k6_cuda(x, wbk, sb, rates2, eps):
    return int8_atrous.multi_atrous_stage_int8(
        x, {"wbk": wbk, "sb": sb}, rates2, eps)


def _k6_fake(x, wbk, sb, rates2, eps):
    n, h, w, _ = x.shape
    return x.new_empty((n, (h + 1) // 2, (w + 1) // 2, wbk.shape[1]))


_op("multi_atrous_stage_int8", _k6_fake, _k6_cpu, _k6_cuda)


# --------------------------------------------------------------------------- #
# K7a / K7b
# --------------------------------------------------------------------------- #
def _k7a_cpu(hx: torch.Tensor, w1k: torch.Tensor, sb: torch.Tensor, ct: int,
             eps: float, bn: bool) -> Pair:
    q, _ = _plain()
    return q.resblock_tiled_a_plain(hx, {"w1q": _taps(w1k, 3), "sb": sb}, ct,
                                    bn)


def _k7a_cuda(hx, w1k, sb, ct, eps, bn):
    return int8_tiled.resblock_int8_tiled_a(hx, {"w1k": w1k, "sb": sb}, ct,
                                            eps, bn)


_op(
    "resblock_int8_tiled_a",
    lambda hx, w1k, sb, ct, eps, bn: (
        hx.new_empty(hx.shape, dtype=torch.int8),
        hx.new_empty((hx.shape[0], hx.shape[3] // ct), dtype=torch.float32)),
    _k7a_cpu, _k7a_cuda)


def _k7b_cpu(rq: torch.Tensor, rs: torch.Tensor, hx: torch.Tensor,
             w2k: torch.Tensor, sb: torch.Tensor, ct: int, eps: float,
             bn: bool) -> torch.Tensor:
    q, _ = _plain()
    return q.resblock_tiled_b_plain(rq, rs, hx,
                                    {"w2q": _taps(w2k, 3), "sb": sb}, ct, bn)


def _k7b_cuda(rq, rs, hx, w2k, sb, ct, eps, bn):
    return int8_tiled.resblock_int8_tiled_b(rq, rs, hx,
                                            {"w2k": w2k, "sb": sb}, ct, eps,
                                            bn)


_op(
    "resblock_int8_tiled_b",
    lambda rq, rs, hx, w2k, sb, ct, eps, bn: torch.empty_like(hx),
    _k7b_cpu, _k7b_cuda)


# --------------------------------------------------------------------------- #
# K8
# --------------------------------------------------------------------------- #
def _k8_cpu(xq: torch.Tensor, xscales: torch.Tensor, wk: torch.Tensor,
            sb: torch.Tensor, sb_row: int, kk: int, ct: int, quant_out: bool,
            out_dtype: torch.dtype) -> Pair:
    q, _ = _plain()
    return q.msrb_branch_plain(xq, xscales, _taps(wk, kk), sb, sb_row, kk, ct,
                               quant_out, out_dtype)


def _k8_cuda(xq, xscales, wk, sb, sb_row, kk, ct, quant_out, out_dtype):
    return int8_msrb.msrb_branch_int8(xq, xscales, wk, sb, sb_row, kk, ct,
                                      quant_out, out_dtype)


def _k8_fake(xq, xscales, wk, sb, sb_row, kk, ct, quant_out, out_dtype):
    n, h, w, _ = xq.shape
    cout = wk.shape[0]
    return (xq.new_empty((n, h, w, cout),
                         dtype=torch.int8 if quant_out else out_dtype),
            xq.new_empty((n, cout // ct), dtype=torch.float32))


_op("msrb_branch_int8", _k8_fake, _k8_cpu, _k8_cuda)


# --------------------------------------------------------------------------- #
# K3 / K4 / K9
# --------------------------------------------------------------------------- #
def _k3_cpu(x: torch.Tensor, wk: torch.Tensor, bias: Optional[torch.Tensor],
            relu: bool, residual: Optional[torch.Tensor], reflect: bool,
            eps: float) -> torch.Tensor:
    _, f = _plain()
    w = wk.reshape(wk.shape[0], 3, 3, -1).permute(0, 3, 1, 2)
    return f.fused_conv3x3_in_act_plain(
        x, w, bias, "relu" if relu else "none", residual,
        "reflect" if reflect else "zero", eps)


def _k3_cuda(x, wk, bias, relu, residual, reflect, eps):
    if bias is None:
        bias = torch.zeros(wk.shape[0], device=x.device)
    return fused_conv.conv3x3_in_act(x, wk, bias, relu, residual, reflect,
                                     eps)


_op(
    "conv3x3_in_act",
    lambda x, wk, bias, relu, residual, reflect, eps: x.new_empty(
        (*x.shape[:3], wk.shape[0])),
    _k3_cpu, _k3_cuda)


def _k4_cpu(x: torch.Tensor, act: str, slope: float,
            residual: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    _, f = _plain()
    return f.fused_instance_norm_act_plain(x, act, eps, slope, residual)


def _k4_cuda(x, act, slope, residual, eps):
    return in_act.in_act(x, act, slope, residual, eps)


_op("in_act", lambda x, act, slope, residual, eps: torch.empty_like(x),
    _k4_cpu, _k4_cuda)


def _k9_cpu(x: torch.Tensor, wt: torch.Tensor, bias: Optional[torch.Tensor],
            tanh: bool, pre_in: bool, eps: float) -> torch.Tensor:
    _, f = _plain()
    w = wt.t().reshape(1, -1, 7, 7)
    return f.conv2d_reflect_cout1_plain(x, w, bias,
                                        "tanh" if tanh else "none", pre_in,
                                        eps)


def _k9_cuda(x, wt, bias, tanh, pre_in, eps):
    return head_cout1.head_cout1(x, wt, bias, tanh, pre_in, eps)


_op(
    "head_cout1",
    lambda x, wt, bias, tanh, pre_in, eps: x.new_empty((*x.shape[:3], 1)),
    _k9_cpu, _k9_cuda)


# --------------------------------------------------------------------------- #
# K10
# --------------------------------------------------------------------------- #
def _k10_cpu(x: torch.Tensor, wk: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    from cistar_tpu_torch.ops import nn as tnn
    cout = wk.shape[0]
    w = wk.reshape(cout, conv_s2.KK, conv_s2.KK, -1).permute(0, 3, 1, 2)
    return tnn.conv2d(x, w.contiguous(), bias, stride=conv_s2.STRIDE,
                      padding=conv_s2.PAD)


def _k10_fake(x, wk, bias):
    n, h, w, _ = x.shape
    return x.new_empty((n, (h + 1) // 2, (w + 1) // 2, wk.shape[0]))


_op("conv7x7s2_bf16", _k10_fake, _k10_cpu, conv_s2.conv7x7s2_bf16)
