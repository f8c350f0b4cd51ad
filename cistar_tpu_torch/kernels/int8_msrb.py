"""Wrappers of the CUDA int8 MSRB branch (``csrc/int8_msrb.cu``).

  * :func:`conv_zero_grouped_s8` — the int8 zero-pad 3×3 / 5×5 conv, one
    int32 partial per input group out (the K loop of K8)
  * :func:`msrb_branch_int8` — K8 (``_msrb_branch_kernel``)
  * :func:`conv_variant` — which conv a shape takes (``wgmma_conv.py``'s
    rule), and :func:`conv_variant_card`, the library's own answer

Each takes CUDA tensors only and launches on PyTorch's current stream; the
CPU path is the plain version in :mod:`cistar_tpu_torch.ops.quant_int8`.
The library is built on the first call (:mod:`.build`). ``launches`` counts
the calls that launched each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from cistar_tpu_torch.kernels import build, wgmma_conv
from cistar_tpu_torch.kernels.build import (I, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"conv_zero_grouped_s8": 0, "msrb_branch_int8": 0}

_SIGS = {
    "cistar_msrb_workspace_bytes": ((I, I, I, I, I), ctypes.c_size_t),
    "cistar_msrb_conv_variant": ((I, I, I, I, I, I, I), I),
    "cistar_conv_zero_grouped_s8_acc": ((P, P, P, I, I, I, I, I, I, I, P), I),
    "cistar_msrb_branch_int8": (
        (P, P, I, P, P, P, I, I, I, P, P, P, I, I, I, I, I, I, P), I),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("int8_msrb"), _SIGS)


def conv_variant(n: int, h: int, w: int, cin: int, cout: int, kk: int,
                 groups: int) -> int:
    """The conv K8 and :func:`conv_zero_grouped_s8` run at (N, H, W, Cin →
    Cout, kk, groups): the BN of the ``wgmma`` conv (128), or 0 for the
    ``mma.sync`` one (``conv_s8_kernel``)."""
    return wgmma_conv.variant(n, h, w, cin, cout, 1, kk, groups,
                              grouped=True)


def conv_variant_card(n: int, h: int, w: int, cin: int, cout: int, kk: int,
                      groups: int) -> int:
    """:func:`conv_variant` as the built library answers it."""
    return _lib().cistar_msrb_conv_variant(n, h, w, cin, cout, kk, groups)


def _check_shape(n: int, h: int, w: int, cin: int, cout: int, groups: int,
                 kk: int) -> None:
    if kk not in (3, 5):
        raise ValueError(f"K8 takes 3×3 or 5×5 branches, got {kk}")
    if (groups <= 0 or cin % groups or (cin // groups) % 64 or cout % 128
            or (h * w) % 128 or h < 2 or w < 2):
        raise ValueError(
            "the int8 MSRB kernels take Cin / groups % 64 == 0, Cout % 128 "
            f"== 0 and H*W % 128 == 0; got (N,H,W) = {(n, h, w)}, Cin {cin} "
            f"in {groups} groups, Cout {cout}")


def conv_zero_grouped_s8(xq: torch.Tensor, wk: torch.Tensor, kk: int,
                         groups: int) -> torch.Tensor:
    """int8 (N,H,W,Cin) ``xq`` and (Cout, kk²·Cin) ``wk`` → int32 (groups,
    N,H,W,Cout): zero padding kk // 2, one partial per input group."""
    check_tensor(xq, "xq", torch.int8)
    n, h, w, cin = xq.shape
    cout = wk.shape[0]
    _check_shape(n, h, w, cin, cout, groups, kk)
    check_tensor(wk, "wk", torch.int8, (cout, kk * kk * cin))
    lib = _lib()
    acc = torch.empty((groups, n, h, w, cout), dtype=torch.int32,
                      device=xq.device)
    err = lib.cistar_conv_zero_grouped_s8_acc(
        xq.data_ptr(), wk.data_ptr(), acc.data_ptr(), n, h, w, cin, cout, kk,
        groups, stream())
    raise_on(err, "conv_zero_grouped_s8")
    launches["conv_zero_grouped_s8"] += 1
    return acc


def msrb_branch_int8(xq: torch.Tensor, xscales: torch.Tensor,
                     wk: torch.Tensor, sb: torch.Tensor, sb_row: int, kk: int,
                     ct: int, quant_out: bool, out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: int8 (N,H,W,Cin) ``xq`` with (N, gin) group scales ``xscales``,
    (Cout, kk²·Cin) ``wk``, the branch's [scale, bias] at rows 2·sb_row and
    2·sb_row + 1 of ``sb`` → (o, s): ``quant_out`` gives int8 ``o`` and
    (N, Cout/ct) scales ``s``; else ``o`` in ``out_dtype`` and ``s`` ones,
    as the TPU kernel gives them."""
    check_tensor(xq, "xq", torch.int8)
    n, h, w, cin = xq.shape
    gin = xscales.shape[-1]
    cout = wk.shape[0]
    _check_shape(n, h, w, cin, cout, gin, kk)
    if ct <= 0 or cout % ct or ct % 8 or cout // ct > 256:
        raise ValueError(f"tile {ct} must divide Cout {cout}, be a multiple "
                         "of 8 and leave at most 256 tiles")
    check_tensor(xscales, "xscales", torch.float32, (n, gin))
    check_tensor(wk, "wk", torch.int8, (cout, kk * kk * cin))
    check_tensor(sb, "sb", torch.float32, (4, cout))
    check_same_device(xq.device, xscales, wk, sb)
    if not quant_out and out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K8 writes bf16 or fp32, got {out_dtype}")
    lib = _lib()
    o = torch.empty((n, h, w, cout),
                    dtype=torch.int8 if quant_out else out_dtype,
                    device=xq.device)
    s = torch.ones((n, cout // ct), dtype=torch.float32, device=xq.device)
    ws = build.workspace(lib.cistar_msrb_workspace_bytes(n, h, w, cout, ct),
                         xq.device)
    err = lib.cistar_msrb_branch_int8(
        xq.data_ptr(), xscales.data_ptr(), gin, wk.data_ptr(),
        sb[2 * sb_row].data_ptr(), sb[2 * sb_row + 1].data_ptr(), kk,
        int(quant_out), int(out_dtype == torch.bfloat16), o.data_ptr(),
        s.data_ptr(), ws.data_ptr(), n, h, w, cin, cout, ct, stream())
    raise_on(err, "msrb_branch_int8")
    launches["msrb_branch_int8"] += 1
    return o, s
