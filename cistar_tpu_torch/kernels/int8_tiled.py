"""Wrappers of the CUDA cout-tiled int8 residual block (``csrc/int8_tiled.cu``).

  * :func:`conv3x3_reflect_grouped_s8` — the int8 reflect-pad-1 3×3 conv,
    one int32 partial per input group out (the K loop of K7b)
  * :func:`resblock_int8_tiled_a` — K7a (``_resblock_a_kernel``)
  * :func:`resblock_int8_tiled_b` — K7b (``_resblock_b_kernel``)
  * :func:`conv_variant` — which conv K7b takes at a shape (``wgmma_conv.py``'s
    rule), and :func:`conv_variant_card`, the library's own answer
  * :func:`a_conv_variant` / :func:`a_conv_variant_card` — the same for
    K7a's conv 1 (K1's rule: BN 128 or 256)

Both take ``bn=True`` for their BatchNorm form, counted as
``resblock_int8_tiled_a_bn`` / ``resblock_int8_tiled_b_bn``.

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
from cistar_tpu_torch.kernels.build import (I, F, P, check_same_device,
                                            check_tensor, raise_on, stream)

launches: Dict[str, int] = {"conv3x3_reflect_grouped_s8": 0,
                            "resblock_int8_tiled_a": 0,
                            "resblock_int8_tiled_b": 0,
                            "resblock_int8_tiled_a_bn": 0,
                            "resblock_int8_tiled_b_bn": 0}

_SIGS = {
    "cistar_tiled_workspace_bytes": ((I, I, I, I), ctypes.c_size_t),
    "cistar_tiled_conv_variant": ((I, I, I, I, I), I),
    "cistar_tiled_a_conv_variant": ((I, I, I, I), I),
    "cistar_conv3x3_reflect_grouped_s8_acc": ((P, P, P, P, I, I, I, I, I, P), I),
    "cistar_resblock_tiled_a": (
        (P, I, P, P, P, P, P, I, I, I, I, I, F, I, P), I),
    "cistar_resblock_tiled_b": (
        (P, P, P, P, P, I, P, P, I, I, I, I, I, F, I, P), I),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind(build.load("int8_tiled"), _SIGS)


def conv_variant(n: int, h: int, w: int, c: int, groups: int) -> int:
    """The conv K7b and :func:`conv3x3_reflect_grouped_s8` run at (N, H, W,
    C) in ``groups`` input groups: the BN of the ``wgmma`` conv (128), or 0
    for the ``mma.sync`` one (``conv_s8_kernel``)."""
    return wgmma_conv.variant(n, h, w, c, c, 1, 3, groups, grouped=True)


def conv_variant_card(n: int, h: int, w: int, c: int, groups: int) -> int:
    """:func:`conv_variant` as the built library answers it."""
    return _lib().cistar_tiled_conv_variant(n, h, w, c, groups)


def a_conv_variant(n: int, h: int, w: int, c: int) -> int:
    """The conv K7a runs at (N, H, W, C), K1's conv 1 on the reflect-padded
    int8 input: the BN of the ``wgmma`` conv (128 or 256), or 0 for the
    ``mma.sync`` one (``conv_s8_kernel``)."""
    return wgmma_conv.variant(n, h, w, c, c, 1)


def a_conv_variant_card(n: int, h: int, w: int, c: int) -> int:
    """:func:`a_conv_variant` as the built library answers it."""
    return _lib().cistar_tiled_a_conv_variant(n, h, w, c)


def _check_shape(n: int, h: int, w: int, c: int, ct: int) -> None:
    if (ct <= 0 or c % ct or ct % 64 or c % 128 or c // ct > 256
            or (h * w) % 128 or h < 2 or w < 2):
        raise ValueError(
            "the tiled int8 res-block kernels take C % 128 == 0, a tile ct "
            "that divides C with ct % 64 == 0 and C / ct <= 256, and "
            f"H*W % 128 == 0; got (N,H,W,C) = {(n, h, w, c)}, ct {ct}")


def _check_carrier(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes a bf16 or fp32 carrier, got {x.dtype}")
    check_tensor(x, "hx", x.dtype)


def _workspace(lib, n: int, h: int, w: int, c: int, device) -> torch.Tensor:
    return build.workspace(lib.cistar_tiled_workspace_bytes(n, h, w, c),
                           device)


def conv3x3_reflect_grouped_s8(xq: torch.Tensor, wk: torch.Tensor,
                               groups: int) -> torch.Tensor:
    """int8 (N,H,W,C) ``xq`` and (C, 9·C) ``wk`` → int32 (groups, N,H,W,C):
    the partial sum of each group of C / groups input channels."""
    check_tensor(xq, "xq", torch.int8)
    n, h, w, c = xq.shape
    _check_shape(n, h, w, c, c // groups)
    check_tensor(wk, "wk", torch.int8, (c, 9 * c))
    lib = _lib()
    acc = torch.empty((groups, n, h, w, c), dtype=torch.int32,
                      device=xq.device)
    xpad = torch.empty((n, h + 2, w + 2, c), dtype=torch.int8,
                       device=xq.device)
    err = lib.cistar_conv3x3_reflect_grouped_s8_acc(
        xq.data_ptr(), wk.data_ptr(), acc.data_ptr(), xpad.data_ptr(), n, h,
        w, c, groups, stream())
    raise_on(err, "conv3x3_reflect_grouped_s8")
    launches["conv3x3_reflect_grouped_s8"] += 1
    return acc


def resblock_int8_tiled_a(hx: torch.Tensor, qblk, ct: int, eps: float,
                          bn: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7a: bf16 or fp32 (N,H,W,C) carrier → int8 relu(IN(conv 1)) (N,H,W,C)
    and its (N, C/ct) per-(image, tile) scales. ``bn``: relu(conv 1) with
    the BatchNorm folded into ``sb``."""
    _check_carrier(hx, "K7a")
    n, h, w, c = hx.shape
    _check_shape(n, h, w, c, ct)
    w1k, sb = qblk["w1k"], qblk["sb"]
    check_tensor(w1k, "w1k", torch.int8, (c, 9 * c))
    check_tensor(sb, "sb", torch.float32, (4, c))
    check_same_device(hx.device, w1k, sb)
    lib = _lib()
    rq = torch.empty((n, h, w, c), dtype=torch.int8, device=hx.device)
    rs = torch.empty((n, c // ct), dtype=torch.float32, device=hx.device)
    ws = _workspace(lib, n, h, w, c, hx.device)
    err = lib.cistar_resblock_tiled_a(
        hx.data_ptr(), int(hx.dtype == torch.bfloat16), w1k.data_ptr(),
        sb.data_ptr(), rq.data_ptr(), rs.data_ptr(), ws.data_ptr(),
        n, h, w, c, ct, eps, int(bn), stream())
    name = "resblock_int8_tiled_a_bn" if bn else "resblock_int8_tiled_a"
    raise_on(err, name)
    launches[name] += 1
    return rq, rs


def resblock_int8_tiled_b(rq: torch.Tensor, rs: torch.Tensor,
                          hx: torch.Tensor, qblk, ct: int, eps: float,
                          bn: bool = False) -> torch.Tensor:
    """K7b: K7a's ``rq`` / ``rs`` and the block input ``hx`` (the skip) →
    the block output in ``hx.dtype``. ``bn``: conv 2 with the BatchNorm
    folded into ``sb``, no IN."""
    _check_carrier(hx, "K7b")
    n, h, w, c = hx.shape
    _check_shape(n, h, w, c, ct)
    check_tensor(rq, "rq", torch.int8, (n, h, w, c))
    check_tensor(rs, "rs", torch.float32, (n, c // ct))
    w2k, sb = qblk["w2k"], qblk["sb"]
    check_tensor(w2k, "w2k", torch.int8, (c, 9 * c))
    check_tensor(sb, "sb", torch.float32, (4, c))
    check_same_device(hx.device, rq, rs, w2k, sb)
    lib = _lib()
    out = torch.empty_like(hx)
    ws = _workspace(lib, n, h, w, c, hx.device)
    err = lib.cistar_resblock_tiled_b(
        rq.data_ptr(), rs.data_ptr(), w2k.data_ptr(), sb.data_ptr(),
        hx.data_ptr(), int(hx.dtype == torch.bfloat16), out.data_ptr(),
        ws.data_ptr(), n, h, w, c, ct, eps, int(bn), stream())
    name = "resblock_int8_tiled_b_bn" if bn else "resblock_int8_tiled_b"
    raise_on(err, name)
    launches[name] += 1
    return out
