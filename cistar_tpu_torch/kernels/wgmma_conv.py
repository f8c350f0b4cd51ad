"""The tile rule of the ``wgmma`` + TMA 3×3 conv (``csrc/wgmma_conv.cuh``),
mirrored in Python so that the CPU tests and ``chip_smoke.py`` can show
which conv a shape takes.

K1 / K2 (``kernels/int8_resblock.py``) and K3 (``kernels/fused_conv.py``)
run it where :func:`tile_ok` holds; their C libraries answer the same
question through ``cistar_resblock_conv_variant`` and
``cistar_conv3x3_in_act_variant``.
"""

from __future__ import annotations

BM = 128      # output pixels per block
KBYTES = 128  # bytes of K per pipeline stage (one 128-byte swizzle row)
SMS = 132     # SMs of an H100 SXM, for the choice of BN


def tile_ok(n: int, h: int, w: int, cin: int, cout: int, elem: int) -> bool:
    """``wg_tile_ok``: a tile is whole image rows (W divides 128) or 128
    pixels of one row (128 divides W) of one image (H·W % 128 == 0); a K
    stage of 128 bytes lies in one tap; Cout % 128 == 0. ``elem``: bytes of
    one operand value (1 for int8, 2 for bf16)."""
    rows = (w <= BM and BM % w == 0) or w % BM == 0
    return (n > 0 and h >= 2 and w >= 2 and rows and (h * w) % BM == 0
            and (cin * elem) % KBYTES == 0 and cout % 128 == 0)


def block_n(n: int, h: int, w: int, cout: int) -> int:
    """``wg_bn``: 256 output channels a block where Cout allows it and the
    grid keeps 2 blocks per SM, else 128."""
    tiles = n * h * w // BM
    return 256 if cout % 256 == 0 and tiles * (cout // 256) >= 2 * SMS \
        else 128


def variant(n: int, h: int, w: int, cin: int, cout: int, elem: int) -> int:
    """The BN of the ``wgmma`` conv at this shape, or 0 where the rule does
    not hold."""
    return block_n(n, h, w, cout) if tile_ok(n, h, w, cin, cout, elem) else 0
