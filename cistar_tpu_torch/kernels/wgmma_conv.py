"""The tile rule of the ``wgmma`` + TMA conv (``csrc/wgmma_conv.cuh``),
mirrored in Python so that the CPU tests and ``chip_smoke.py`` can show
which conv a shape takes.

K1 / K2 (``kernels/int8_resblock.py``), K3 (``kernels/fused_conv.py``) and
K7a (``kernels/int8_tiled.py``) run its 3×3 form at the BN of
:func:`block_n`; K7b (``kernels/int8_tiled.py``) and K8
(``kernels/int8_msrb.py``) its grouped form (3×3 or 5×5 taps, input
groups) at BN :data:`GROUPED_BN`; K5 (``kernels/int8_atrous.py``) its
dilated zero-pad and reflect 3×3 forms at BN 128; each where
:func:`tile_ok` holds, which does not depend on the dilation. Their C
libraries answer the same question through ``cistar_resblock_conv_variant``,
``cistar_conv3x3_in_act_variant``, ``cistar_tiled_a_conv_variant``,
``cistar_tiled_conv_variant``, ``cistar_msrb_conv_variant`` and
``cistar_atrous_conv_variant``.
"""

from __future__ import annotations

BM = 128      # output pixels per block
KBYTES = 128  # bytes of K per pipeline stage (one 128-byte swizzle row)
SMS = 132     # SMs of an H100 SXM, for the choice of BN
# BN of the grouped convs: 64 int32 accumulators and 64 fp32 group sums a
# consumer thread (BN 256 would need 256 registers for them alone)
GROUPED_BN = 128


def tile_ok(n: int, h: int, w: int, cin: int, cout: int, elem: int,
            kk: int = 3, groups: int = 1) -> bool:
    """``wg_tile_ok``: a tile is whole image rows (W divides 128) or 128
    pixels of one row (128 divides W) of one image (H·W % 128 == 0); 3×3 or
    5×5 taps; a K stage of 128 bytes lies in one tap of one input group
    (128 bytes divide Cin / groups); Cout % 128 == 0. ``elem``: bytes of
    one operand value (1 for int8, 2 for bf16)."""
    rows = (w <= BM and BM % w == 0) or w % BM == 0
    return (n > 0 and h >= 2 and w >= 2 and rows and (h * w) % BM == 0
            and kk in (3, 5) and groups > 0 and cin % groups == 0
            and (cin // groups * elem) % KBYTES == 0 and cout % 128 == 0)


def block_n(n: int, h: int, w: int, cout: int) -> int:
    """``wg_bn``: 256 output channels a block where Cout allows it and the
    grid keeps 2 blocks per SM, else 128."""
    tiles = n * h * w // BM
    return 256 if cout % 256 == 0 and tiles * (cout // 256) >= 2 * SMS \
        else 128


def variant(n: int, h: int, w: int, cin: int, cout: int, elem: int,
            kk: int = 3, groups: int = 1, grouped: bool = False) -> int:
    """The BN of the ``wgmma`` conv at this shape, or 0 where the rule does
    not hold. ``grouped``: the libraries whose K loop runs group by group
    (K7b, K8 and their RAW entries), which take :data:`GROUPED_BN`."""
    if not tile_ok(n, h, w, cin, cout, elem, kk, groups):
        return 0
    return GROUPED_BN if grouped else block_n(n, h, w, cout)
