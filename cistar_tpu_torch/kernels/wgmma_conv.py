"""The tile rule of the ``wgmma`` + TMA conv (``csrc/wgmma_conv.cuh``),
mirrored in Python so that the CPU tests and ``chip_smoke.py`` can show
which conv a shape takes.

K1 / K2 (``kernels/int8_resblock.py``), K3 (``kernels/fused_conv.py``) and
K7a (``kernels/int8_tiled.py``) run its 3×3 form at the BN of
:func:`block_n`; K7b (``kernels/int8_tiled.py``) and K8
(``kernels/int8_msrb.py``) its grouped form (3×3 or 5×5 taps, input
groups) at BN :data:`GROUPED_BN`; K5 and K6 (``kernels/int8_atrous.py``)
its dilated zero-pad and reflect 3×3 forms at BN 128, at the K stage of
:func:`kbytes` (64 bytes for K6's 64 input channels); each where
:func:`tile_ok` holds, which does not depend on the dilation. K10
(``kernels/conv_s2.py``) runs its 7×7 stride-2 bf16 form under a rule of
its own (``conv_s2.shape_ok``; its BN: ``conv_s2.variant_card``). Only the
atrous library builds the 64-byte stage: the others keep 128. Their C
libraries answer the same question through ``cistar_resblock_conv_variant``,
``cistar_conv3x3_in_act_variant``, ``cistar_tiled_a_conv_variant``,
``cistar_tiled_conv_variant``, ``cistar_msrb_conv_variant`` and
``cistar_atrous_conv_variant``.
"""

from __future__ import annotations

BM = 128      # output pixels per block
KBYTES = 128  # bytes of K per pipeline stage (one 128-byte swizzle row)
NARROW_KBYTES = 64  # the narrow stage (64-byte swizzle), for Cin of 64 bytes
SMS = 132     # SMs of an H100 SXM, for the choice of BN
# BN of the grouped convs: 64 int32 accumulators and 64 fp32 group sums a
# consumer thread (BN 256 would need 256 registers for them alone)
GROUPED_BN = 128


def tile_ok(n: int, h: int, w: int, cin: int, cout: int, elem: int,
            kk: int = 3, groups: int = 1, kbytes: int = KBYTES) -> bool:
    """``wg_tile_ok``: a tile is whole image rows (W divides 128) or 128
    pixels of one row (128 divides W) of one image (H·W % 128 == 0); 3×3 or
    5×5 taps; a K stage of ``kbytes`` bytes lies in one tap of one input
    group (``kbytes`` divide Cin / groups); Cout % 128 == 0. ``elem``:
    bytes of one operand value (1 for int8, 2 for bf16)."""
    rows = (w <= BM and BM % w == 0) or w % BM == 0
    return (n > 0 and h >= 2 and w >= 2 and rows and (h * w) % BM == 0
            and kk in (3, 5) and groups > 0 and cin % groups == 0
            and (cin // groups * elem) % kbytes == 0 and cout % 128 == 0)


def kbytes(n: int, h: int, w: int, cin: int, cout: int, elem: int,
           kk: int = 3, groups: int = 1) -> int:
    """``wg_kbytes``: the bytes of K a stage of the ``wgmma`` conv takes at
    this shape: :data:`KBYTES` wherever :func:`tile_ok` holds at 128, else
    :data:`NARROW_KBYTES` where it holds at 64, else 0."""
    for kb in (KBYTES, NARROW_KBYTES):
        if tile_ok(n, h, w, cin, cout, elem, kk, groups, kb):
            return kb
    return 0


# K6's passes (``wg_branch_kernel``): Cin 64, BN 128, a ring of B stages,
# an accumulator buffer and each tile's input with a halo in one of two
# shared-memory buffers
SMEM_MAX = 232448   # dynamic shared memory a block may have
BRANCH_STAGES = 8   # WB_STAGES


def halo_ok(w: int, cin: int, hpad: int) -> bool:
    """``wb_shape_ok``: K6's passes take an image W wide with a halo of
    ``hpad`` pixels: Cin 64 (one 64-byte K stage a tap), each MMA
    warpgroup's 64 pixels in one image row (W % 64 == 0), the halo box at
    most 256 a side, and two halo buffers, the B ring, the accumulator
    buffer and the barriers within a block's shared memory."""
    if cin != NARROW_KBYTES or w % 64 or hpad < 0:
        return False
    cols = min(w, BM)
    box = (cols + 2 * hpad) * (BM // cols + 2 * hpad) * NARROW_KBYTES
    smem = (2 * -(-box // 1024) * 1024 + BRANCH_STAGES * 128 * NARROW_KBYTES
            + 128 * (BM + 4) * 4 + 1024 + (2 * BRANCH_STAGES + 6) * 8)
    return cols + 2 * hpad <= 256 and BM // cols + 2 * hpad <= 256 \
        and smem <= SMEM_MAX


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
