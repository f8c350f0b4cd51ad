"""K6 on the ``wgmma`` + TMA conv at a 64-byte K stage
(``csrc/wgmma_conv.cuh``, ``csrc/int8_atrous.cu``) on the CPU: which
stage each path's shapes take, from the Python mirror of the tile rule
(``kernels/wgmma_conv.py::kbytes``, ``kernels/int8_atrous.py::
conv_variant``; ``chip_smoke.py`` holds them to ``cistar_atrous_conv_variant``
on the card), a numpy model of the dilated box fetch at 64 bytes of K a
stage, and a model of K6's two passes (the branches as one K loop a tile,
each flushed at its last stage: first its IN sums, then its share of the
branch sum) against the plain version, JAX's emulation and the TPU kernel
in interpret mode.

The models follow ``wg_conv_kernel``: output tile m0 (128 pixels: whole
image rows, or 128 pixels of one row) reads tap (ky, kx) at rate r as the
TMA box at (x0 + kx·r − r, y0 + ky·r − r) of the unpadded input, zeros
where the box leaves the image, one K stage (64 channels of int8) at a
time; K6's passes (``wg_branch_kernel``) read the tile and a halo of the
largest rate as one box, and tap (ky, kx) of an MMA warpgroup's 64 pixels
(one image row) as the 64 consecutive halo pixels at the same offset. Each
branch's int32 accumulators go to an epilogue warpgroup, one thread a
channel: its sums add the tile's rows in order, and the tiles' sums are
added with atomics, in an order that changes from run to run (tile order
here). The CUDA kernels
themselves are compared with the plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_conv_tiles as conv_tiles
import test_torch_dilated_tiles as dilated_tiles
import test_torch_grouped_tiles as grouped_tiles
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu.ops.blocks import MultiAtrousConv as JaxMultiAtrousConv
from cistar_tpu_torch.core.convert import generator_from_jax
from cistar_tpu_torch.kernels import fused_conv as kf
from cistar_tpu_torch.kernels import int8_atrous as ka
from cistar_tpu_torch.kernels import int8_msrb as km
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.kernels import wgmma_conv
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import MultiAtrousConv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value
# chip_smoke.py's K6_REL / K6_ABS: one bf16 ulp + 1e-4
K6_REL, K6_ABS = BF16_ULP, 1e-4
RATES2 = (1, 2, 3, 4)


# --------------------------------------------------------------------------- #
# Which K stage each path's shapes take
# --------------------------------------------------------------------------- #
# K6's stage 2 of bilinear_content at 512² (64 → 128 on the subsampled
# (B, 64, 64) image), at the checked batch 4 and the timed 32
@pytest.mark.parametrize("n", [4, 32])
def test_k6_stage2_takes_the_64_byte_stage(n):
    assert not wgmma_conv.tile_ok(n, 64, 64, 64, 128, 1)
    assert wgmma_conv.tile_ok(n, 64, 64, 64, 128, 1,
                              kbytes=wgmma_conv.NARROW_KBYTES)
    assert wgmma_conv.kbytes(n, 64, 64, 64, 128, 1) == 64
    assert ka.conv_variant(n, 64, 64, 64, 128) == (ka.BN, 64)


# Every path shape of the other tile tests, with the BN its library's
# mirror answers there: each keeps the 128-byte stage (128 bytes wherever
# they divide Cin / groups), and its BN.
PATH_SHAPES = {
    **{f"K1 {k}": ("k1", (*s, s[-1]), 1, 3, 1, bn)
       for k, (s, bn) in conv_tiles.K1_SHAPES.items()},
    **{f"K3 {k}": ("k3", s, 2, 3, 1, bn)
       for k, (s, bn) in {"batch 8": ((8, 32, 32, 512, 512), 128),
                          "batch 64": ((64, 32, 32, 512, 512), 256),
                          "Cin 64": ((8, 32, 32, 64, 128), 128)}.items()},
    **{f"K7a {k}": ("k7a", (*s, s[-1]), 1, 3, 1, bn)
       for k, (s, bn) in dilated_tiles.K7A_SHAPES.items()},
    **{f"K5 batch {n}": ("k5", (n, 64, 64, 128, 128), 1, 3, 1, 128)
       for n in (4, 32)},
    **{f"K7b {k}": ("k7b", (n, h, w, c, c), 1, 3, c // ct, 128)
       for k, (n, h, w, c, ct) in grouped_tiles.K7B_SHAPES.items()},
    **{f"K8 {k}": ("k8", (n, h, w, cin, cout), 1, kk, g, 128)
       for k, (n, h, w, cin, cout, kk, g) in grouped_tiles.K8_SHAPES.items()},
}


def _library_variant(which, shape, kk, groups):
    n, h, w, cin, cout = shape
    if which in ("k1", "k7a"):
        return (kr.conv_variant if which == "k1" else kt.a_conv_variant)(
            n, h, w, cin)
    if which == "k3":
        return kf.conv_variant(n, h, w, cin, cout, True, True)
    if which == "k5":
        return ka.conv_variant(*shape)
    if which == "k7b":
        return kt.conv_variant(n, h, w, cin, groups)
    return km.conv_variant(n, h, w, cin, cout, kk, groups)


@pytest.mark.parametrize("label", sorted(PATH_SHAPES))
def test_path_shapes_keep_the_128_byte_stage(label):
    which, shape, elem, kk, groups, bn = PATH_SHAPES[label]
    assert wgmma_conv.kbytes(*shape, elem, kk, groups) == wgmma_conv.KBYTES
    want = (bn, wgmma_conv.KBYTES) if which == "k5" else bn
    assert _library_variant(which, shape, kk, groups) == want


# K6 at its path shapes takes the fused passes (the halo of rate 4 fits);
# the 256² stage 1 does not (off the wgmma conv)
@pytest.mark.parametrize("n", [4, 32])
def test_k6_stage2_keeps_its_branches_on_chip(n):
    assert ka.stage_fused(n, 64, 64, 64, 128, RATES2)
    assert not ka.stage_fused(n, 64, 64, 32, 64, RATES2)


def test_halo_rule_boundaries():
    # two rows of 64 pixels a tile: 72 x 10 pixels of halo at rate 4 (45 KB
    # a buffer), the largest rate that fits beside the B ring and the
    # accumulator buffer; a row of 128 or more pixels a tile needs 9 rows of
    # 136 pixels at rate 4
    ok = wgmma_conv.halo_ok
    assert ok(64, 64, 4) and ok(64, 64, 1) and ok(256, 64, 1)
    assert not ok(64, 64, 5)
    assert not ok(128, 64, 4) and not ok(256, 64, 4)
    assert not ok(32, 64, 4)       # a warpgroup's 64 pixels span 2 rows
    assert not ok(64, 128, 4)      # Cin is two K stages


def test_narrow_stage_rule_boundaries():
    kb = wgmma_conv.kbytes
    assert kb(2, 32, 32, 128, 128, 1) == 128     # 128 wherever it holds
    assert kb(2, 32, 32, 192, 128, 1) == 64      # 192 = 3 x 64 bytes
    assert kb(2, 32, 32, 32, 128, 1) == 0        # 32 bytes: neither stage
    assert kb(2, 32, 32, 32, 128, 2) == 64       # bf16, Cin 32
    assert kb(2, 64, 64, 64, 64, 1) == 0         # Cout 64 < 128
    assert kb(2, 64, 64, 512, 512, 1, 5, 8) == 64  # groups of 64 channels
    # K6's 256² stage 1 (32 → 64) stays off the wgmma conv
    assert ka.conv_variant(4, 64, 64, 32, 64) == (0, 0)


# --------------------------------------------------------------------------- #
# The dilated box fetch at 64 bytes of K a stage, modelled in numpy
# --------------------------------------------------------------------------- #
def _tiles(n, h, w):
    """(first pixel, image, y0, x0, rows, cols) of each 128-pixel tile."""
    bm = wgmma_conv.BM
    cols = min(w, bm)
    for m0 in range(0, n * h * w, bm):
        img, rem = divmod(m0, h * w)
        y0, x0 = divmod(rem, w)
        yield m0, img, y0, x0, bm // cols, cols


def _box_conv(xq, wk, r, ke):
    """int8 NHWC ``xq`` and (Cout, 9·Cin) ``wk`` → int32 (N·H·W, Cout) the
    way ``wg_conv_kernel`` computes it at dilation ``r``: tile by tile, the
    K loop tap by tap and ``ke`` channels a stage, int32 sums."""
    n, h, w, c = xq.shape
    assert c % ke == 0
    out = np.zeros((n * h * w, wk.shape[0]), np.int32)
    wt = wk.astype(np.int32)
    for m0, img, y0, x0, rows, cols in _tiles(n, h, w):
        acc = np.zeros((rows * cols, wk.shape[0]), np.int32)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            a = dilated_tiles._box(xq, img, y0 + ky * r - r, x0 + kx * r - r,
                                   rows, cols)
            a = a.reshape(rows * cols, c).astype(np.int32)
            for c0 in range(0, c, ke):
                acc += a[:, c0:c0 + ke] @ wt[:, tap * c + c0:tap * c + c0 + ke].T
        out[m0:m0 + rows * cols] = acc
    return out


# Shapes that meet the rule at the 64-byte stage only: whole rows a tile
# (W 16, 32) or 128 pixels of one row (W 256); rows of a tile and taps
# leave the image at the larger rates, whole boxes too.
@pytest.mark.parametrize("shape", [(1, 8, 16, 64), (2, 4, 32, 64),
                                   (1, 2, 256, 64)])
@pytest.mark.parametrize("rate", RATES2)
def test_narrow_box_fetch_equals_plain_and_jax(shape, rate):
    n, h, w, c = shape
    cout = 128
    assert wgmma_conv.kbytes(n, h, w, c, cout, 1) == 64
    rng = np.random.RandomState(sum(shape) + rate)
    xq = rng.randint(-127, 128, shape).astype(np.int8)
    wq = rng.randint(-127, 128, (9, c, cout)).astype(np.int8)
    wk = wq.transpose(2, 0, 1).reshape(cout, 9 * c)   # the kernel's operand
    got = _box_conv(xq, wk, rate, wgmma_conv.NARROW_KBYTES).reshape(
        n, h, w, cout)
    plain = qi.conv3x3_dilated_s8_plain(torch.from_numpy(xq),
                                        torch.from_numpy(wq), rate)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, dilated_tiles._jax_dilated(xq, wq,
                                                                  rate))


def _halo_conv(xq, wk, r, hpad):
    """The same conv as K6's passes fetch it: per tile one box of the tile
    and hpad pixels a side (zeros outside the image), then tap (ky, kx) of
    each consumer warpgroup's 64 pixels (one image row) as the 64
    consecutive halo pixels at (prow + (ky-1)·r + hpad, pcol + (kx-1)·r +
    hpad)."""
    n, h, w, c = xq.shape
    out = np.zeros((n * h * w, wk.shape[0]), np.int32)
    wt = wk.astype(np.int32)
    for m0, img, y0, x0, rows, cols in _tiles(n, h, w):
        halo = dilated_tiles._box(xq, img, y0 - hpad, x0 - hpad, rows + 2 * hpad,
                                  cols + 2 * hpad).astype(np.int32)
        for cw in range(2):
            prow, pcol = divmod(64 * cw, cols)
            acc = np.zeros((64, wk.shape[0]), np.int32)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                hy, hx = prow + (ky - 1) * r + hpad, pcol + (kx - 1) * r + hpad
                acc += halo[hy, hx:hx + 64] @ wt[:, tap * c:(tap + 1) * c].T
            out[m0 + 64 * cw:m0 + 64 * cw + 64] = acc
    return out


# Shapes that K6's passes take (W 64: two rows a tile, one a warpgroup);
# the halo at rate 4 covers every rate, and the rows of a tile leave the
# image at rates ≥ 2
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (2, 2, 64, 64),
                                   (1, 8, 64, 64)])
@pytest.mark.parametrize("rate", RATES2)
def test_halo_fetch_equals_plain(shape, rate):
    n, h, w, c = shape
    cout = 128
    assert wgmma_conv.halo_ok(w, c, max(RATES2))
    rng = np.random.RandomState(sum(shape) + 10 * rate)
    xq = rng.randint(-127, 128, shape).astype(np.int8)
    wq = rng.randint(-127, 128, (9, c, cout)).astype(np.int8)
    wk = wq.transpose(2, 0, 1).reshape(cout, 9 * c)
    got = _halo_conv(xq, wk, rate, max(RATES2)).reshape(n, h, w, cout)
    plain = qi.conv3x3_dilated_s8_plain(torch.from_numpy(xq),
                                        torch.from_numpy(wq), rate)
    np.testing.assert_array_equal(got, plain.numpy())


# --------------------------------------------------------------------------- #
# K6's two passes, modelled in numpy float32
# --------------------------------------------------------------------------- #
def _column_sums(v, n, h, w):
    """Per image and column, the sum of (N·H·W, C) fp32 ``v`` in the
    kernel's order: the epilogue thread of a column adds the tile's 128
    rows in order from 0; the tiles' sums are added in tile order."""
    out = np.zeros((n, v.shape[1]), np.float32)
    for m0, img, *_ in _tiles(n, h, w):
        tile = np.zeros(v.shape[1], np.float32)
        for row in v[m0:m0 + wgmma_conv.BM]:
            tile = tile + row
        out[img] = out[img] + tile
    return out


def _k6_two_passes(xs, q, rates2, eps=qi.EPS):
    """K6 on the subsampled input ``xs`` (N, H, W, Cin) as the two passes
    compute it: fp32 (N, H, W, Cout)."""
    n, h, w, cin = xs.shape
    xq, xscale = (t.numpy() for t in qi.quantize_act(xs))
    xscale = xscale[:, 0].astype(np.float32)
    wbk, sb = q["wbk"].numpy(), q["sb"].numpy()
    cout = wbk.shape[1]
    img_of = np.repeat(np.arange(n), h * w)
    f = []
    for b, r in enumerate(rates2):      # the flush of branch b: its f
        acc = _halo_conv(xq, wbk[b], r, max(rates2))
        scale = xscale[img_of, None] * sb[2 * b][None, :]
        f.append(acc.astype(np.float32) * scale + sb[2 * b + 1][None, :])
    # pass A's sums, then in_stats_kernel's IN finalize (IEEE sqrt, divide)
    hw = np.float32(h * w)
    stats = []
    for fb in f:
        mu = _column_sums(fb, n, h, w) / hw
        msq = _column_sums(fb * fb, n, h, w) / hw
        var = np.maximum(msq - mu * mu, np.float32(0))
        stats.append((mu, np.float32(1) / np.sqrt(var + np.float32(eps))))
    # pass B: v += relu((f_b - mean_b) * rsig_b), in branch order from 0
    v = np.zeros((n * h * w, cout), np.float32)
    for fb, (mu, rs) in zip(f, stats):
        v = v + np.maximum((fb - mu[img_of]) * rs[img_of], np.float32(0))
    return v.reshape(n, h, w, cout)


@pytest.fixture(scope="module")
def k6_stage():
    """A stride-2 MultiAtrousConv 64 → 128 from JAX's init (biases bumped),
    and its input (2, 64, 128, 64): K6's output (2, 32, 64, 128) is 16
    tiles of two rows an image, and takes the fused passes (W a multiple of
    64; the bilinear tests' 16 × 16 stage output would not)."""
    rng = np.random.RandomState(10)
    xs_full = (0.5 * rng.randn(2, 64, 128, 64)).astype(np.float32)
    jst = JaxMultiAtrousConv(128, stride=2)
    sp = jst.init(jax.random.PRNGKey(3), jnp.asarray(xs_full))["params"]
    sp = jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.randn(*a.shape).astype(np.float32),
        sp)
    st = MultiAtrousConv(64, 128, stride=2)
    st.load_state_dict(generator_from_jax(sp))
    tqs = qi.quantize_multi_atrous_stage(st.eval())
    jqs = qp.quantize_multi_atrous_stage(sp)
    np.testing.assert_array_equal(np.asarray(jqs["wbq"]), tqs["wbq"].numpy())
    xs = np.ascontiguousarray(xs_full[:, ::2, ::2])
    assert ka.conv_variant(*xs.shape, 128) == (ka.BN, 64)
    assert ka.stage_fused(*xs.shape, 128, RATES2)
    return dict(xs=xs, jqs=jqs, tqs=tqs)


def test_k6_two_passes_within_one_ulp_of_plain(k6_stage):
    # bf16 carrier: the plain version sums its statistics in another order
    # and takes rsqrt, so a bf16 output may round the other way (3 of the
    # 524,288 did here)
    xs = torch.from_numpy(k6_stage["xs"]).bfloat16()
    got = torch.from_numpy(_k6_two_passes(xs, k6_stage["tqs"], RATES2)) \
        .bfloat16().float()
    ref = qi.multi_atrous_stage_int8_plain(xs, k6_stage["tqs"], RATES2).float()
    assert tuple(got.shape) == (2, 32, 64, 128)
    over = ((got - ref).abs() - K6_REL * ref.abs()).max().item()
    assert over <= K6_ABS


@pytest.mark.parametrize("ref", ["emulation", "interpret"])
def test_k6_two_passes_match_jax(k6_stage, ref):
    # fp32: the order of the fp32 IN sums only (1.4e-6 measured)
    xs, jqs = k6_stage["xs"], k6_stage["jqs"]
    got = _k6_two_passes(torch.from_numpy(xs), k6_stage["tqs"], RATES2)
    if ref == "emulation":
        want = qp._multi_atrous_stage_int8_emulate(jnp.asarray(xs), jqs,
                                                   RATES2)
    else:
        want = qp._run_multi_atrous_stage_int8(jnp.asarray(xs), jqs, RATES2,
                                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
