"""The ``wgmma`` + TMA conv of K7a and K5 (``csrc/wgmma_conv.cuh``: K1's
reflect 3×3 conv for K7a; zero-pad 3×3 convs at a dilation for K5's four
branches) on the CPU: which conv each path's K7a / K7a-bn / K5 / K6 shapes
take (K6's 64-byte stage is modelled in ``test_torch_narrow_tiles.py``),
from the Python mirrors of the tile rule (``kernels/int8_tiled.py::
a_conv_variant`` and ``kernels/int8_atrous.py::conv_variant``, what
``cistar_tiled_a_conv_variant`` and ``cistar_atrous_conv_variant`` answer;
``chip_smoke.py`` holds each pair together on the card), and a numpy model
of the kernel's dilated box fetch against the plain dilated conv and JAX.

The model is the rule of ``wg_conv_kernel``'s producer: output tile m0
(128 pixels: whole image rows, or 128 pixels of one row) reads tap (ky, kx)
at rate r as the TMA box at (x0 + kx·r − r, y0 + ky·r − r) of the unpadded
input, zeros where the box leaves the image, one 128-channel K stage at a
time, taps in order. The CUDA kernels themselves are compared with the plain
versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu_torch.kernels import int8_atrous as ka
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.kernels import wgmma_conv
from cistar_tpu_torch.ops import quant_int8 as qi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Which conv each path's K7a / K5 shapes take
# --------------------------------------------------------------------------- #
# K7a (N, H, W, C) at each path's checked and timed batch and the BN of
# wg_bn there: pix2pixHD global (ct 256, a 1024-channel trunk at 32²),
# multiscale 512² (K7a-bn, ct 128) and local 1024² (ct 128), both with a
# (B, 64, 64, 512) trunk.
K7A_SHAPES = {
    "global batch 4": ((4, 32, 32, 1024), 128),
    "global batch 16": ((16, 32, 32, 1024), 256),
    "multiscale batch 2 (bn)": ((2, 64, 64, 512), 128),
    "multiscale batch 8 (bn)": ((8, 64, 64, 512), 256),
    "local batch 2": ((2, 64, 64, 512), 128),
    "local batch 4": ((4, 64, 64, 512), 128),
}


@pytest.mark.parametrize("name", list(K7A_SHAPES))
def test_k7a_takes_the_wgmma_conv_at_wg_bn(name):
    shape, bn = K7A_SHAPES[name]
    assert kt.a_conv_variant(*shape) == bn
    # K1's conv 1, at K1's rule
    assert bn == wgmma_conv.block_n(*shape) == wgmma_conv.variant(
        *shape, shape[-1], 1)


# K5: bilinear_content's trunk (B, 64, 64, 128) at the checked batch 4 and
# the timed 32, every branch rate and the reflect conv (rate 1). The rule
# does not depend on the rate.
@pytest.mark.parametrize("n", [4, 32])
@pytest.mark.parametrize("rate", [1, 2, 4, 6, 8])
def test_k5_takes_the_wgmma_conv_at_every_rate(n, rate):
    # (BN, bytes of K a stage): K5's 128 channels fill a 128-byte stage
    assert ka.conv_variant(n, 64, 64, 128, 128) == (ka.BN, 128)
    assert ka.BN == 128 == wgmma_conv.block_n(n, 64, 64, 128)


# K6's stage 2 at 512² (64 → 128 on the subsampled (B, 64, 64) image) takes
# the wgmma conv at a 64-byte K stage (a 128-byte one would span two taps
# of 64 channels); the 256² stage 1 (32 → 64: Cout 64 is under BN 128, and
# 32 channels fill neither stage) keeps conv_s8_kernel, (0, 0).
@pytest.mark.parametrize("n", [4, 32])
@pytest.mark.parametrize("cin,cout", [(64, 128), (32, 64)])
def test_k6_shapes_take_their_conv_variant(n, cin, cout):
    want = (ka.BN, 64) if cin == 64 else (0, 0)
    assert ka.conv_variant(n, 64, 64, cin, cout) == want


# --------------------------------------------------------------------------- #
# The dilated box fetch, modelled in numpy
# --------------------------------------------------------------------------- #
def _box(xq, img, y, x, rows, cols):
    """The TMA box of (rows, cols) pixels at (y, x) of image ``img``, all
    channels, with zeros outside the image (TMA's fill)."""
    _, h, w, c = xq.shape
    out = np.zeros((rows, cols, c), xq.dtype)
    y0, y1 = max(y, 0), min(y + rows, h)
    x0, x1 = max(x, 0), min(x + cols, w)
    if y0 < y1 and x0 < x1:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = xq[img, y0:y1, x0:x1]
    return out


def _dilated_box_conv(xq, wk, r):
    """int8 NHWC ``xq`` and (Cout, 9·Cin) ``wk`` → int32 (N,H,W,Cout) the
    way ``wg_conv_kernel`` computes it at dilation ``r``: tile by tile, the
    K loop tap by tap and 128 channels a stage, int32 sums."""
    n, h, w, c = xq.shape
    bm, ke = wgmma_conv.BM, wgmma_conv.KBYTES
    cols = min(w, bm)
    rows = bm // cols
    out = np.zeros((n * h * w, wk.shape[0]), np.int32)
    wt = wk.astype(np.int32)
    for m0 in range(0, n * h * w, bm):
        img, rem = divmod(m0, h * w)
        y0, x0 = divmod(rem, w)
        acc = np.zeros((bm, wk.shape[0]), np.int32)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            a = _box(xq, img, y0 + ky * r - r, x0 + kx * r - r, rows, cols)
            a = a.reshape(bm, c).astype(np.int32)
            for c0 in range(0, c, ke):
                acc += a[:, c0:c0 + ke] @ wt[:, tap * c + c0:tap * c + c0 + ke].T
        out[m0:m0 + bm] = acc
    return out.reshape(n, h, w, -1)


def _jax_dilated(xq, wq, r):
    """JAX's int32 zero-pad 3×3 conv at dilation ``r``: ``wq`` (9, Cin,
    Cout) as HWIO."""
    c, cout = wq.shape[1:]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq, jnp.int32), jnp.asarray(wq.reshape(3, 3, c, cout),
                                                jnp.int32),
        window_strides=(1, 1), padding=((r, r), (r, r)), rhs_dilation=(r, r),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


# Shapes that meet the tile rule: whole rows a tile (W 16, 32, 128) or 128
# pixels of one row (W 256); rows of a tile and taps leave the image at
# the larger rates, whole boxes too.
@pytest.mark.parametrize("shape", [(1, 8, 16, 128), (2, 4, 32, 128),
                                   (1, 2, 256, 128), (1, 3, 128, 256)])
@pytest.mark.parametrize("rate", [1, 2, 4, 6, 8])
def test_dilated_box_fetch_equals_plain_and_jax(shape, rate):
    n, h, w, c = shape
    cout = 128
    assert wgmma_conv.tile_ok(n, h, w, c, cout, 1)
    rng = np.random.RandomState(sum(shape) + rate)
    xq = rng.randint(-127, 128, shape).astype(np.int8)
    wq = rng.randint(-127, 128, (9, c, cout)).astype(np.int8)
    wk = wq.transpose(2, 0, 1).reshape(cout, 9 * c)   # the kernel's operand
    got = _dilated_box_conv(xq, wk, rate)
    plain = qi.conv3x3_dilated_s8_plain(torch.from_numpy(xq),
                                        torch.from_numpy(wq), rate)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_dilated(xq, wq, rate))
