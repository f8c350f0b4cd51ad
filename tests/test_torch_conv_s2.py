"""K10, the UNet's 7×7 stride-2 zero-pad-3 bf16 conv (``csrc/conv_s2.cu``),
on the CPU: an fp32 emulation of the kernel's schedule (its (Cout, 49·Cin)
weight packing, its 128-pixel output tiles and each tap's strided TMA box
with zero fill, summed tap by tap) against ``F.conv2d``; the
``cistar::conv7x7s2_bf16`` op's CPU path against the plain conv; the Python
mirror of the kernel's shape rule; and the UNet's downs through the op.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
to the plain version and checks the BN the library picks at each down.
"""

import pytest
import torch
import torch.nn.functional as F

from cistar_tpu_torch.kernels import conv_s2, custom_ops
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import UNetGeneratorHD
from cistar_tpu_torch.ops import nn as tnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(w: torch.Tensor) -> torch.Tensor:
    """OIHW → the kernel's (Cout, 49·Cin), k = tap·Cin + cin."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _tiles(n: int, ho: int, wo: int):
    """``wg_tile`` on the output: each 128-pixel tile's first output pixel
    ``m0`` and its image, row and column, in M order."""
    for m0 in range(0, n * ho * wo, conv_s2.BM):
        img, rem = divmod(m0, ho * wo)
        yield m0, img, rem // wo, rem % wo


def _box_origin(y0: int, x0: int, tap: int):
    """Where tap ``tap`` (7·dy + dx) of the tile at output (``y0``, ``x0``)
    starts its box on the input (the producer's coordinates)."""
    dy, dx = divmod(tap, conv_s2.KK)
    return (conv_s2.STRIDE * y0 + dy - conv_s2.PAD,
            conv_s2.STRIDE * x0 + dx - conv_s2.PAD)


def _box(x: torch.Tensor, img: int, y: int, x0: int, rows: int, cols: int
         ) -> torch.Tensor:
    """The strided box TMA loads: ``rows`` x ``cols`` pixels of image
    ``img`` from input (``y``, ``x0``), every other one on both axes, zeros
    outside the input; (rows·cols, Cin)."""
    _, h, w, cin = x.shape
    ys = torch.arange(rows) * conv_s2.STRIDE + y
    xs = torch.arange(cols) * conv_s2.STRIDE + x0
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
    v = x[img, ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)]
    return (v * inside[..., None]).reshape(rows * cols, cin)


def _emulate(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """K10's schedule in fp32: per output tile, per tap, one box times the
    tap's (Cin, Cout) slice of ``wk``, summed tap by tap."""
    n, h, w, cin = x.shape
    cout = wk.shape[0]
    ho, wo = h // 2, w // 2
    cols = min(wo, conv_s2.BM)
    rows = conv_s2.BM // cols
    out = torch.empty(n * ho * wo, cout)
    taps = wk.reshape(cout, conv_s2.KK ** 2, cin)
    for m0, img, y0, x0 in _tiles(n, ho, wo):
        acc = torch.zeros(conv_s2.BM, cout)
        for tap in range(conv_s2.KK ** 2):
            y, xx = _box_origin(y0, x0, tap)
            acc += _box(x, img, y, xx, rows, cols) @ taps[:, tap].t()
        out[m0:m0 + conv_s2.BM] = acc
    return out.reshape(n, ho, wo, cout)


# (N, H, W, Cin, Cout): the three downs' Cin:Cout at small sizes, an odd
# batch; tiles of 8 output rows, of 2 rows of 64, and 128 pixels of a
# 256-wide row (second half at x0 = 128, its last taps past the right edge)
SCHEDULE_SHAPES = [(3, 32, 32, 64, 128), (3, 32, 32, 128, 256),
                   (3, 16, 32, 256, 512), (3, 4, 128, 64, 128),
                   (3, 2, 512, 64, 128)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_schedule_emulation_is_the_conv(shape):
    n, h, w, cin, cout = shape
    assert conv_s2.shape_ok(n, h, w, cin, cout)
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, w, cin, generator=g)
    wt = torch.randn(cout, cin, 7, 7, generator=g) / (49 * cin) ** 0.5
    got = _emulate(x, _pack(wt))
    want = F.conv2d(x.permute(0, 3, 1, 2), wt, None, 2, 3).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_op_cpu_path_is_the_plain_conv_in_bf16():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 16, 64, generator=g).bfloat16()
    w = torch.randn(128, 64, 7, 7, generator=g) * 0.02
    b = torch.randn(128, generator=g)
    wk = _pack(w.bfloat16()).contiguous()
    got = torch.ops.cistar.conv7x7s2_bf16(x, wk, b)
    want = tnn.conv2d(x, w, b, stride=2, padding=3)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 8, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    no_bias = torch.ops.cistar.conv7x7s2_bf16(x, wk, None)
    torch.testing.assert_close(no_bias, tnn.conv2d(x, w, None, 2, 3),
                               rtol=0, atol=0)


# The three downs of r2l_MSRB_7 at 512² (ngf 64), at the benchmark's batch
# 8, the test CLI's batch 1 and chip_smoke's batch 2
DOWNS = [(512, 64, 128), (256, 128, 256), (128, 256, 512)]


@pytest.mark.parametrize("n", [8, 1, 2])
def test_shape_rule_takes_the_downs(n):
    for s, cin, cout in DOWNS:
        assert conv_s2.shape_ok(n, s, s, cin, cout)


@pytest.mark.parametrize("shape", [
    (8, 511, 512, 64, 128),    # odd H
    (8, 512, 511, 64, 128),    # odd W
    (8, 512, 512, 32, 128),    # Cin 32: half a K stage
    (8, 512, 512, 64, 64),     # Cout 64
    (2, 48, 48, 64, 128),      # W/2 = 24: no whole rows, no 128 of one
    (1, 8, 8, 64, 128),        # 16 output pixels: a tile would span images
])
def test_shape_rule_refuses(shape):
    assert not conv_s2.shape_ok(*shape)


def test_kernel_ids_hold_k10():
    assert custom_ops.KERNEL_IDS["conv7x7s2_bf16"] == "K10"
    assert "conv7x7s2_bf16" in conv_s2.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_downs_through_the_op_are_the_module_convs(dtype):
    u = UNetGeneratorHD(1, 1, 2, 8).eval()
    x = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(3))
    x = x.to(dtype)
    with torch.no_grad():
        skips = fi.unet_encode(u, x)
        h = fi._in_relu(fi._thin(u.init_block.conv, x))
        for conv, skip in zip(u.down_conv, skips):
            h = fi._in_relu(conv(h))
            assert skip.dtype == dtype
            torch.testing.assert_close(skip, h, rtol=0, atol=0)
