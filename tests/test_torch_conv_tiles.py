"""The ``wgmma`` + TMA 3×3 conv of K1 / K2 / K3 (``csrc/wgmma_conv.cuh``)
on the CPU: which conv each path's shapes take, from the Python mirror of
its tile rule (``kernels/wgmma_conv.py``, what the libraries'
``cistar_resblock_conv_variant`` and ``cistar_conv3x3_in_act_variant``
answer; ``chip_smoke.py`` holds the two together on the card), and the
plain version of its new entry ``cistar_conv3x3_bf16_f32``
(``ops/fused.py::conv3x3_bias_plain``) against plain K3's conv and JAX's.

The tests of the tile rule pin the Python mirror, not the kernel: the
rule lives twice, in C (``wg_tile_ok`` / ``wg_bn``) and in
``kernels/wgmma_conv.py``, and only ``chip_smoke.py`` sees a drift between
them, where it checks each library's query against the mirror at the
paths' shapes. The CUDA kernels themselves are compared with the plain
versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.ops import nn as jnn
from cistar_tpu_torch.core.convert import conv_w_from_hwio
from cistar_tpu_torch.kernels import fused_conv as kf
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.kernels import wgmma_conv
from cistar_tpu_torch.models.cyclegan import seeded_generator
from cistar_tpu_torch.models.pix2pixhd import MultiscaleGlobalGenerator
from cistar_tpu_torch.ops import fused
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
# Which conv each path's shapes take
# --------------------------------------------------------------------------- #
# K1 / K2 shapes (N, H, W, C) of the ported paths and the BN of the wgmma
# conv there: ResNet-9 at 256² (trunk (B, 32, 32, 512)) at the checked
# batch 8, the timed 64 and one image; pix2pixHD multiscale at 256², batch
# 8 (the same trunk, K1-bn); the JAX int8 budget configuration
# (tools/kernel_matrix.py: 3 blocks, 32 features, 128², batch 32).
K1_SHAPES = {
    "resnet9 batch 8": ((8, 32, 32, 512), 128),
    "resnet9 batch 64": ((64, 32, 32, 512), 256),
    "resnet9 batch 1": ((1, 32, 32, 512), 128),
    "multiscale 256² batch 8": ((8, 32, 32, 512), 128),
    "budget config batch 32": ((32, 16, 16, 128), 128),
}


@pytest.mark.parametrize("label", sorted(K1_SHAPES))
def test_k1_path_shapes_take_the_wgmma_conv(label):
    (n, h, w, c), bn = K1_SHAPES[label]
    assert qi.whole_image_resblock_fits(h, w, c)   # the JAX rule sends it to K1
    assert kr.conv_variant(n, h, w, c) == bn


def test_k1_trunk_shapes_are_the_generators():
    # the widths above are the generators' own: ResNet-9 at 64 features and
    # multiscale at ngf 64 both run 512-channel trunk blocks, 8x down
    g = seeded_generator("p2p", 9, 64, device="cpu")
    assert tuple(g.res[0].conv1.weight.shape) == (512, 512, 3, 3)
    assert len(g.down) == 3
    ms = MultiscaleGlobalGenerator(1, 1, 64, 1)
    assert ms.res[0].conv1.weight.shape[0] == 512


@pytest.mark.parametrize("shape,variant", [
    ((4, 16, 24, 128), 0),     # W = 24 neither divides nor is a multiple of 128
    ((2, 4, 256, 128), 128),   # 128-pixel pieces of one 256-wide row
    ((2, 64, 2, 128), 128),    # 64 rows of 2 pixels a tile
    ((64, 32, 32, 256), 256),  # 512 tiles x 1 column block: 2 blocks per SM
    ((8, 32, 32, 256), 128),   # 64 tiles: BN 256 would leave SMs idle
])
def test_k1_tile_rule_other_shapes(shape, variant):
    # every K1 shape (C % 128, H·W % 128) is served: by the wgmma conv, or
    # where W does not fit its boxes by conv_s8_kernel (variant 0)
    assert kr.conv_variant(*shape) == variant


@pytest.mark.parametrize("n,cin,cout,x16,w16,variant", [
    (8, 512, 512, True, True, 128),     # the fast forward's trunk, checked
    (64, 512, 512, True, True, 256),    # and timed batch
    (8, 512, 512, True, False, 0),      # fp32 weights: the FFMA loop
    (8, 64, 64, False, False, 0),       # chip_smoke's fp32 K3 shape
    (8, 64, 128, True, True, 128),      # 128 bytes of bf16 K: Cin % 64
    (8, 32, 128, True, True, 0),        # Cin 32: a K stage spans two taps
])
def test_k3_variant(n, cin, cout, x16, w16, variant):
    assert kf.conv_variant(n, 32, 32, cin, cout, x16, w16) == variant


def test_tile_rule_boundaries():
    assert wgmma_conv.tile_ok(1, 2, 64, 128, 128, 1)       # one tile
    assert not wgmma_conv.tile_ok(1, 1, 128, 128, 128, 1)  # H < 2
    assert not wgmma_conv.tile_ok(1, 3, 64, 128, 128, 1)   # H·W % 128
    assert not wgmma_conv.tile_ok(2, 32, 32, 512, 192, 1)  # Cout % 128
    assert wgmma_conv.tile_ok(2, 32, 32, 64, 128, 2)       # bf16, Cin 64
    assert not wgmma_conv.tile_ok(2, 32, 32, 64, 128, 1)   # int8, Cin 64
    # BN 256 from 2 blocks per SM of an H100 SXM (132 SMs) on: at (N, 32,
    # 32, 512) from N = 17 (136 tiles x 2 column blocks >= 264)
    assert wgmma_conv.block_n(16, 32, 32, 512) == 128
    assert wgmma_conv.block_n(17, 32, 32, 512) == 256
    assert wgmma_conv.block_n(64, 32, 32, 384) == 128      # Cout % 256


# --------------------------------------------------------------------------- #
# The plain version of cistar_conv3x3_bf16_f32
# --------------------------------------------------------------------------- #
def _conv_inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    w = (0.05 * rng.randn(128, 64, 3, 3)).astype(np.float32)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    # the operands rounded to the working dtype, as the kernel reads them
    tx, tw = (torch.from_numpy(a).to(dtype) for a in (x, w))
    return tx, tw, torch.from_numpy(b)


@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_bias_plain_matches_jax(pad_mode, dtype):
    # JAX's conv of the same (rounded) values in fp32 at HIGHEST precision:
    # the same exact products summed in another order (measured ~1e-6)
    tx, tw, b = _conv_inputs(1, dtype)
    got = fused.conv3x3_bias_plain(tx, tw, b, pad_mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 8, 128)
    xf = jnp.asarray(tx.float().numpy())
    xp = jnp.pad(xf, ((0, 0), (1, 1), (1, 1), (0, 0)),
                 mode="reflect" if pad_mode == "reflect" else "constant")
    wf = jnp.asarray(tw.float().numpy().transpose(2, 3, 1, 0))   # HWIO
    ref = jax.lax.conv_general_dilated(
        xp, wf, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
def test_conv3x3_bias_plain_is_plain_k3s_conv(pad_mode):
    # plain K3 normalizes exactly this conv: its single-pass IN applied to
    # conv3x3_bias_plain gives plain K3's output bit for bit
    tx, tw, b = _conv_inputs(2, torch.bfloat16)
    acc = fused.conv3x3_bias_plain(tx, tw, b, pad_mode)
    mean = acc.sum(dim=(1, 2), keepdim=True) / 64.0
    var = torch.clamp((acc * acc).sum(dim=(1, 2), keepdim=True) / 64.0
                      - mean * mean, min=0.0)
    y = torch.relu((acc - mean) * torch.rsqrt(var + fused.EPS))
    assert torch.equal(y.to(tx.dtype), fused.fused_conv3x3_in_act_plain(
        tx, tw, b, "relu", None, pad_mode))


def test_conv3x3_bias_plain_is_jax_conv2d_reflect():
    # the trunk conv of the JAX ResNet generator (ops/nn.py::conv2d_reflect,
    # fp32 at HIGHEST precision) on HWIO weights, against
    # conv3x3_bias_plain on the converted OIHW weights: order of sums only
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    w = (0.05 * rng.randn(3, 3, 64, 128)).astype(np.float32)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    ref = jnn.conv2d_reflect(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = fused.conv3x3_bias_plain(torch.from_numpy(x),
                                   torch.from_numpy(conv_w_from_hwio(w)),
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
