"""The grouped ``wgmma`` + TMA conv of K7b and K8 (``csrc/wgmma_conv.cuh``
with KK×KK taps and input groups) on the CPU: which conv each path's K7b /
K8 shapes take, from the Python mirror of the tile rule
(``kernels/wgmma_conv.py``, what ``cistar_tiled_conv_variant`` and
``cistar_msrb_conv_variant`` answer; ``chip_smoke.py`` holds the two
together on the card), and the plain K8 stage and K7b at the kernels' own
grouping (128- and 256-channel groups) against the JAX package: its XLA
emulations and its Pallas kernels in interpret mode.

The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu_torch.core.convert import generator_from_jax
from cistar_tpu_torch.kernels import int8_msrb as km
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.kernels import wgmma_conv
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import MSRB, ResidualBlock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# Which conv each path's K7b / K8 shapes take
# --------------------------------------------------------------------------- #
# K8: the UNet path's trunk (B, 64, 64, 512) at the checked batch 2 and the
# timed 8; stage 1 on 512 channels in one group, stage 2 on the two
# stage-1 outputs side by side, 1024 channels in 2 x 512 / 128 groups
# (ct 128); both branches. (N, H, W, Cin, Cout, kk, groups)
K8_SHAPES = {f"UNet batch {n} stage {st} {kk}x{kk}": (n, 64, 64, cin, 512, kk, g)
             for n in (2, 8) for st, cin, g in (("1", 512, 1), ("2", 1024, 8))
             for kk in (3, 5)}
# K7b: (N, H, W, C, ct) of global (ct 256 at 32²×1024), local and multiscale
# 512² (ct 128 at 64²×512, the bn form for multiscale) at their checked and
# timed batches
K7B_SHAPES = {"global batch 4": (4, 32, 32, 1024, 256),
              "global batch 16": (16, 32, 32, 1024, 256),
              "local batch 2": (2, 64, 64, 512, 128),
              "local batch 4": (4, 64, 64, 512, 128),
              "multiscale 512² batch 2 (bn)": (2, 64, 64, 512, 128),
              "multiscale 512² batch 8 (bn)": (8, 64, 64, 512, 128)}


@pytest.mark.parametrize("label", sorted(K8_SHAPES))
def test_k8_path_shapes_take_the_wgmma_conv(label):
    n, h, w, cin, cout, kk, groups = K8_SHAPES[label]
    assert km.conv_variant(n, h, w, cin, cout, kk, groups) == 128


@pytest.mark.parametrize("label", sorted(K7B_SHAPES))
def test_k7b_path_shapes_take_the_wgmma_conv(label):
    n, h, w, c, ct = K7B_SHAPES[label]
    # the tile is the one the JAX kernel path picks at this trunk
    assert qi.pick_cout_tile(h * w, c) == ct
    assert kt.conv_variant(n, h, w, c, c // ct) == 128


@pytest.mark.parametrize("which,shape", [
    ("k7b", (4, 32, 32, 1024, 16)),        # ct 64: a group of 64 channels
    ("k7b", (2, 16, 24, 512, 4)),          # W = 24: no whole-row tile
    ("k8", (2, 64, 64, 512, 64, 3, 1)),    # Cout 64
    ("k8", (2, 64, 64, 512, 512, 7, 1)),   # 7×7 taps
    ("k8", (2, 64, 64, 512, 512, 5, 8)),   # a group of 64 channels
])
def test_grouped_shapes_outside_the_rule_keep_the_old_conv(which, shape):
    variant = kt.conv_variant if which == "k7b" else km.conv_variant
    assert variant(*shape) == 0


def test_grouped_tile_rule():
    # a group of 128 int8 channels fills a 128-byte K stage; BN 128 for the
    # grouped libraries even where the ungrouped rule would take 256
    assert wgmma_conv.tile_ok(2, 64, 64, 1024, 512, 1, 5, 8)
    assert not wgmma_conv.tile_ok(2, 64, 64, 1024, 512, 1, 5, 16)
    assert not wgmma_conv.tile_ok(2, 64, 64, 1000, 512, 1, 3, 8)  # 8 ∤ Cin
    assert not wgmma_conv.tile_ok(2, 64, 64, 512, 512, 1, 4, 1)   # kk 4
    assert wgmma_conv.block_n(16, 32, 32, 1024) == 256
    assert wgmma_conv.variant(16, 32, 32, 1024, 1024, 1, 3, 4,
                              grouped=True) == wgmma_conv.GROUPED_BN == 128
    # the defaults are the ungrouped 3×3 rule of K1 / K3
    assert wgmma_conv.variant(16, 32, 32, 1024, 1024, 1) == 256


# --------------------------------------------------------------------------- #
# K8 at 128-channel groups: the plain stage against JAX
# --------------------------------------------------------------------------- #
NF, CT = 128, 128


@pytest.fixture(scope="module")
def k8():
    rng = np.random.RandomState(18)
    x = _rand(rng, 2, 8, 16, NF)

    def conv(kk, cin):
        return {"w": _rand(rng, kk, kk, cin, NF, scale=0.03),
                "b": _rand(rng, NF, scale=0.01)}
    p = {"b00_conv": conv(3, NF), "b01_conv": conv(5, NF),
         "b10_conv": conv(3, 2 * NF), "b11_conv": conv(5, 2 * NF),
         "out_conv": conv(1, 2 * NF)}
    m = MSRB(NF)
    m.load_state_dict(generator_from_jax(p))
    return x, qp.quantize_msrb(p), qi.quantize_msrb(m)


@pytest.mark.parametrize("stage,quant_out", [("a", True), ("a", False),
                                             ("b", True), ("b", False)])
def test_k8_plain_at_128_channel_groups(k8, stage, quant_out):
    # Stage a: one group of 128 channels (gin 1); stage b: the two stage-1
    # outputs side by side, gin 2 groups of ct = 128, each with its tile
    # scale. The tolerances of test_k8_plain_matches_emulation_and_interpret:
    # int8 outputs equal; scales equal to the emulation and within an ulp of
    # interpret mode (XLA rewrites the traced kernel's amax / 127.0 into a
    # multiply); float outputs within 2e-5.
    x, jq, tq = k8
    xq, xs = qp.quantize_act(jnp.asarray(x))
    if stage == "b":
        o3, o5, s3, s5 = qp._msrb_stage_emulate(xq, xs, jq["w3a"], jq["w5a"],
                                                jq["sb1"], CT, True, None)
        xq = jnp.concatenate([o3, o5], -1)
        xs = jnp.concatenate([s3, s5], 1)
        assert xs.shape == (2, 2) and xq.shape[-1] == 2 * CT
    sb = "sb1" if stage == "a" else "sb2"
    args = (xq, xs, jq[f"w3{stage}"], jq[f"w5{stage}"], jq[sb], CT, quant_out,
            jnp.float32)
    got = qi.msrb_stage_plain(_t(np.asarray(xq)), _t(np.asarray(xs)),
                              tq[f"w3{stage}"], tq[f"w5{stage}"], tq[sb], CT,
                              quant_out, torch.float32)
    for interpret, ref in ((False, qp._msrb_stage_emulate(*args)),
                           (True, qp._run_msrb_stage(*args, interpret=True))):
        for i, (g, r) in enumerate(zip(got, ref)):
            r = np.asarray(r).reshape(tuple(g.shape))
            if not quant_out:
                np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-5)
            elif interpret and i >= 2:
                np.testing.assert_allclose(g.numpy(), r, rtol=2e-7, atol=0)
            else:
                np.testing.assert_array_equal(g.numpy(), r)


# --------------------------------------------------------------------------- #
# K7b at 128- and 256-channel groups: the plain half against JAX
# --------------------------------------------------------------------------- #
def _k7_block(c, seed):
    rng = np.random.RandomState(seed)
    x = _rand(rng, 2, 8, 16, c)
    blk = {f"conv{i}": {"w": _rand(rng, 3, 3, c, c, scale=0.02),
                        "b": _rand(rng, c, scale=0.01)} for i in (1, 2)}
    tb = ResidualBlock(c)
    tb.load_state_dict(generator_from_jax(blk))
    return x, qp.quantize_resblock(blk), qi.quantize_resblock(tb)


@pytest.fixture(scope="module")
def k7():
    # ct 128 on 256 channels and ct 256 on 512: two groups each
    return {128: _k7_block(256, 71), 256: _k7_block(512, 72)}


def _jax_tiled_b(rq, rs, hx, qblk, ct, bn=False):
    """Kernel B of ``_run_resblock_int8_tiled`` (its second pallas_call,
    quant_pallas.py:532-544) alone, in interpret mode, on the given rq and
    (n, t) tile scales rs."""
    n, h, w, c = hx.shape
    t = c // ct
    vm = pltpu.VMEM
    img = pl.BlockSpec((1, h, w, c), lambda i, j: (i, 0, 0, 0),
                       memory_space=vm)
    tile = pl.BlockSpec((1, h, w, ct), lambda i, j: (i, 0, 0, j),
                        memory_space=vm)
    return np.asarray(pl.pallas_call(
        functools.partial(qp._resblock_b_kernel, h=h, w=w, c=c, ct=ct,
                          eps=qp._EPS, bn=bn),
        grid=(n, t),
        in_specs=[img,
                  pl.BlockSpec((t, 1, 1), lambda i, j: (i, 0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((9, c, ct), lambda i, j: (0, 0, j),
                               memory_space=vm),
                  pl.BlockSpec((4, ct), lambda i, j: (0, j), memory_space=vm),
                  tile],
        out_specs=tile,
        out_shape=jax.ShapeDtypeStruct((n, h, w, c), hx.dtype),
        interpret=True,
    )(rq, rs.reshape(n * t, 1, 1), qblk["w2q"], qblk["sb"], hx))


@pytest.mark.parametrize("ct", [128, 256])
def test_k7b_plain_at_wide_groups(k7, ct):
    # K7b on the plain K7a's rq / rs: against the TPU kernel B alone in
    # interpret mode on the same rq / rs, and the whole block against the
    # emulation and both TPU kernels in interpret mode; fp32 sums of the IN
    # in another order, within the 2e-5 of
    # test_k7_plain_matches_pallas_interpret_and_emulation (3.3e-6
    # measured).
    x, jq, tq = k7[ct]
    rq, rs = qi.resblock_tiled_a_plain(_t(x), tq, ct)
    got = qi.resblock_tiled_b_plain(rq, rs, _t(x), tq, ct).numpy()
    ref_b = _jax_tiled_b(jnp.asarray(rq.numpy()), jnp.asarray(rs.numpy()),
                         jnp.asarray(x), jq, ct)
    np.testing.assert_allclose(got, ref_b, rtol=0, atol=2e-5)
    for ref in (qp._resblock_int8_tiled_emulate(jnp.asarray(x), jq, ct),
                qp._run_resblock_int8_tiled(jnp.asarray(x), jq, ct,
                                            interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("ct", [128, 256])
def test_k7b_bn_plain_at_wide_groups(k7, ct):
    # The bn form (no statistic): the same fp32 ops in the same order as the
    # emulation, so equal to it; the TPU kernel B alone in interpret mode on
    # the same rq / rs within 1e-5, the bound of
    # test_k7_bn_plain_matches_emulation_and_interpret (9.5e-7 measured).
    x, jq, tq = k7[ct]
    rq, rs = qi.resblock_tiled_a_plain(_t(x), tq, ct, bn=True)
    got = qi.resblock_tiled_b_plain(rq, rs, _t(x), tq, ct, bn=True).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        qp._resblock_int8_tiled_emulate(jnp.asarray(x), jq, ct, bn=True)))
    np.testing.assert_allclose(
        got, _jax_tiled_b(jnp.asarray(rq.numpy()), jnp.asarray(rs.numpy()),
                          jnp.asarray(x), jq, ct, bn=True),
        rtol=0, atol=1e-5)
