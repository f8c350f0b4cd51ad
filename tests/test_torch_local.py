"""Slice 5 of the port: pix2pixHD ``netG=local`` (``LocalEnhancer``, the
coarse-to-fine generator of the JAX suite's 1024² config). ``avg_pool2d``,
the generator and its converter, ``local_enhancer_int8_apply`` on both
trunk routes (K1, and K7 as the 1024² config takes it) and the inference
engine, against the JAX package on the CPU from the same seeded inputs.

The CUDA kernels themselves are compared with their plain versions on the
card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.engines.p2phd import Pix2PixHD
from cistar_tpu.models import fast_infer as jfi
from cistar_tpu.models.pix2pixhd import LocalEnhancer as JaxLocal
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu_torch.core.convert import local_enhancer_from_jax
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import (BatchNorm,
                                               GlobalGeneratorTrunk,
                                               LocalEnhancer, define_g)
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bump(tree, rng):
    # nonzero biases, so that the bias rows and the bias mapping matter
    return jax.tree.map(
        lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), tree)


# --------------------------------------------------------------------------- #
# avg_pool2d
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size", [(16, 16), (15, 13)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("padding", [1, 0])
def test_avg_pool2d_matches_jax(size, dtype, padding):
    # count_include_pad=False: the fp32 window sum, then the reciprocal-
    # count table (padding 1) or the division by 9 (padding 0), then one
    # cast: equal to JAX in every element, in fp32 and in bf16
    rng = np.random.RandomState(sum(size))
    x = rng.randn(2, *size, 3).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(jnn.avg_pool2d(
        jnp.asarray(x).astype(jdt), 3, 2, padding=padding,
        count_include_pad=False).astype(jnp.float32))
    got = tnn.avg_pool2d(_t(x).to(tdt), 3, 2, padding=padding)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)


# --------------------------------------------------------------------------- #
# The generator: ngf 4, two enhancers (the global trunk at ngf 16 on the
# 16² level, 2 downs, 2 blocks; enhancer 1 at 32², enhancer 2 with the head
# at 64²), 1 local block each: an (2, 4, 4, 64) trunk
# --------------------------------------------------------------------------- #
CFG = dict(ngf=4, n_downsample_global=2, n_blocks_global=2,
           n_local_enhancers=2, n_blocks_local=1)


def _pair(seed, cfg):
    rng = np.random.RandomState(seed)
    x = (rng.rand(2, 64, 64, 1) * 2 - 1).astype(np.float32)
    jg = JaxLocal(1, *cfg.values())
    p = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(seed),
                                   jnp.asarray(x))["params"]), rng)
    g = LocalEnhancer(1, 1, *cfg.values())
    g.load_state_dict(local_enhancer_from_jax(p))
    return dict(x=x, jg=jg, p=p, g=g.eval())


@pytest.fixture(scope="module")
def le():
    return _pair(11, CFG)


def _jax_forward(m, dtype=jnp.float32):
    return np.asarray(jax.jit(m["jg"].apply)(
        {"params": m["p"]}, jnp.asarray(m["x"]).astype(dtype))
        .astype(jnp.float32))


def test_converter_maps_every_node(le):
    sd, ref = local_enhancer_from_jax(le["p"]), le["g"].state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape, k
    assert isinstance(le["g"].global_trunk, GlobalGeneratorTrunk)
    np.testing.assert_array_equal(
        sd["global.res.1.conv2.weight"].numpy(),
        le["p"]["global"]["res_1"]["conv2"]["w"].transpose(3, 2, 0, 1))
    # transpose conv: HWIO → (in, out, kh, kw), no flip
    np.testing.assert_array_equal(
        sd["enh1_up.convt.weight"].numpy(),
        le["p"]["enh1_up"]["convt"]["w"].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["enh2_res_0.conv1.bias"].numpy(),
                                  le["p"]["enh2_res_0"]["conv1"]["b"])


def test_generator_fp32_matches_jax(le):
    # fp32 throughout: order of sums only; 1e-4 (1.4e-6 measured)
    ref = _jax_forward(le)
    with torch.no_grad():
        got = le["g"](_t(le["x"])).numpy()
    assert got.shape == le["x"].shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_generator_bf16_matches_jax(le):
    # bf16 activations, fp32 IN statistics in both: a bf16 rounding that
    # goes the other way moves the tanh output by ~1e-2 (1.3e-2 measured);
    # 0.05, the gate of the bf16 generators of slices 1-3
    ref = _jax_forward(le, jnp.bfloat16)
    with torch.no_grad():
        got = le["g"](_t(le["x"]).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=0.05)


def test_define_g_local():
    g = define_g("local", 1, 1, 4, 1, 1, 1, 1)
    assert isinstance(g, LocalEnhancer)
    assert {"global", "enh1_stem", "enh1_down", "enh1_res_0", "enh1_up",
            "head"} == set(dict(g.named_children()))
    assert g.global_trunk.stem.conv.weight.shape[0] == 8   # ngf·2
    # norm="batch" is ported now: the global trunk and the enhancer too
    g = define_g("local", 1, 1, 4, 1, 1, 1, 1, norm="batch")
    assert isinstance(g.global_trunk.res[0].norm1, BatchNorm)
    assert isinstance(g.enhancer(1, "up").norm, BatchNorm)


# --------------------------------------------------------------------------- #
# The int8 engine and the inference engine
# --------------------------------------------------------------------------- #
def _jax_int8(le, cout_tile=None):
    fwd = jax.jit(lambda p, q, x: jfi.local_enhancer_int8_apply(
        p, q, x, n_downsample_global=CFG["n_downsample_global"],
        n_blocks_global=CFG["n_blocks_global"],
        n_local_enhancers=CFG["n_local_enhancers"],
        n_blocks_local=CFG["n_blocks_local"], cout_tile=cout_tile))
    q = jfi.quantize_local_enhancer(le["p"], CFG["n_blocks_global"])
    return np.asarray(fwd(le["p"], q, jnp.asarray(le["x"])))


def test_quantize_local_enhancer_exact(le):
    jq = jfi.quantize_local_enhancer(le["p"], CFG["n_blocks_global"])
    tq = fi.quantize_local_enhancer(le["g"])
    assert len(tq) == CFG["n_blocks_global"]
    for j, t in zip(jq, tq):
        for k in ("w1q", "w2q", "sb"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_int8_engine_k1_route_matches_jax(le):
    # the global trunk fits whole-image (K1); fp32, int8 tensors equal, sum
    # order left (7.3e-7 measured); within the trunk family budget (0.35)
    # of the fp32 forward (0.019 measured)
    g = le["g"]
    assert qi.whole_image_resblock_fits(4, 4, 64)
    ref = _jax_int8(le)
    with torch.no_grad():
        got = fi.local_enhancer_int8_apply(
            g, fi.quantize_local_enhancer(g), _t(le["x"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(got - _jax_forward(le)).max() < 0.35


def test_int8_engine_tiled_route_matches_jax(le, monkeypatch):
    # the K7 route, forced in both packages as the 1024² config's 64²×512
    # trunk takes it, with the tile passed to both (ROADMAP queue 3);
    # 1.0e-6 measured
    g = le["g"]
    monkeypatch.setattr(qp, "whole_image_resblock_fits", lambda h, w, c: False)
    monkeypatch.setattr(fi, "whole_image_resblock_fits", lambda h, w, c: False)
    routes = []
    monkeypatch.setattr(fi, "resblock_chain_int8_tiled",
                        lambda *a: routes.append(a[2:]) or
                        qi.resblock_chain_int8_tiled(*a))
    ref = _jax_int8(le, cout_tile=16)
    with torch.no_grad():
        got = fi.local_enhancer_int8_apply(
            g, fi.quantize_local_enhancer(g), _t(le["x"]),
            cout_tile=16).numpy()
    assert routes == [(16, False)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_engine_matches_jax(le):
    # fp32 compute: infer_step and infer_step_int8 of both engines on the
    # same params and labels (1.4e-6 / 7.3e-7 measured)
    p, x = le["p"], le["x"]
    jeng = Pix2PixHD(net_g="local", compute_dtype=jnp.float32, **CFG)
    teng = Pix2PixHDInference("local", compute_dtype=torch.float32,
                              device="cpu", **CFG)
    teng.load_jax_params(p)
    label = jnp.asarray(x)
    pairs = [(jeng.infer_step(p, label), teng.infer_step(_t(x))),
             (jeng.infer_step_int8(p, jeng.quantize_generator(p), label),
              teng.infer_step_int8(teng.quantize_generator(), _t(x)))]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)
