"""Slice 5 of the port: pix2pixHD ``netG=multiscale``
(``MultiscaleGlobalGenerator``, always BatchNorm) and the ``bn=True``
(folded BatchNorm) forms of K1 and K7. ``max_pool2d`` and
``batch_norm_inference``, the inference BatchNorm layer, the generator and
its converter, ``quantize_resblock_bn``, the plain K1 / K7a / K7b with
``bn=True``, the int8 engine on both trunk routes and the inference engine,
against the JAX package on the CPU from the same seeded inputs.

Random running statistics (mean 0, variance 1) normalize nothing, so the
generator's BatchNorm statistics are set from a seeded calibration batch,
layer by layer (:func:`calibrate`), before both packages run it.

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

from cistar_tpu.engines.p2phd import Pix2PixHD
from cistar_tpu.models import fast_infer as jfi
from cistar_tpu.models.pix2pixhd import \
    MultiscaleGlobalGenerator as JaxMultiscale
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu_torch.core.convert import multiscale_global_generator_from_jax
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import (BatchNorm,
                                               MultiscaleGlobalGenerator,
                                               define_g)
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


F32_ULP = 2.0 ** -23   # fp32 spacing relative to the value


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bump(tree, rng):
    # nonzero biases and betas, so that every row of the fold matters
    return jax.tree.map(
        lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), tree)


@torch.no_grad()
def calibrate(gen, x):
    """Set each BatchNorm's running statistics, layer by layer, to the batch
    mean and biased variance of its input under the fp32 forward of ``x``
    (the first input a shared layer sees)."""
    seen, hooks = set(), []

    def pre(m, args):
        if m not in seen:
            seen.add(m)
            v = args[0].float()
            m.running_mean.copy_(v.mean(dim=(0, 1, 2)))
            m.running_var.copy_(v.var(dim=(0, 1, 2), unbiased=False))
    for m in gen.modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(pre))
    try:
        gen(x.float())
    finally:
        for h in hooks:
            h.remove()


def jax_stats(gen):
    """The port generator's running statistics as a JAX ``batch_stats``
    tree: ``res.0.norm1`` → ``res_0/norm1``."""
    tree = {}
    for name, m in gen.named_modules():
        if not isinstance(m, BatchNorm):
            continue
        path = []
        for p in name.split("."):
            if p.isdigit():
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["mean"] = m.running_mean.numpy().copy()
        node["var"] = m.running_var.numpy().copy()
    return tree


# --------------------------------------------------------------------------- #
# max_pool2d and batch_norm_inference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size", [(16, 16), (15, 13)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_max_pool2d_matches_jax(size, dtype):
    # a max is exact: equal in every element, the −inf padding included
    rng = np.random.RandomState(sum(size))
    x = _rand(rng, 2, *size, 3)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jnn.max_pool2d(jnp.asarray(x).astype(jdt), 3, 2, padding=1)
    got = tnn.max_pool2d(_t(x).to(tdt), 3, 2, padding=1)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_batch_norm_inference_matches_jax():
    # fp32; rsqrt may differ by an ulp between the libraries: 2e-6
    # (9.5e-7 measured)
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 5, 6, 4)
    mean, gamma, beta = _rand(rng, 4), _rand(rng, 4), _rand(rng, 4)
    var = rng.rand(4).astype(np.float32) + 0.5
    ref = jnn.batch_norm_inference(*(jnp.asarray(a) for a in
                                     (x, mean, var, gamma, beta)))
    got = tnn.batch_norm_inference(*(_t(a) for a in
                                     (x, mean, var, gamma, beta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


# --------------------------------------------------------------------------- #
# The generator (ngf 8, 2 blocks, 64²: an (2, 8, 8, 64) trunk)
# --------------------------------------------------------------------------- #
NGF, NB = 8, 2


@pytest.fixture(scope="module")
def ms():
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 64, 64, 1) * 2 - 1).astype(np.float32)
    calib = (rng.rand(4, 64, 64, 1) * 2 - 1).astype(np.float32)
    jg = JaxMultiscale(1, NGF, NB, "batch")
    v = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    p = _bump(_np(v["params"]), rng)
    g = MultiscaleGlobalGenerator(1, 1, NGF, NB)
    g.load_state_dict(multiscale_global_generator_from_jax(
        p, _np(v["batch_stats"])))
    g.eval()
    calibrate(g, _t(calib))
    return dict(x=x, jg=jg, p=p, stats=jax_stats(g), g=g)


def _jax_forward(ms, x, dtype=jnp.float32):
    return np.asarray(jax.jit(functools.partial(ms["jg"].apply, train=False))(
        {"params": ms["p"], "batch_stats": ms["stats"]},
        jnp.asarray(x).astype(dtype)).astype(jnp.float32))


def test_converter_maps_every_node(ms):
    sd = multiscale_global_generator_from_jax(ms["p"], ms["stats"])
    ref = ms["g"].state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape, k
    # γ is stored as γ − 1 in JAX; the statistics come from batch_stats
    np.testing.assert_array_equal(
        sd["res.1.norm2.weight"].numpy(),
        ms["p"]["res_1"]["norm2"]["gamma"] + np.float32(1.0))
    np.testing.assert_array_equal(sd["feat_stem.norm.running_var"].numpy(),
                                  ms["stats"]["feat_stem"]["norm"]["var"])
    np.testing.assert_array_equal(
        sd["up.2.convt.weight"].numpy(),
        ms["p"]["up_2"]["convt"]["w"].transpose(2, 3, 0, 1))
    with pytest.raises(ValueError, match="batch_stats"):
        multiscale_global_generator_from_jax(ms["p"], None)


def test_calibrated_statistics_are_not_the_init(ms):
    # the calibration moved every layer off (0, 1), the shared stem's once
    for name, m in ms["g"].named_modules():
        if isinstance(m, BatchNorm):
            assert m.running_var.min() > 0, name
            assert not torch.equal(m.running_var,
                                   torch.ones_like(m.running_var)), name


def test_generator_fp32_matches_jax(ms):
    # fp32 throughout: order of sums only; 1e-4 (2.5e-6 measured)
    ref = _jax_forward(ms, ms["x"])
    with torch.no_grad():
        got = ms["g"](_t(ms["x"])).numpy()
    assert got.shape == ms["x"].shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_generator_bf16_matches_jax(ms):
    # bf16 activations, fp32 norms in both: a bf16 rounding that goes the
    # other way in one layer moves the tanh output by ~1e-2 (0.0195
    # measured); 0.05, the gate of the bf16 generators of slices 1-3
    ref = _jax_forward(ms, ms["x"], jnp.bfloat16)
    with torch.no_grad():
        got = ms["g"](_t(ms["x"]).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=0.05)


def test_define_g_is_batchnorm_whatever_norm_says():
    # the reference's define_G quirk: multiscale always runs BatchNorm
    g = define_g("multiscale", 1, 1, 4, 1, 1, norm="instance")
    assert isinstance(g, MultiscaleGlobalGenerator)
    assert isinstance(g.res[0].norm1, BatchNorm)
    assert isinstance(g.b1_stem.norm, BatchNorm)


def test_batchnorm_refuses_train_mode():
    # train mode is ported now (the pix2pixHD train step): the layer starts
    # in eval mode, at statistics (0, 1), and train() switches every
    # BatchNorm of the generator to the batch's statistics
    g = define_g("multiscale", 1, 1, 4, 1, 1)
    bn = BatchNorm(3)
    assert not bn.training and not g.b1_stem.norm.training
    assert bn.eval() is bn
    torch.testing.assert_close(bn.running_var, torch.ones(3))
    torch.testing.assert_close(bn.running_mean, torch.zeros(3))
    assert g.train() is g and g.res[0].norm1.training
    x = torch.randn(2, 3, 4, 3) * 3 + 1
    with torch.no_grad():
        y = bn.train()(x)
    torch.testing.assert_close(y.mean(dim=(0, 1, 2)) / bn.weight,
                               bn.bias / bn.weight, atol=1e-5, rtol=0)
    assert not torch.equal(bn.running_mean, torch.zeros(3))


# --------------------------------------------------------------------------- #
# quantize_resblock_bn and the plain K1 / K7 with bn=True
# --------------------------------------------------------------------------- #
def _jax_block(ms, i=0):
    return ms["p"][f"res_{i}"], ms["stats"][f"res_{i}"]


def test_quantize_resblock_bn_matches_jax(ms):
    # int8 taps equal; sb within one fp32 ulp of the value (the fold's
    # sqrt / division / products are IEEE in both; 0 ulps measured)
    jq = qp.quantize_resblock_bn(*_jax_block(ms))
    tq = qi.quantize_resblock_bn(ms["g"].res[0])
    for k in ("w1q", "w2q"):
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    ref = np.asarray(jq["sb"])
    np.testing.assert_allclose(tq["sb"].numpy(), ref, rtol=F32_ULP, atol=0)
    # the CUDA operand holds the same int8: (Cout, 9·Cin), k = tap·Cin + c
    np.testing.assert_array_equal(
        tq["w1k"].numpy(),
        tq["w1q"].permute(2, 0, 1).reshape(tq["w1q"].shape[2], -1).numpy())


@pytest.fixture(scope="module")
def trunk(ms):
    """The generator's own trunk activation (2, 8, 8, 64) and its first
    block quantized in both packages."""
    with torch.no_grad():
        h = fi.multiscale_encode(ms["g"], _t(ms["x"]))
    jq = qp.quantize_resblock_bn(*_jax_block(ms))
    return h, jq, qi.quantize_resblock_bn(ms["g"].res[0])


def test_k1_bn_plain_matches_emulation_and_interpret(trunk):
    # fp32 carrier. With bn there is no statistic: the same int8 math and
    # the same fp32 ops in the same order, so equal to the emulation. The
    # interpreted TPU kernel within 1e-5 (1.4e-6 measured: XLA rewrites its
    # traced amax / 127.0, see tests/test_torch_p2phd.py)
    h, jq, tq = trunk
    got = qi.resblock_int8_bf16io_plain(h, tq, bn=True).numpy()
    hj = jnp.asarray(h.numpy())
    np.testing.assert_array_equal(
        got, np.asarray(qp._resblock_int8_bf16io_emulate(hj, jq, bn=True)))
    np.testing.assert_allclose(
        got, np.asarray(qp._run_resblock_int8_bf16io(hj, jq, interpret=True,
                                                     bn=True)),
        rtol=0, atol=1e-5)
    # bn=False is another function of the same weights
    assert not np.allclose(got, qi.resblock_int8_bf16io_plain(h, tq).numpy())


def test_k1_bn_plain_bf16_carrier(trunk):
    # bf16 carrier in and out: the same math, one bf16 rounding at the end;
    # equal to the emulation
    h, jq, tq = trunk
    got = qi.resblock_int8_bf16io_plain(h.bfloat16(), tq, bn=True)
    ref = qp._resblock_int8_bf16io_emulate(
        jnp.asarray(h.numpy()).astype(jnp.bfloat16), jq, bn=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def _jax_tiled_a_bn(hx, qblk, ct):
    """Kernel A of ``_run_resblock_int8_tiled`` with ``bn=True`` alone (its
    first pallas_call, quant_pallas.py:519-531), in interpret mode: (rq,
    (n, t) rs)."""
    n, h, w, c = hx.shape
    t = c // ct
    hq, hs = qp.quantize_act(hx)
    vm, sm = pltpu.VMEM, pltpu.SMEM
    rq, rs = pl.pallas_call(
        functools.partial(qp._resblock_a_kernel, h=h, w=w, c=c, ct=ct,
                          eps=qp._EPS, bn=True),
        grid=(n, t),
        in_specs=[pl.BlockSpec((1, h, w, c), lambda i, j: (i, 0, 0, 0),
                               memory_space=vm),
                  pl.BlockSpec((1, 1, 1), lambda i, j: (i, 0, 0),
                               memory_space=sm),
                  pl.BlockSpec((9, c, ct), lambda i, j: (0, 0, j),
                               memory_space=vm),
                  pl.BlockSpec((4, ct), lambda i, j: (0, j), memory_space=vm)],
        out_specs=(pl.BlockSpec((1, h, w, ct), lambda i, j: (i, 0, 0, j),
                                memory_space=vm),
                   pl.BlockSpec((1, 1, 1), lambda i, j: (i * t + j, 0, 0),
                                memory_space=sm)),
        out_shape=(jax.ShapeDtypeStruct((n, h, w, c), jnp.int8),
                   jax.ShapeDtypeStruct((n * t, 1, 1), jnp.float32)),
        interpret=True,
    )(hq, hs.reshape(n, 1, 1), qblk["w1q"], qblk["sb"])
    return np.asarray(rq), np.asarray(rs).reshape(n, t)


def _jax_tiled_rq_bn(hx, qblk, ct):
    """K7a's (rq, rs) as ``_resblock_int8_tiled_emulate`` computes them with
    ``bn=True`` (quant_pallas.py:572-579)."""
    n, h, w, c = hx.shape
    hq, hs = qp.quantize_act(hx)
    xp = jnp.pad(hq, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    acc = sum(jnp.einsum("npi,io->npo",
                         xp[:, k // 3:k // 3 + h, k % 3:k % 3 + w]
                         .reshape(n, h * w, c).astype(jnp.int32),
                         qblk["w1q"][k].astype(jnp.int32)) for k in range(9))
    sb = qblk["sb"]
    f = acc.astype(jnp.float32) * (hs[:, :, None] * sb[0][None, None]) \
        + sb[1][None, None]
    r = jnp.maximum(f, 0.0).reshape(n, h * w, c // ct, ct)
    rmax = jnp.maximum(jnp.max(jnp.abs(r), axis=(1, 3), keepdims=True), 1e-6)
    rq = jnp.clip(jnp.round(r * (127.0 / rmax)), -127, 127).astype(jnp.int8)
    return (np.asarray(rq).reshape(n, h, w, c),
            np.asarray(rmax / 127.0).reshape(n, c // ct))


def test_k7_bn_plain_matches_emulation_and_interpret(trunk):
    # K7a: the int8 rq equals the emulation's and the interpreted TPU
    # kernel A's; the tile scales equal the emulation's, and the
    # interpreted kernel's within an ulp (XLA rewrites the traced kernel's
    # amax / 127.0 into a multiply, see tests/test_torch_p2phd.py; 1.1e-7
    # relative measured). The block: K7b on those, fp32, equal to the
    # emulation, and within 1e-5 of both TPU kernels in interpret mode
    # (9.5e-7 measured).
    h, jq, tq = trunk
    hj, ct = jnp.asarray(h.numpy()), 16
    rq, rs = qi.resblock_tiled_a_plain(h, tq, ct, bn=True)
    erq, ers = _jax_tiled_rq_bn(hj, jq, ct)
    np.testing.assert_array_equal(rq.numpy(), erq)
    np.testing.assert_array_equal(rs.numpy(), ers)
    irq, irs = _jax_tiled_a_bn(hj, jq, ct)
    np.testing.assert_array_equal(rq.numpy(), irq)
    np.testing.assert_allclose(rs.numpy(), irs, rtol=F32_ULP, atol=0)
    got = qi.resblock_tiled_b_plain(rq, rs, h, tq, ct, bn=True).numpy()
    assert np.array_equal(
        got, qi.resblock_int8_tiled_plain(h, tq, ct, bn=True).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(qp._resblock_int8_tiled_emulate(hj, jq, ct, bn=True)))
    np.testing.assert_allclose(
        got, np.asarray(qp._run_resblock_int8_tiled(hj, jq, ct,
                                                    interpret=True, bn=True)),
        rtol=0, atol=1e-5)


def test_bn_chains_match_jax(trunk):
    # both chains, two blocks each, bn=True: fp32, equal to the emulation
    h, jq, tq = trunk
    hj = jnp.asarray(h.numpy())
    for ref, got in (
            (qp.resblock_chain_int8_bf16io(hj, [jq, jq], force_emulate=True,
                                           bn=True),
             qi.resblock_chain_int8_bf16io(h, [tq, tq], bn=True)),
            (qp.resblock_chain_int8_tiled(hj, [jq, jq], cout_tile=16,
                                          force_emulate=True, bn=True),
             qi.resblock_chain_int8_tiled(h, [tq, tq], cout_tile=16,
                                          bn=True))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_dispatch_bn_uses_plain_and_launches_nothing(trunk):
    kr.reset_launches()
    kt.reset_launches()
    h, _, tq = trunk
    assert torch.equal(qi.resblock_int8_bf16io(h, tq, bn=True),
                       qi.resblock_int8_bf16io_plain(h, tq, bn=True))
    assert torch.equal(qi.resblock_int8_tiled(h, tq, 16, bn=True),
                       qi.resblock_int8_tiled_plain(h, tq, 16, bn=True))
    assert all(v == 0 for v in (*kr.launches.values(), *kt.launches.values()))
    assert {"resblock_int8_bf16io_bn", "resblock_int8_tiled_a_bn",
            "resblock_int8_tiled_b_bn"} <= {*kr.launches, *kt.launches}


# --------------------------------------------------------------------------- #
# The int8 engine and the inference engine
# --------------------------------------------------------------------------- #
def _jax_int8(ms, cout_tile=None):
    fwd = jax.jit(lambda p, q, x, s: jfi.multiscale_global_int8_apply(
        p, q, x, s, n_blocks=NB, cout_tile=cout_tile))
    q = jfi.quantize_multiscale_global(ms["p"], ms["stats"], NB)
    return np.asarray(fwd(ms["p"], q, jnp.asarray(ms["x"]), ms["stats"]))


def test_int8_engine_k1_route_matches_jax(ms):
    # the trunk fits whole-image (K1, bn=True); fp32, int8 tensors equal,
    # the convs' sum order left (1.1e-6 measured)
    g = ms["g"]
    assert qi.whole_image_resblock_fits(8, 8, 8 * NGF)
    ref = _jax_int8(ms)
    with torch.no_grad():
        got = fi.multiscale_global_int8_apply(
            g, fi.quantize_multiscale_global(g), _t(ms["x"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # within the trunk family budget (0.35) of the fp32 forward (0.040
    # measured)
    assert np.abs(got - _jax_forward(ms, ms["x"])).max() < 0.35


def test_int8_engine_tiled_route_matches_jax(ms, monkeypatch):
    # the K7 route (bn=True), forced in both packages as the chip's 512²
    # trunk takes it, with the tile passed to both (ROADMAP queue 3);
    # 1.1e-6 measured
    g = ms["g"]
    monkeypatch.setattr(qp, "whole_image_resblock_fits", lambda h, w, c: False)
    monkeypatch.setattr(fi, "whole_image_resblock_fits", lambda h, w, c: False)
    routes = []
    monkeypatch.setattr(fi, "resblock_chain_int8_tiled",
                        lambda *a: routes.append(a[2:]) or
                        qi.resblock_chain_int8_tiled(*a))
    ref = _jax_int8(ms, cout_tile=16)
    with torch.no_grad():
        got = fi.multiscale_global_int8_apply(
            g, fi.quantize_multiscale_global(g), _t(ms["x"]),
            cout_tile=16).numpy()
    assert routes == [(16, True)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_bn_affine_matches_jax(ms):
    # the int8 engine's BatchNorm order: γ·rsqrt(σ²+ε), β − μ·g, v·g + b
    # (1e-6, rsqrt may differ by an ulp between the libraries; equal
    # measured)
    rng = np.random.RandomState(6)
    v = _rand(rng, 2, 4, 4, NGF)
    norm = ms["g"].b1_stem.norm
    ref = jfi._bn_affine(ms["p"]["b1_stem"]["norm"],
                         ms["stats"]["b1_stem"]["norm"], jnp.asarray(v))
    got = fi._bn_affine(norm, _t(v))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_engine_matches_jax(ms):
    # fp32 compute: infer_step and infer_step_int8 of both engines on the
    # same params, statistics and labels (2.5e-6 / 1.1e-6 measured)
    p, s, x = ms["p"], ms["stats"], ms["x"]
    kw = dict(ngf=NGF, n_blocks_global=NB)
    jeng = Pix2PixHD(net_g="multiscale", compute_dtype=jnp.float32, **kw)
    teng = Pix2PixHDInference("multiscale", compute_dtype=torch.float32,
                              device="cpu", **kw)
    with pytest.raises(ValueError, match="g_stats"):
        teng.load_jax_params(p)
    with pytest.raises(ValueError, match="g_stats"):
        jeng.quantize_generator(p)
    teng.load_jax_params(p, s)
    label = jnp.asarray(x)
    pairs = [(jeng.infer_step(p, label, g_stats=s), teng.infer_step(_t(x))),
             (jeng.infer_step_int8(p, jeng.quantize_generator(p, s), label,
                                   g_stats=s),
              teng.infer_step_int8(teng.quantize_generator(), _t(x)))]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)
