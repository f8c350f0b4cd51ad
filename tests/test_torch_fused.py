"""The fused-kernel paths of the port (``cistar_tpu_torch/ops/fused.py``,
``ops/head_conv.py``, ``models/fast_infer.py``) against the JAX package on
the CPU: the plain versions of K3, K4 and K9 against the Pallas kernels,
the bf16 fast forwards, and the int8 engines under the two switches
(``_FUSED_STAGE_IN``, ``_HEAD_KERNEL``).

``fused_conv3x3_in_act`` and ``fused_instance_norm_act`` take no
``interpret`` argument and take their fallback off a TPU. The
``tpu_interpret`` fixture runs their Pallas bodies here: for the duration
of a test, ``pallas_call`` always interprets and ``jax.devices()[0]``
says "tpu" (both restored by ``monkeypatch``). The K9 kernels take
``interpret=True`` themselves. Nothing in the JAX package changes.

The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``.
"""

import functools

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.models import fast_infer as jfi
from cistar_tpu.models.cyclegan import ResnetGenerator as JaxResnet
from cistar_tpu.models.cyclegan import \
    MultiscaleBilinearGenerator as JaxBilinear
from cistar_tpu.models.pix2pixhd import GlobalGenerator as JaxGlobal
from cistar_tpu.ops import head_conv as jhc
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import pallas_kernels as jpk
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu_torch.core.convert import (conv_w_from_hwio, generator_from_jax,
                                           global_generator_from_jax,
                                           resnet_generator_from_jax)
from cistar_tpu_torch.kernels import fused_conv as kf
from cistar_tpu_torch.kernels import head_cout1 as kh
from cistar_tpu_torch.kernels import in_act as kn
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.cyclegan import (MultiscaleBilinearGenerator,
                                              ResnetGenerator)
from cistar_tpu_torch.models.pix2pixhd import GlobalGenerator
from cistar_tpu_torch.ops import fused
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.head_conv import head_conv_tanh_pallas
from cistar_tpu_torch.ops.quant_int8 import quantize_resnet_trunk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


class _Tpu:
    platform = "tpu"


class _Cpu:
    platform = "cpu"


def _interpret_everything(monkeypatch):
    orig = jpl.pallas_call

    @functools.wraps(orig)
    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpl, "pallas_call", call)


@pytest.fixture
def tpu_interpret(monkeypatch):
    """The JAX package's TPU routing, its Pallas kernels interpreted."""
    _interpret_everything(monkeypatch)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Tpu()])


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` interpreted, the platform left as it is."""
    _interpret_everything(monkeypatch)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bump(tree, rng):
    # nonzero biases, so that the bias mapping matters
    return jax.tree.map(
        lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), tree)


def _close(got, ref, dtype, atol=1e-5):
    """fp32: within ``atol``. bf16: within one bf16 ulp of the output
    (plus 1e-6 for outputs within an fp32 rounding of 0)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    else:
        assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6), \
            np.abs(got - ref).max()


# --------------------------------------------------------------------------- #
# K4: fused_instance_norm_act
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky", "tanh"])
def test_k4_plain_matches_pallas_body(tpu_interpret, act, res, dtype):
    # the Pallas body (_in_act_kernel / _in_act_res_kernel) in interpret
    # mode: fp32 sum order only (fp32 within 1e-5; bf16 within one ulp)
    rng = np.random.RandomState(len(act) + 2 * res)
    x = _rand(rng, 2, 8, 12, 16, scale=2.0) + 0.5
    r = _rand(rng, 2, 8, 12, 16) if res else None
    jdt, tdt = DTYPES[dtype]
    ref = jpk.fused_instance_norm_act(
        jnp.asarray(x).astype(jdt), act=act,
        residual=None if r is None else jnp.asarray(r).astype(jdt))
    got = fused.fused_instance_norm_act(
        _t(x).to(tdt), act, residual=None if r is None else _t(r).to(tdt))
    assert got.dtype == tdt
    _close(got, ref, dtype)


@pytest.mark.parametrize("res", [False, True])
def test_k4_over_budget_is_the_composition(tpu_interpret, res):
    # over the TPU kernel's budget (fp32: 32 × 64 × 512 is 4 MiB an image,
    # over 2 MiB; 32² × 512 with a residual is 2 MiB, over 1 MiB) both
    # packages run the composition, single-pass IN (fp32, order of sums:
    # 2.6e-6 measured)
    rng = np.random.RandomState(5)
    shape = (1, 32, 32, 512) if res else (1, 32, 64, 512)
    x = _rand(rng, *shape, scale=2.0)
    r = _rand(rng, *shape) if res else None
    xt, rt = _t(x), None if r is None else _t(r)
    assert not fused.in_act_fits(xt, rt)
    ref = jpk.fused_instance_norm_act(
        jnp.asarray(x), act="leaky",
        residual=None if r is None else jnp.asarray(r))
    got = fused.fused_instance_norm_act(xt, "leaky", residual=rt)
    _close(got, ref, "fp32")
    assert torch.equal(got, fused._in_act_composition(xt, "leaky", 1e-5, 0.2,
                                                      rt))


def test_k4_residual_tanh_follows_the_kernel(tpu_interpret, monkeypatch):
    # A fault of the reference (ROADMAP queue 3): _in_act_res_kernel has no
    # tanh branch, its fallback applies tanh after the residual, so the JAX
    # package gives other numbers on a TPU and off it. The port follows the
    # kernel; the two JAX answers differ by 3.67 here (measured).
    rng = np.random.RandomState(7)
    x, r = _rand(rng, 2, 8, 8, 16, scale=2.0), _rand(rng, 2, 8, 8, 16)
    kernel = np.asarray(jpk.fused_instance_norm_act(
        jnp.asarray(x), act="tanh", residual=jnp.asarray(r)))
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Cpu()])
    fallback = np.asarray(jpk.fused_instance_norm_act(
        jnp.asarray(x), act="tanh", residual=jnp.asarray(r)))
    got = fused.fused_instance_norm_act(_t(x), "tanh", residual=_t(r))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=1e-5)
    assert np.abs(fallback - kernel).max() > 0.5
    np.testing.assert_allclose(np.tanh(kernel), fallback, rtol=0, atol=1e-5)


def test_instance_norm_act_is_k4():
    rng = np.random.RandomState(8)
    x = _t(_rand(rng, 2, 6, 6, 8))
    assert torch.equal(tnn.instance_norm_act(x, "leaky"),
                       fused.fused_instance_norm_act_plain(x, "leaky"))


def test_leaky_relu_matches_jax():
    x = np.linspace(-2, 2, 41, dtype=np.float32)
    np.testing.assert_array_equal(tnn.leaky_relu(_t(x), 0.2).numpy(),
                                  np.asarray(jnn.leaky_relu(jnp.asarray(x),
                                                            0.2)))


def test_k4_stage_rule_at_256():
    # the ResNet int8 engine at 256² in bf16: of its six stage norms, down_1,
    # down_2 and up_0 fit the TPU kernel: 3 K4 launches per generator call
    shapes = [(1, 256, 256, 64), (1, 128, 128, 128), (1, 64, 64, 256),
              (1, 32, 32, 512), (1, 64, 64, 256), (1, 128, 128, 128)]
    fits = [fused.in_act_fits(torch.empty(s, dtype=torch.bfloat16,
                                          device="meta")) for s in shapes]
    assert fits == [False, False, True, True, True, False]


# --------------------------------------------------------------------------- #
# K3: fused_conv3x3_in_act
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("pad", ["reflect", "zero"])
def test_k3_plain_bf16_matches_pallas_body(tpu_interpret, pad, act, res):
    # bf16 x and weights: exact products, fp32 sums in another order, one
    # cast: within one bf16 ulp (the body and JAX's own fallback differ by
    # a bf16 ulp: test_interpret_patch_runs_the_pallas_bodies)
    rng = np.random.RandomState(3 * len(pad) + len(act) + res)
    x = _rand(rng, 2, 16, 16, 32)
    w, b = _rand(rng, 3, 3, 32, 24, scale=0.1), _rand(rng, 24, scale=0.1)
    r = _rand(rng, 2, 16, 16, 24) if res else None
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jpk.fused_conv3x3_in_act(
        xb, jnp.asarray(w).astype(jnp.bfloat16),
        jnp.asarray(b).astype(jnp.bfloat16), act=act, pad_mode=pad,
        residual=None if r is None else jnp.asarray(r).astype(jnp.bfloat16))
    tw = _t(conv_w_from_hwio(w)).bfloat16()
    got = fused.fused_conv3x3_in_act(
        _t(x).bfloat16(), tw, _t(b).bfloat16(), act,
        None if r is None else _t(r).bfloat16(), pad)
    assert got.dtype == torch.bfloat16
    _close(got, ref, "bf16")


def test_interpret_patch_runs_the_pallas_bodies(tpu_interpret, monkeypatch):
    # under tpu_interpret JAX's K3 runs its Pallas body, which rounds
    # otherwise than its CPU fallback (0.031 at this shape, measured): the
    # tests above compare with the body
    rng = np.random.RandomState(13)
    x = jnp.asarray(_rand(rng, 2, 16, 16, 32)).astype(jnp.bfloat16)
    w = jnp.asarray(_rand(rng, 3, 3, 32, 24, scale=0.1)).astype(jnp.bfloat16)
    body = np.asarray(jpk.fused_conv3x3_in_act(x, w).astype(jnp.float32))
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Cpu()])
    fallback = np.asarray(jpk.fused_conv3x3_in_act(x, w).astype(jnp.float32))
    assert np.abs(body - fallback).max() > 0


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("pad", ["reflect", "zero"])
def test_k3_plain_fp32_matches_pallas_body(tpu_interpret, pad, res):
    # fp32: order of sums only (1.6e-6 measured)
    rng = np.random.RandomState(11 + res)
    x = _rand(rng, 2, 12, 10, 16)
    w, b = _rand(rng, 3, 3, 16, 16, scale=0.1), _rand(rng, 16, scale=0.1)
    r = _rand(rng, 2, 12, 10, 16) if res else None
    ref = jpk.fused_conv3x3_in_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act="relu",
        pad_mode=pad, residual=None if r is None else jnp.asarray(r))
    got = fused.fused_conv3x3_in_act(
        _t(x), _t(conv_w_from_hwio(w)), _t(b), "relu",
        None if r is None else _t(r), pad)
    _close(got, ref, "fp32")


def test_k3_over_budget_is_the_composition(tpu_interpret):
    # 512 channels with fp32 weights: 9.4 MB of weights alone, over the
    # 9 MiB rule; both packages run conv → IN → + residual (fp32: order of
    # sums, 2.5e-6 measured, within 1e-4)
    rng = np.random.RandomState(12)
    x = _rand(rng, 1, 4, 4, 512)
    w, b = _rand(rng, 3, 3, 512, 512, scale=0.02), _rand(rng, 512, scale=0.1)
    r = _rand(rng, 1, 4, 4, 512)
    tw = _t(conv_w_from_hwio(w))
    assert not fused.conv3x3_in_act_fits(_t(x), tw)
    ref = jpk.fused_conv3x3_in_act(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), act="none",
                                   residual=jnp.asarray(r))
    got = fused.fused_conv3x3_in_act(_t(x), tw, _t(b), "none", _t(r))
    _close(got, ref, "fp32", atol=1e-4)
    assert torch.equal(got, fused._conv_in_act_composition(
        _t(x), tw, _t(b), "none", _t(r), "reflect", 1e-5))


def test_k3_rule_reads_the_weight_dtype():
    # ResNet-9 trunk, 32² × 512: bf16 weights 8.0 MB fit, fp32 12.7 MB not;
    # the 1024-channel global trunk never fits; a residual of another shape
    # sends the call to the composition
    def fits(c, wdt, res_shape=None):
        x = torch.empty(1, 32, 32, c, dtype=torch.bfloat16, device="meta")
        w = torch.empty(c, c, 3, 3, dtype=wdt, device="meta")
        r = None if res_shape is None else torch.empty(res_shape,
                                                        device="meta")
        return fused.conv3x3_in_act_fits(x, w, r)
    assert fits(512, torch.bfloat16)
    assert not fits(512, torch.float32)
    assert not fits(1024, torch.bfloat16)
    assert not fits(512, torch.bfloat16, (1, 32, 32, 256))


# --------------------------------------------------------------------------- #
# K9: the cout=1 7×7 reflect head conv
# --------------------------------------------------------------------------- #
def _k9_jax(name, x, w, b, act):
    if name == "pallas_pre_in":
        return jhc.head_conv_tanh_pallas(x, w, b, act=act, pre_in=True,
                                         interpret=True)
    if name == "pallas":
        return jhc.head_conv_tanh_pallas(x, w, b, act=act, interpret=True)
    return getattr(jpk, name)(x, w, b, act=act, interpret=True)


def _k9_port(name, x, w, b, act):
    if name.startswith("pallas"):
        return head_conv_tanh_pallas(x, w, b, act, pre_in=name.endswith("in"))
    return getattr(fused, name)(x, w, b, act)


@pytest.mark.parametrize("act", ["tanh", "none"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["conv2d_reflect_cout1",
                                  "conv2d_reflect_cout1_masked",
                                  "conv2d_reflect_cout1_loop", "pallas",
                                  "pallas_pre_in"])
def test_k9_plain_matches_pallas(name, dtype, act):
    # taps rounded to x.dtype, fp32 tap sums in another order: fp32 within
    # 1e-5 (2.9e-6 measured), bf16 within one ulp
    rng = np.random.RandomState(len(name) + len(act))
    x = _rand(rng, 2, 16, 24, 8, scale=1.5) + 0.3
    w, b = _rand(rng, 7, 7, 8, 1, scale=0.05), _rand(rng, 1, scale=0.1)
    jdt, tdt = DTYPES[dtype]
    ref = _k9_jax(name, jnp.asarray(x).astype(jdt), jnp.asarray(w),
                  jnp.asarray(b), act)
    got = _k9_port(name, _t(x).to(tdt), _t(conv_w_from_hwio(w)), _t(b), act)
    assert got.dtype == tdt and tuple(got.shape) == (2, 16, 24, 1)
    _close(got, ref, dtype)


def test_k9_refuses_other_shapes():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="7, 7"):
        fused.conv2d_reflect_cout1(x, torch.zeros(2, 4, 7, 7))
    with pytest.raises(ValueError, match="H, W > 3"):
        fused.conv2d_reflect_cout1(torch.zeros(1, 3, 8, 4),
                                   torch.zeros(1, 4, 7, 7))


def test_cpu_dispatch_uses_plain_and_launches_nothing():
    rng = np.random.RandomState(9)
    x = _t(_rand(rng, 1, 8, 8, 16))
    w3, w7 = _t(_rand(rng, 16, 16, 3, 3, scale=0.1)), \
        _t(_rand(rng, 1, 16, 7, 7, scale=0.05))
    for m in (kf, kn, kh):
        m.reset_launches()
    assert torch.equal(fused.fused_conv3x3_in_act(x, w3),
                       fused.fused_conv3x3_in_act_plain(x, w3))
    assert torch.equal(fused.fused_instance_norm_act(x, "relu"),
                       fused.fused_instance_norm_act_plain(x, "relu"))
    assert torch.equal(fused.conv2d_reflect_cout1_loop(x, w7),
                       fused.conv2d_reflect_cout1_plain(x, w7))
    assert all(v == 0 for m in (kf, kn, kh) for v in m.launches.values())


# --------------------------------------------------------------------------- #
# The bf16 fast forwards
# --------------------------------------------------------------------------- #
NB, F, SIZE, BATCH = 2, 8, 32, 2


@pytest.fixture(scope="module")
def resnet():
    rng = np.random.RandomState(4)
    x = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    jg = JaxResnet(1, NB, F)
    p = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"]), rng)
    g = ResnetGenerator(1, 1, NB, F)
    g.load_state_dict(resnet_generator_from_jax(p))
    return x, p, g.eval()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_resnet_fast_apply_matches_jax(tpu_interpret, resnet, dtype):
    # K3's body in JAX, its plain version here. fp32: order of sums (1e-4).
    # bf16 (bf16 weights on both sides): the two frameworks round the bf16
    # stem / down / up convs at other points: the bf16 generator's 0.05
    x, p, g = resnet
    jdt, tdt = DTYPES[dtype]
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    ref = jfi.resnet_generator_fast_apply(pj, jnp.asarray(x).astype(jdt), NB)
    gt = ResnetGenerator(1, 1, NB, F).to(tdt)
    gt.load_state_dict(g.state_dict())
    with torch.no_grad():
        got = fi.resnet_generator_fast_apply(gt, _t(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=0,
        atol=1e-4 if dtype == "fp32" else 0.05)


def test_resnet_fast_apply_weight_dtype_routing(tpu_interpret):
    # ResNet-9 width (64 features → a 512-channel trunk), one block, 32²:
    # with bf16 weights the trunk runs K3 (the body in JAX, the plain
    # version here), with fp32 weights and a bf16 input the composition,
    # in both packages; each within the bf16 generator's 0.05 of JAX
    rng = np.random.RandomState(6)
    x = (rng.rand(1, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    jg = JaxResnet(1, 1, 64)
    p = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(1),
                                   jnp.asarray(x))["params"]), rng)
    g = ResnetGenerator(1, 1, 1, 64)
    g.load_state_dict(resnet_generator_from_jax(p))
    h = torch.empty(1, 4, 4, 512, dtype=torch.bfloat16, device="meta")
    for wdt, jwdt, k3 in ((torch.bfloat16, jnp.bfloat16, True),
                          (torch.float32, jnp.float32, False)):
        c1 = g.res[0].conv1.weight.to(wdt)
        assert fused.conv3x3_in_act_fits(h, c1) is k3
        pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jwdt), p)
        ref = jfi.resnet_generator_fast_apply(
            pj, jnp.asarray(x).astype(jnp.bfloat16), 1)
        with torch.no_grad():
            got = fi.resnet_generator_fast_apply(g.to(wdt),
                                                 _t(x).bfloat16())
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=0, atol=0.05)


def test_global_fast_apply_matches_jax(tpu_interpret):
    # GlobalGenerator, ngf 8, 2 downs, 2 blocks (32 channels at 8², K3 on
    # both sides); fp32, order of sums (1e-4)
    rng = np.random.RandomState(10)
    x = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    jg = JaxGlobal(1, 8, 2, 2)
    p = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"]), rng)
    g = GlobalGenerator(1, 1, 8, 2, 2)
    g.load_state_dict(global_generator_from_jax(p))
    ref = jfi.global_generator_fast_apply(p, jnp.asarray(x), 2, 2)
    with torch.no_grad():
        got = fi.global_generator_fast_apply(g.eval(), _t(x))
        fwd = g(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# The int8 engines under the switches
# --------------------------------------------------------------------------- #
def _switch(monkeypatch, name, value):
    monkeypatch.setattr(jfi, name, value)
    monkeypatch.setattr(fi, name, value)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_engine_fused_stage_in_matches_jax(tpu_interpret, monkeypatch,
                                               resnet, dtype):
    # CISTAR_FUSED_STAGE_IN=1: at 32² every stage norm fits K4 (six calls),
    # the Pallas body in JAX (its trunk emulated), the plain K4 here.
    # fp32: order of sums (1e-4); bf16: the engine budget 0.1, as without
    # the switch
    _switch(monkeypatch, "_FUSED_STAGE_IN", "1")
    x, p, g = resnet
    jdt, tdt = DTYPES[dtype]
    q = qp.quantize_resnet_trunk(p, NB)
    ref = jfi.resnet_generator_int8_trunk_apply(
        p, q, jnp.asarray(x).astype(jdt), NB, force_emulate=True)
    with torch.no_grad():
        got = fi.resnet_generator_int8_trunk_apply(
            g, quantize_resnet_trunk(g), _t(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=1e-4 if dtype == "fp32" else 0.1)


@pytest.mark.parametrize("variant", ["tap_matmul", "loop", "maskedloop",
                                     "masked", "shift", "xla"])
def test_int8_engine_head_variants_match_jax(tpu_interpret, monkeypatch,
                                             resnet, variant):
    # CISTAR_HEAD_KERNEL: the stage IN+ReLU, then the head through the K9
    # kernel (interpreted in JAX, the plain K9 here) or the plain heads
    # (shift, xla); fp32, order of sums (1e-4)
    _switch(monkeypatch, "_HEAD_KERNEL", variant)
    x, p, g = resnet
    q = qp.quantize_resnet_trunk(p, NB)
    ref = jfi.resnet_generator_int8_trunk_apply(p, q, jnp.asarray(x), NB,
                                                force_emulate=True)
    with torch.no_grad():
        got = fi.resnet_generator_int8_trunk_apply(
            g, quantize_resnet_trunk(g), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_head_variant_unknown_raises(monkeypatch, resnet):
    _switch(monkeypatch, "_HEAD_KERNEL", "bogus")
    x, p, g = resnet
    with pytest.raises(ValueError, match="not a known head-conv variant"):
        jfi._head_conv_tanh(jnp.zeros((1, 32, 32, F)), p["out_conv"],
                            raw_in=True)
    with pytest.raises(ValueError, match="not a known head-conv variant"):
        fi._head_conv_tanh(torch.zeros(1, 32, 32, F), g.out_conv,
                           raw_in=True)


@pytest.fixture(scope="module")
def bilinear():
    rng = np.random.RandomState(14)
    x = (rng.rand(BATCH, 64, 64, 1) * 2 - 1).astype(np.float32)
    jg = JaxBilinear(output_nc=1, n_residual_blocks=NB, in_features=4)
    p = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"]), rng)
    g = MultiscaleBilinearGenerator(1, 1, NB, 4)
    g.load_state_dict(generator_from_jax(p))
    return x, p, g.eval()


def test_bilinear_engine_head_variant_matches_jax(interpret, monkeypatch,
                                                  bilinear):
    # bilinear_content with the tap_matmul head: its stem and decoder norms
    # stay plain (as in JAX), its head runs the K9 kernel (interpreted in
    # JAX, plain here); fp32, order of sums (1e-4)
    _switch(monkeypatch, "_HEAD_KERNEL", "tap_matmul")
    x, p, g = bilinear
    ref = jfi.bilinear_generator_int8_trunk_apply(
        p, jfi.quantize_bilinear_trunk(p, NB), jnp.asarray(x), NB)
    with torch.no_grad():
        got = fi.bilinear_generator_int8_trunk_apply(
            g, fi.quantize_bilinear_trunk(g), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_fused_stage_in_reaches_only_the_resnet_engine(monkeypatch, resnet,
                                                       bilinear):
    # JAX calls _stage_in_relu only in the ResNet engine (and in the head's
    # non-default variants): under the switch the bilinear and global
    # engines make no K4 call, the ResNet engine one per stage norm (six at
    # 32²: every stage fits)
    calls = []

    def counting(h, act="none", **kw):
        calls.append(tuple(h.shape))
        return fused.fused_instance_norm_act(h, act, **kw)

    monkeypatch.setattr(fi, "fused_instance_norm_act", counting)
    monkeypatch.setattr(fi, "_FUSED_STAGE_IN", "1")
    xb, _, gb = bilinear
    xr, _, gr = resnet
    gg = GlobalGenerator(1, 1, 4, 1, 1).eval()
    with torch.no_grad():
        fi.bilinear_generator_int8_trunk_apply(
            gb, fi.quantize_bilinear_trunk(gb), _t(xb))
        fi.global_generator_int8_trunk_apply(gg, qi.quantize_global_trunk(gg),
                                             _t(xr))
        assert calls == []
        fi.resnet_generator_int8_trunk_apply(gr, quantize_resnet_trunk(gr),
                                             _t(xr))
    assert len(calls) == 6
