"""The port's other CycleGAN generators — 'atrous'
(``MultiscaleDenseDecoderGenerator`` and ``MultiscaleGenerator``) and
'unet' (``UnetGenerator``) — with their primitives, their int8 engines on
the plain K1 / K6, the inference and training engines, the VGG16 content
loss and the two CycleGAN CLIs, against the JAX package on the CPU.

Weights come from the JAX engine's init, carried across by
``core/convert.py``; inputs from numpy seeds. One JAX engine a family
serves every test of that family (its programs compile once). The CUDA
kernels themselves are compared with their plain versions on the card by
``chip_smoke.py``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.engines.cyclegan import CycleGAN as JaxCycleGAN
from cistar_tpu.engines.cyclegan import CycleGANState as JaxCycleGANState
from cistar_tpu.losses import perceptual as jperc
from cistar_tpu.models import fast_infer as jfi
from cistar_tpu.models import vgg as jvgg
from cistar_tpu.models.cyclegan import build_generator as jax_build_generator
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu.ops.blocks import \
    MultiAtrousTransposeConv as JaxMultiAtrousTransposeConv
from cistar_tpu_torch.apps import cyclegan_test, cyclegan_train
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.core.convert import (generator_from_jax,
                                           generator_to_jax)
from cistar_tpu_torch.engines.cyclegan import CycleGAN, CycleGANInference
from cistar_tpu_torch.kernels import (fused_conv, head_cout1, in_act,
                                      int8_atrous, int8_msrb, int8_resblock,
                                      int8_tiled)
from cistar_tpu_torch.losses.gan import l1_loss
from cistar_tpu_torch.losses.perceptual import make_content_criterion
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models import vgg
from cistar_tpu_torch.models.cyclegan import (MultiscaleDenseDecoderGenerator,
                                              MultiscaleGenerator,
                                              UnetGenerator, build_generator,
                                              seeded_generator)
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import MultiAtrousTransposeConv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bump(tree, rng):
    # nonzero biases, so that the bias rows and the bias mapping matter
    return jax.tree.map(
        lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), tree)


# --------------------------------------------------------------------------- #
# Primitives: the dilated transpose conv and MultiAtrousTransposeConv
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rate", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv_transpose2d_dilated(rate, dtype):
    # JAX: input-dilated conv with the flipped kernel (lhs_dilation +
    # rhs_dilation); PyTorch: F.conv_transpose2d with dilation. The output
    # geometry (n-1)·2 − 2·rate + 2·rate + 1 + 1 = 2n at every rate. fp32:
    # order of sums (4.8e-7 measured); bf16: both round each output once
    # from an fp32 sum, so one bf16 ulp of the value
    rng = np.random.RandomState(rate)
    x, w, b = _rand(rng, 2, 7, 9, 6), _rand(rng, 3, 3, 6, 5, scale=0.2), \
        _rand(rng, 5)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jnn.conv_transpose2d(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                               jnp.asarray(b), stride=2, padding=rate,
                               output_padding=1, dilation=rate)
    got = tnn.conv_transpose2d(_t(x).to(tdt),
                               _t(np.transpose(w, (2, 3, 0, 1))), _t(b), 2,
                               rate, 1, rate)
    assert tuple(got.shape) == tuple(ref.shape) == (2, 14, 18, 5)
    assert got.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    else:
        assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6)


def test_multi_atrous_transpose_conv_matches_jax():
    # 4 dilated ConvT branches of C/4 outputs each, IN, concat, ReLU; fp32
    # order of sums (and of the IN statistics) only: 1.1e-5 measured on
    # outputs up to 3.7, 2e-6 of them
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 8, 8, 12)
    jblk = JaxMultiAtrousTransposeConv(16, stride=2)
    params = _bump(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                   rng)
    blk = MultiAtrousTransposeConv(12, 16, stride=2)
    blk.load_state_dict(generator_from_jax(_np(params)))
    ref = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = blk(_t(x)).numpy()
    assert got.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)


# --------------------------------------------------------------------------- #
# One JAX engine and its port per family, at 8 features and 2 blocks
# --------------------------------------------------------------------------- #
F, NB, SIZE, BATCH = 8, 2, 64, 2
# gen_type, dense_decoder, the port's class, the JAX class's name
FAMILIES = {
    "atrous_dense": ("atrous_content", True, MultiscaleDenseDecoderGenerator,
                     "MultiscaleDenseDecoderGenerator"),
    "atrous": ("atrous_content", False, MultiscaleGenerator,
               "MultiscaleGenerator"),
    "unet": ("unet_content", True, UnetGenerator, "UnetGenerator"),
}


def _cfg(kind, **kw):
    gen_type, dense, _, _ = FAMILIES[kind]
    return dict(dict(gen_type=gen_type, dense_decoder=dense, in_features=F,
                     n_residual_blocks=NB), **kw)


@functools.lru_cache(maxsize=None)
def _family(kind):
    """The JAX engine (fp32) with a state of its two generators only (the
    inference steps read no other field), their params from the JAX
    generator's init moved off it (nonzero biases), the port's inference
    engine on those, and a (real_A, real_B) batch at ``SIZE``²."""
    jeng = JaxCycleGAN(compute_dtype=jnp.float32, **_cfg(kind))
    init = jax.jit(jeng.G_a2b.init)
    x0 = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    rng = np.random.RandomState(4)
    g_a2b, g_b2a = (_bump(_np(init(jax.random.PRNGKey(k), x0)["params"]), rng)
                    for k in (0, 1))
    st = JaxCycleGANState(g_a2b, g_b2a, *[None] * 9)
    teng = CycleGANInference(compute_dtype=torch.float32, device="cpu",
                             **_cfg(kind))
    teng.load_jax_params(g_a2b, g_b2a)
    a = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    b = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    return dict(jeng=jeng, st=st, teng=teng, a=a, b=b)


@functools.lru_cache(maxsize=None)
def _jax_infer(kind):
    f = _family(kind)
    return [np.asarray(o) for o in f["jeng"].infer_step(
        f["st"], jnp.asarray(f["a"]), jnp.asarray(f["b"]))]


@functools.lru_cache(maxsize=None)
def _jax_infer_int8(kind):
    f = _family(kind)
    q = f["jeng"].quantize_generators(f["st"])
    return [np.asarray(o) for o in f["jeng"].infer_step_int8(
        f["st"], *q, (jnp.asarray(f["a"]), jnp.asarray(f["b"])))]


KINDS = sorted(FAMILIES)


@pytest.mark.parametrize("kind", KINDS)
def test_build_generator_rule_is_jax(kind):
    # the prefix and dense_decoder rule of tests/test_cyclegan.py:39-43
    gen_type, dense, cls, jname = FAMILIES[kind]
    for name in (gen_type, gen_type.split("_")[0] + "_x"):
        assert type(build_generator(name, dense_decoder=dense)) is cls
        assert type(jax_build_generator(name, dense_decoder=dense)).__name__ \
            == jname == cls.__name__
    assert type(seeded_generator(gen_type, 1, 4, device="cpu",
                                 dense_decoder=dense)) is cls


@pytest.mark.parametrize("kind", KINDS)
def test_converter_round_trip(kind):
    # JAX params → state_dict → JAX params is the identity, every leaf
    f = _family(kind)
    params = _np(f["st"].g_a2b)
    sd = generator_from_jax(params)
    assert set(sd) == set(f["teng"].G_a2b.state_dict())
    back = generator_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for u, v in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(u, v)
    if kind == "atrous":
        np.testing.assert_array_equal(
            sd["up.0.b3_convt.weight"].numpy(),
            params["up_0"]["b3_convt"]["w"].transpose(2, 3, 0, 1))
    else:
        np.testing.assert_array_equal(
            sd["up.2.convt.weight"].numpy(),
            params["up_2"]["convt"]["w"].transpose(2, 3, 0, 1))


@pytest.mark.parametrize("kind", KINDS)
def test_generator_fp32_matches_jax(kind):
    # the fp32 module forward against the JAX model's (the fake_B of the
    # JAX engine's fp32 infer_step): order of sums only (3.2e-6, 7.2e-7 and
    # 9.9e-7 measured, 'atrous', 'atrous_dense', 'unet')
    f = _family(kind)
    with torch.no_grad():
        got = f["teng"].G_a2b(_t(f["a"])).numpy()
    assert got.shape == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, _jax_infer(kind)[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_infer_step_matches_jax(kind):
    # fp32 compute, three generator calls (recover_B feeds fake_A back in;
    # 9.4e-6 at most measured)
    f = _family(kind)
    got = f["teng"].infer_step(_t(f["a"]), _t(f["b"]))
    for g, r in zip(got, _jax_infer(kind)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_generators_match_jax(kind):
    # the int8 weights and the scale / bias rows, exactly
    f = _family(kind)
    for jq, tq in zip(f["jeng"].quantize_generators(f["st"]),
                      f["teng"].quantize_generators()):
        if kind == "unet":
            assert isinstance(jq, list) and isinstance(tq, list)
            parts = (("res", jq, tq, ("w1q", "w2q", "sb")),)
        else:
            parts = (("res", jq["res"], tq["res"], ("w1q", "w2q", "sb")),
                     ("enc", jq["enc"], tq["enc"], ("wbq", "sb")))
        for part, jb, tb, keys in parts:
            assert len(jb) == len(tb) == (NB if part == "res" else 3)
            for j, t in zip(jb, tb):
                for k in keys:
                    np.testing.assert_array_equal(np.asarray(j[k]),
                                                  t[k].numpy())


def _int8_apply(kind):
    """The JAX and port int8 engines of ``kind``: the JAX one takes the
    decoder as a flag, the port's reads it from the generator."""
    if kind == "unet":
        return (jfi.unet_generator_int8_trunk_apply,
                fi.unet_generator_int8_trunk_apply)
    return (functools.partial(jfi.multiscale_generator_int8_trunk_apply,
                              dense_decoder=FAMILIES[kind][1]),
            fi.multiscale_generator_int8_trunk_apply)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_int8_engine_matches_jax(kind, dtype):
    # One generator's int8 engine against JAX's (its emulation path on the
    # CPU), within the bilinear engine's tolerances. fp32: the int8 tensors
    # agree, fp32 sum order is left (3.0e-6, 6.0e-7 and 8.6e-7 measured,
    # 'atrous', 'atrous_dense', 'unet'), atol 1e-4. bf16: the frameworks
    # round the bf16 convs at other points, and a flipped bf16 value can
    # move a requantized LSB (6.2e-3, 6.3e-3, 0.021 measured): the 0.1
    # engine budget of the JAX package.
    f = _family(kind)
    japply, tapply = _int8_apply(kind)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = f["st"].g_a2b
    jq = f["jeng"].quantize_generators(f["st"])[0]
    if dtype == "fp32":
        ref = _jax_infer_int8(kind)[0]       # the fp32 engine's fake_B
    else:
        ref = np.asarray(jax.jit(lambda p, q, x: japply(p, q, x, NB))(
            params, jq, jnp.asarray(f["a"]).astype(jdt)).astype(jnp.float32))
    g = f["teng"].G_a2b
    with torch.no_grad():
        got = tapply(g, f["teng"].quantize_generators()[0],
                     _t(f["a"]).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol={"fp32": 1e-4, "bf16": 0.1}[dtype])


@pytest.mark.parametrize("kind", KINDS)
def test_infer_step_int8_matches_jax(kind):
    # fp32 compute, int8 stages and trunks, three generator calls. fake_B
    # and fake_A agree to fp32 sum order (3.3e-6 at most measured);
    # recover_B feeds fake_A, rounded at other points, through G_A2B's int8
    # quantizers, where an LSB can flip (2.5e-3 to 6.5e-3 measured): the
    # bound of test_torch_bilinear.py's infer_step_int8 test, 0.02
    f = _family(kind)
    got = f["teng"].infer_step_int8(*f["teng"].quantize_generators(),
                                    (_t(f["a"]), _t(f["b"])))
    for g, r in zip(got, _jax_infer_int8(kind)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=0.02)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("kind", ["atrous_dense", "unet"])
def test_routing_is_jax(kind, size):
    # which encoder stages stage_kernel_fits sends to K6 (the JAX rule,
    # _stage_kernel_fits), and whole_image_resblock_fits at the trunk
    f = _family(kind)
    g = f["teng"].G_a2b
    h = torch.zeros(1, size, size, F)
    jh = jnp.zeros((1, size, size, F))
    if kind == "unet":
        assert not hasattr(g.down[0], "b0_conv")   # no stage kernel
    else:
        q = fi.quantize_multiscale_trunk(g)["enc"]
        jq = jfi.quantize_multiscale_trunk(_np(f["st"].g_a2b), NB)["enc"]
        fits = []
        for i in range(3):
            fits.append(fi.stage_kernel_fits(h, q[i]))
            assert fits[-1] == jfi._stage_kernel_fits(jh, jq[i])
            cout = q[i]["wbq"].shape[-1]
            h = torch.zeros(1, h.shape[1] // 2, h.shape[2] // 2, cout)
            jh = jnp.zeros((1, jh.shape[1] // 2, jh.shape[2] // 2, cout))
        if size == 64:
            # as the bilinear engine at 64²: stage 2's 8² output does not
            # fit the TPU kernel's rule, the others do
            assert fits == [True, True, False]
    c = 8 * F
    assert qi.whole_image_resblock_fits(size // 8, size // 8, c) \
        == qp.whole_image_resblock_fits(size // 8, size // 8, c)
    # the slice's own shape: 512², 16 features
    assert qi.whole_image_resblock_fits(64, 64, 128) \
        and qp.whole_image_resblock_fits(64, 64, 128)


def test_routing_at_512_is_jax():
    # the full-width 'atrous' encoder at 512²: stage 2 alone in K6
    g = seeded_generator("atrous_content", 1, 16, device="cpu")
    q = fi.quantize_multiscale_trunk(g)["enc"]
    jq = jfi.quantize_multiscale_trunk(_np(generator_to_jax(g.state_dict())),
                                       1)["enc"]
    fits, size, c = [], 512, 16
    for i in range(3):
        fits.append(fi.stage_kernel_fits(torch.zeros(1, size, size, c), q[i]))
        assert fits[-1] == jfi._stage_kernel_fits(
            jnp.zeros((1, size, size, c)), jq[i])
        size, c = size // 2, 2 * c
    assert fits == [False, False, True]


def test_plain_k1_on_the_trunk_matches_pallas_interpret():
    # K1's plain version on an 'atrous' trunk activation at (2, 16, 16,
    # 128) — 16 features, 128² — against JAX's K1 in interpret mode, on the
    # trunk's first block (converted back to JAX params). The int8 input
    # and weights agree; the fp32 IN of conv 1, summed in another order,
    # puts 2 of the 65,536 requantized intermediate values on the other
    # side of a rounding boundary, and each flipped LSB moves conv 2's
    # outputs nearby (6.8e-3 max, 7.3e-5 mean measured): within
    # chip_smoke.py's K1_ABS of 0.01 for one flipped LSB, and near fp32
    # sum order elsewhere
    g = seeded_generator("atrous_content", 1, 16, seed=5, device="cpu")
    x = _t((np.random.RandomState(6).rand(2, 128, 128, 1) * 2 - 1)
           .astype(np.float32))
    with torch.no_grad():
        h = fi.atrous_encode(g, None, x)[-1]
    assert tuple(h.shape) == (2, 16, 16, 128)
    jblk = generator_to_jax(g.state_dict())["res_0"]
    ref = np.asarray(qp._run_resblock_int8_bf16io(
        jnp.asarray(h.numpy()), qp.quantize_resblock(jblk), interpret=True))
    got = qi.resblock_int8_bf16io_plain(h, qi.quantize_resblock(g.res[0]))
    d = np.abs(got.numpy() - ref)
    assert d.max() <= 0.01 and d.mean() <= 1e-4


COUNTERS = (int8_resblock, int8_atrous, int8_tiled, int8_msrb, fused_conv,
            in_act, head_cout1)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_engines_launch_nothing(kind):
    # on CPU tensors the engines run the plain versions of K1 / K6 / K9:
    # no launch counter moves, under every head variant
    f = _family(kind)
    for m in COUNTERS:
        m.reset_launches()
    q = f["teng"].quantize_generators()
    a, b = _t(f["a"]), _t(f["b"])
    f["teng"].infer_step_int8(*q, (a, b))
    saved = fi._HEAD_KERNEL
    try:
        fi._HEAD_KERNEL = "tap_matmul"
        f["teng"].infer_step_int8(*q, (a, b))
    finally:
        fi._HEAD_KERNEL = saved
    assert all(v == 0 for m in COUNTERS for v in m.launches.values())


# --------------------------------------------------------------------------- #
# Training: two steps against the JAX engine's, at test_torch_train.py's
# width (4 features, 1 block): Adam moves each weight by about lr whatever
# its gradient's size, so near-zero gradients of another sign in the two
# frameworks (fp32 sums in other orders) move the step-1 metrics by ~1e-4
# of their value at 8 features and 2 blocks (1.3e-4 measured, unet)
# --------------------------------------------------------------------------- #
TRAIN = dict(in_features=4, n_residual_blocks=1, image_size=32,
             batch_size=BATCH, pool_size=4, min_points=10)


@functools.lru_cache(maxsize=None)
def _jax_trainer(kind):
    """The JAX trainer (fp32) and its initial state, as numpy trees of the
    four nets and the state itself (copy it before a ``train_step``, which
    donates it)."""
    eng = JaxCycleGAN(compute_dtype=jnp.float32, **_cfg(kind, **TRAIN))
    st = eng.init_state(jax.random.PRNGKey(0))
    return eng, {f: _np(getattr(st, f)) for f in ("g_a2b", "g_b2a", "d_a",
                                                   "d_b")}, st


def _frames(seed, n=BATCH):
    size = TRAIN["image_size"]
    return (np.random.RandomState(seed).rand(n, size, size, 1) * 2
            - 1).astype(np.float32)


def _port_trainer(kind, **kw):
    """The port's trainer on the CPU with the JAX trainer's initial
    weights, and its state."""
    _, params, _ = _jax_trainer(kind)
    eng = CycleGAN(**dict(_cfg(kind, **TRAIN), compute_dtype=torch.float32,
                          device="cpu", **kw))
    st = eng.init_state(0)
    eng.load_jax_params(**params)
    return eng, st


@pytest.mark.parametrize("kind", ["unet", "atrous"])
def test_two_train_steps_match_jax(kind):
    # fp32, pool 4 and batch 2: both steps stay in the pools' fill phase,
    # where the two frameworks' coin draws are not read; the metrics within
    # test_torch_train.py's rtol 1e-4
    jeng, _, jst0 = _jax_trainer(kind)
    jst = jax.tree.map(jnp.array, jst0)
    teng, st = _port_trainer(kind)
    for step in range(2):
        a, b = _frames(20 + step), _frames(30 + step)
        jst, jm = jeng.train_step(jst, jnp.asarray(a), jnp.asarray(b))
        st, m = teng.train_step(st, _t(a), _t(b))
        assert set(m) == set(jm)
        for k, v in m.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {step}")
        assert float(m["skipped"]) == 0.0
    assert int(st.opt_g.count) == 2


# --------------------------------------------------------------------------- #
# The VGG16 content loss
# --------------------------------------------------------------------------- #
def test_vgg16_weights_are_jax_bit_for_bit():
    jp = jvgg.init_vgg_params(jvgg.VGG16_CONVS, seed=7)
    tp = vgg.init_vgg_params(vgg.VGG16_CONVS, seed=7)
    assert list(tp) == list(jp) == [n for n, _, _ in vgg.VGG16_CONVS]
    for name in jp:
        for k in ("w", "b"):
            assert tp[name][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[name][k].numpy(),
                                          np.asarray(jp[name][k]))
    assert vgg.VGG16_FORWARD_SEQ == jvgg.VGG16_FORWARD_SEQ
    assert vgg.VGG16_CONTENT_KEY == jvgg.VGG16_CONTENT_KEY


def test_content_loss_and_gradient_match_jax():
    # fp32 at 32², 1 → 3 channel broadcast, relu4_3 (4² after 3 pools).
    # The loss to 1e-5 relative (2.3e-7 measured), the gradient with
    # respect to pred to 1e-4 of its largest element (order of sums through
    # 10 convs and 3 pools; 5.6e-7 measured)
    rng = np.random.RandomState(8)
    pred = (rng.rand(2, 32, 32, 1) * 2 - 1).astype(np.float32)
    target = (rng.rand(2, 32, 32, 1) * 2 - 1).astype(np.float32)
    jcrit = jperc.make_content_criterion(compute_dtype=jnp.float32)
    jloss, jgrad = jax.jit(jax.value_and_grad(jcrit))(jnp.asarray(pred),
                                                      jnp.asarray(target))
    crit = make_content_criterion(compute_dtype=torch.float32)
    p = _t(pred).requires_grad_(True)
    loss = crit(p, _t(target))
    (grad,) = torch.autograd.grad(loss, p)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())
    # the features stop at relu4_3: conv5 is never reached
    feats = vgg.extract_features(vgg.init_vgg_params(vgg.VGG16_CONVS[:10]),
                                 _t(pred).expand(-1, -1, -1, 3),
                                 ("relu4_3",), vgg.VGG16_FORWARD_SEQ)
    assert tuple(feats[0].shape) == (2, 4, 4, 512)


def test_train_step_with_the_content_criterion():
    # the criterion replaces L1 in the cycle and identity terms: the step's
    # identity loss is the criterion on the identity outputs it computed
    crit = make_content_criterion(compute_dtype=torch.float32)
    teng, st = _port_trainer("unet", cycle_criterion=crit)
    a, b = _t(_frames(40)), _t(_frames(41))
    with torch.no_grad():
        same_b, same_a = teng.G_a2b(b), teng.G_b2a(a)
        want = crit(same_b, b) + crit(same_a, a)
    st, m = teng.train_step(st, a, b)
    np.testing.assert_allclose(m["loss_G_identity"].item(), want.item(),
                               rtol=1e-5)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["skipped"]) == 0.0


# --------------------------------------------------------------------------- #
# The CLIs
# --------------------------------------------------------------------------- #
def _synthetic_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_r2l", os.path.join(os.path.dirname(__file__), "..",
                                           "tools", "make_synthetic_r2l.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("r2l"))
    _synthetic_tool().main(["--out", root, "--n", "4", "--size", "64"])
    return root


@pytest.mark.parametrize("engine", ["default", "int8"])
def test_test_cli_writes_images_and_panels(pairs, tmp_path, engine):
    # a run's checkpoints (the trainer's init, as the training CLI writes
    # them), then the test split (1 of 4 pairs) through both generators
    model_dir = str(tmp_path / "run")
    os.makedirs(model_dir)
    trainer = CycleGAN("atrous_content", image_size=64, device="cpu",
                       compute_dtype=torch.float32)
    trainer.init_state(0, image_size=64)
    ckpt.save_cyclegan_state(model_dir, trainer)
    save_dir = cyclegan_test.main(
        ["--dataroot", pairs, "--model_dir", model_dir, "--size", "64",
         "--gen_type", "atrous_content", "--engine", engine, "--dtype",
         "fp32", "--device", "cpu"])
    assert save_dir == os.path.join(model_dir, "img_gen_test_rec")
    from PIL import Image
    names = sorted(os.listdir(save_dir))
    assert names == ["00003.png", "panel_00003.png"]
    rec = np.asarray(Image.open(os.path.join(save_dir, names[0])))
    panel = np.asarray(Image.open(os.path.join(save_dir, names[1])))
    assert rec.shape == (64, 64) and rec.dtype == np.uint8
    assert panel.shape == (64, 5 * 64 + 4 * 5)
    # the recovered lidar: recover_B of the engine, on the PNG's B frame
    from cistar_tpu_torch.data.datasets import CycleGANImageDataset
    b = _t(CycleGANImageDataset(pairs, size=64, mode="test")[0]["B"][None])
    if engine == "int8":
        want = trainer.infer_step_int8(*trainer.quantize_generators(),
                                       (b, b))[2]
    else:
        want = trainer.infer_step(b, b)[2]
    want = np.clip(want[0, ..., 0].numpy() * 0.5 + 0.5, 0, 1)
    assert np.abs(rec / 255.0 - want).max() <= 1 / 255 + 1e-6


def test_test_cli_refuses_what_is_not_ported(pairs, tmp_path):
    # --shard, --export_engine and --engine_file raised until the exported
    # programs and data parallelism were ported; they now serve. One
    # process is a world of 1: --export_engine writes the per-rank int8
    # program, --engine_file serves it through the sharded wrapper, and
    # --shard serves the wrapper's own program; each writes the images the
    # plain int8 run writes, bit for bit
    from PIL import Image

    model_dir = str(tmp_path / "run")
    os.makedirs(model_dir)
    trainer = CycleGAN("p2p-content", image_size=64, device="cpu",
                       compute_dtype=torch.float32)
    trainer.init_state(0, image_size=64)
    ckpt.save_cyclegan_state(model_dir, trainer)
    base = ["--dataroot", pairs, "--model_dir", model_dir, "--size", "64",
            "--engine", "int8", "--dtype", "fp32", "--device", "cpu"]
    pt2 = str(tmp_path / "per_rank.pt2")

    def images(extra):
        out = cyclegan_test.main(base + extra)
        return {n: np.asarray(Image.open(os.path.join(out, n)))
                for n in sorted(os.listdir(out))}

    want = images([])
    assert cyclegan_test.main(base + ["--export_engine", pt2]) == pt2
    assert os.path.getsize(pt2) > 0
    for extra in (["--engine_file", pt2], ["--shard"]):
        got = images(extra)
        assert list(got) == list(want) == ["00003.png", "panel_00003.png"]
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_train_cli_content_loss_unet_epoch(pairs, tmp_path):
    # --content_loss --gen_type unet_content: one epoch at 64² (2 train
    # pairs, one step), checkpoints written
    out = str(tmp_path / "run")
    st = cyclegan_train.main(
        ["--dataroot", pairs, "--size", "64", "--n_epochs", "1",
         "--batchSize", "2", "--gen_type", "unet_content", "--content_loss",
         "--output_dir", out, "--log_every", "1", "--min_points", "5",
         "--device", "cpu"])
    run = out + "_unet_content"
    for net in ("netG_A2B", "netG_B2A", "netD_A", "netD_B"):
        assert os.path.exists(f"{run}/0_{net}.npz")
    assert int(st.opt_g.count) == 1
    saved = ckpt.load_pytree(f"{run}/netG_A2B.npz")
    assert saved["up_0"]["convt"]["w"].shape == (3, 3, 256, 64)


@pytest.mark.parametrize("flag,cls", [("True", MultiscaleDenseDecoderGenerator),
                                      ("False", MultiscaleGenerator)])
def test_train_cli_passes_dense_decoder(pairs, flag, cls):
    # --dense_decoder reaches the engine (it was parsed and dropped before)
    args = cyclegan_train.parse_args(
        ["--dataroot", pairs, "--gen_type", "atrous_content",
         "--dense_decoder", flag, "--content_loss", "--device", "cpu"])
    eng = cyclegan_train.make_engine(args)
    assert type(eng.G_a2b) is cls and type(eng.G_b2a) is cls
    assert eng.criterion is not l1_loss        # the content criterion
