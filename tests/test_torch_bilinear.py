"""Slice 2 of the port: the ``bilinear_content`` generator
(``MultiscaleBilinearGenerator``), its primitives, the int8 atrous blocks
K5 / K6 as plain versions, the int8 engine and the CycleGAN inference
engine, against the JAX package on the CPU from the same seeded inputs.

The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.engines.cyclegan import CycleGAN
from cistar_tpu.models import fast_infer as jfi
from cistar_tpu.models.cyclegan import \
    MultiscaleBilinearGenerator as JaxBilinear
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu.ops.blocks import MultiAtrousConv as JaxMultiAtrousConv
from cistar_tpu.ops.blocks import ResidualBlockAtrous as JaxResBlockAtrous
from cistar_tpu_torch.core.convert import conv_w_from_hwio, generator_from_jax
from cistar_tpu_torch.engines.cyclegan import CycleGANInference
from cistar_tpu_torch.kernels import int8_atrous as ka
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.cyclegan import (MultiscaleBilinearGenerator,
                                              seeded_generator)
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import MultiAtrousConv, ResidualBlockAtrous


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on both sides, JAX convs at Precision.HIGHEST: order of sums only
ATOL = 1e-5
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
# Primitives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("stride,rate", [(1, 2), (1, 8), (2, 4), (2, 6)])
def test_conv2d_dilated(stride, rate):
    # 2.4e-7 measured
    rng = np.random.RandomState(stride * 10 + rate)
    x, w, b = _rand(rng, 2, 12, 14, 5), _rand(rng, 3, 3, 5, 6, scale=0.1), \
        _rand(rng, 6)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=rate, dilation=rate)
    got = tnn.conv2d(_t(x), _t(conv_w_from_hwio(w)), _t(b), stride, rate,
                     rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_upsample_bilinear():
    # 2.4e-7 measured: the two frameworks weigh the two taps in another order
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 5, 7, 3)
    ref = jnn.upsample_bilinear(jnp.asarray(x), 2)
    got = tnn.upsample_bilinear(_t(x), 2)
    assert tuple(got.shape) == (2, 10, 14, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,w", [(6, 7), (3, 4), (2, 5)])
def test_upconv2x_bilinear(h, w):
    # against the JAX composed conv (4.8e-7 measured) and the two-op path it
    # stands for (1.2e-6); (2, 5) takes the two-op fallback of maps under 3
    # rows
    rng = np.random.RandomState(h * w)
    x, wt, b = _rand(rng, 2, h, w, 6), _rand(rng, 3, 3, 6, 4, scale=0.2), \
        _rand(rng, 4)
    ref = jnn.upconv2x_bilinear(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    got = tnn.upconv2x_bilinear(_t(x), _t(conv_w_from_hwio(wt)), _t(b))
    two_op = tnn.conv2d(tnn.upsample_bilinear(_t(x), 2),
                        _t(conv_w_from_hwio(wt)), _t(b), padding=1)
    assert tuple(got.shape) == (2, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), two_op.numpy(), rtol=0, atol=ATOL)


# --------------------------------------------------------------------------- #
# Quantizers and the plain K5 / K6
# --------------------------------------------------------------------------- #
C, HB = 32, 24   # K5 block width and map; 24 > 2·8, so every rate has taps in


@pytest.fixture(scope="module")
def atrous():
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, HB, HB, C, scale=0.5)
    jblk = JaxResBlockAtrous(C)
    jp = _bump(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    blk = ResidualBlockAtrous(C)
    blk.load_state_dict(generator_from_jax(_np(jp)))
    xs_full = _rand(rng, 2, 32, 32, 16, scale=0.5)
    jst = JaxMultiAtrousConv(32, stride=2)
    sp = _bump(jst.init(jax.random.PRNGKey(1), jnp.asarray(xs_full))["params"],
               rng)
    st = MultiAtrousConv(16, 32, stride=2)
    st.load_state_dict(generator_from_jax(_np(sp)))
    return dict(x=x, jblk=jblk, jp=jp, blk=blk.eval(),
                jq=qp.quantize_atrous_resblock(jp),
                tq=qi.quantize_atrous_resblock(blk),
                xs_full=xs_full, jst=jst, sp=sp, st=st.eval(),
                jqs=qp.quantize_multi_atrous_stage(sp),
                tqs=qi.quantize_multi_atrous_stage(st))


@pytest.mark.parametrize("key", ["wbq", "wcq", "sb"])
def test_quantize_atrous_resblock_exact(atrous, key):
    np.testing.assert_array_equal(np.asarray(atrous["jq"][key]),
                                  atrous["tq"][key].numpy())


@pytest.mark.parametrize("key", ["wbq", "sb"])
def test_quantize_multi_atrous_stage_exact(atrous, key):
    np.testing.assert_array_equal(np.asarray(atrous["jqs"][key]),
                                  atrous["tqs"][key].numpy())


def test_atrous_kernel_operand_layout(atrous):
    # wbk[b] (Cout, 9·Cin), k = tap·Cin + cin, holds the same int8 as wbq[b]
    for q in (atrous["tq"], atrous["tqs"]):
        wbq, wbk = q["wbq"], q["wbk"]
        nb, _, cin, cout = wbq.shape
        np.testing.assert_array_equal(
            wbk.numpy(), wbq.permute(0, 3, 1, 2).reshape(nb, cout, 9 * cin))
    tq = atrous["tq"]
    np.testing.assert_array_equal(
        tq["wck"].numpy(), tq["wcq"].permute(2, 0, 1).reshape(C, 9 * C))


@pytest.mark.parametrize("rate,h", [(1, 8), (3, 8), (8, 8), (8, 24)])
def test_conv3x3_dilated_s8_plain_exact(atrous, rate, h):
    # at rate 8 on 8 rows only the centre row of taps is in range
    rng = np.random.RandomState(rate + h)
    xq = rng.randint(-127, 128, (2, h, h + 1, C)).astype(np.int8)
    wq = atrous["tq"]["wbq"][1]
    xp = np.pad(xq.astype(np.int64),
                ((0, 0), (rate, rate), (rate, rate), (0, 0)))
    ref = np.zeros((2, h, h + 1, C), np.int64)
    for k in range(9):
        dy, dx = (k // 3) * rate, (k % 3) * rate
        ref += np.einsum("nhwi,io->nhwo", xp[:, dy:dy + h, dx:dx + h + 1],
                         wq[k].numpy().astype(np.int64))
    got = qi.conv3x3_dilated_s8_plain(_t(xq), wq, rate)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k5_plain_int8_intermediates_equal_jax(atrous):
    # the quantized input and the quantized branch sum are equal to JAX's:
    # the branch sum is JAX's K6 emulation at rates 2/4/6/8 on the same
    # image, which is the first half of its K5 emulation. The sums differ
    # in fp32 order, so the requantization scales may differ by an ulp
    # (1.2e-7 relative measured) while every int8 value is equal.
    x, jq, tq = atrous["x"], atrous["jq"], atrous["tq"]
    jssum = qp._multi_atrous_stage_int8_emulate(
        jnp.asarray(x), {"wbq": jq["wbq"], "sb": jq["sb"][:8]}, qi.RATES)
    j_sq, j_ss = qp.quantize_act(jssum)
    xf = _t(x).reshape(2, HB * HB, C)
    hq, x_scale = qi._quant_rows(xf)
    t_sq, t_ss = qi._quant_rows(qi._branch_sum(
        hq.reshape(2, HB, HB, C), tq["wbq"], x_scale, tq["sb"], qi.RATES))
    np.testing.assert_array_equal(t_sq.reshape(2, HB, HB, C).numpy(),
                                  np.asarray(j_sq))
    np.testing.assert_allclose(t_ss.reshape(2, 1).numpy(), np.asarray(j_ss),
                               rtol=1e-6)


def test_k5_plain_matches_emulation(atrous):
    # int8 tensors equal (above); fp32 IN sum order only (4.8e-6 measured)
    x, jq, tq = atrous["x"], atrous["jq"], atrous["tq"]
    ref = np.asarray(qp._atrous_resblock_int8_emulate(jnp.asarray(x), jq,
                                                      qi.RATES))
    got = qi.atrous_resblock_int8_plain(_t(x), tq).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k5_plain_matches_pallas_interpret(atrous):
    # the TPU kernel itself, run by Pallas's interpreter: fp32 sum order
    # only (6.7e-6 measured)
    x, jq, tq = atrous["x"], atrous["jq"], atrous["tq"]
    ref = np.asarray(qp._run_atrous_resblock_int8(jnp.asarray(x), jq,
                                                  qi.RATES, interpret=True))
    got = qi.atrous_resblock_int8_plain(_t(x), tq).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k5_plain_bf16_within_one_ulp(atrous):
    # bf16 carrier: the fp32 block output differs by ~1e-6, which can round
    # to the neighbouring bf16 value
    x, jq, tq = atrous["x"], atrous["jq"], atrous["tq"]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(qp._atrous_resblock_int8_emulate(xb, jq, qi.RATES)
                     .astype(jnp.float32))
    got = qi.atrous_resblock_int8_plain(_t(x).bfloat16(), tq).float().numpy()
    assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) * 1.0001)


def test_k6_plain_matches_emulation_and_interpret(atrous):
    # the subsampled input quantizes equally (quantize_act on x[::2, ::2]);
    # the outputs agree to the fp32 IN sum order (9.5e-7 measured)
    xs_full, jqs, tqs = atrous["xs_full"], atrous["jqs"], atrous["tqs"]
    xs = xs_full[:, ::2, ::2]
    np.testing.assert_array_equal(np.asarray(qp.quantize_act(jnp.asarray(xs))[0]),
                                  qi.quantize_act(_t(xs))[0].numpy())
    rates2 = (1, 2, 3, 4)
    got = qi.multi_atrous_stage_int8_plain(_t(xs), tqs, rates2).numpy()
    for ref in (qp._multi_atrous_stage_int8_emulate(jnp.asarray(xs), jqs,
                                                    rates2),
                qp._run_multi_atrous_stage_int8(jnp.asarray(xs), jqs, rates2,
                                                interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_k6_dispatch_subsamples_like_jax(atrous):
    # the public stage: stride 2 and rates 2/4/6/8 on the full-resolution
    # input, run as halved rates on x[::2, ::2]; within the JAX family
    # budget (0.35) of the fp32 stage (9.5e-7 and 0.078 measured)
    xs_full, jqs, tqs = atrous["xs_full"], atrous["jqs"], atrous["tqs"]
    ref = np.asarray(qp.multi_atrous_stage_int8(jnp.asarray(xs_full), jqs))
    got = qi.multi_atrous_stage_int8(_t(xs_full), tqs)
    assert tuple(got.shape) == (2, 16, 16, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    with torch.no_grad():
        fp32 = atrous["st"](_t(xs_full)).numpy()
    assert np.abs(got.numpy() - fp32).max() < 0.35
    with pytest.raises(NotImplementedError):
        qi.multi_atrous_stage_int8(_t(xs_full), tqs, rates=(1, 2, 3, 4))
    with pytest.raises(NotImplementedError):
        qi.multi_atrous_stage_int8(_t(xs_full), tqs, stride=1)


def test_atrous_chain_matches_emulation(atrous):
    # two blocks: the int8 tensors agree, fp32 sum order is left (1.05e-5
    # measured, on outputs up to |8|)
    x, jq, tq = atrous["x"], atrous["jq"], atrous["tq"]
    ref = np.asarray(qp.atrous_resblock_chain_int8(jnp.asarray(x), [jq, jq],
                                                   force_emulate=True))
    got = qi.atrous_resblock_chain_int8(_t(x), [tq, tq]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)


def test_atrous_blocks_fp32_match_jax(atrous):
    # the fp32 modules the int8 blocks stand for (1.6e-5 and 2.1e-6
    # measured)
    with torch.no_grad():
        got_b = atrous["blk"](_t(atrous["x"])).numpy()
        got_s = atrous["st"](_t(atrous["xs_full"])).numpy()
    ref_b = atrous["jblk"].apply({"params": atrous["jp"]},
                                 jnp.asarray(atrous["x"]))
    ref_s = atrous["jst"].apply({"params": atrous["sp"]},
                                jnp.asarray(atrous["xs_full"]))
    np.testing.assert_allclose(got_b, np.asarray(ref_b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s, np.asarray(ref_s), rtol=0, atol=1e-4)


def test_cpu_dispatch_uses_plain_and_launches_nothing(atrous):
    ka.reset_launches()
    x = _t(atrous["x"])
    np.testing.assert_array_equal(
        qi.atrous_resblock_int8(x, atrous["tq"]).numpy(),
        qi.atrous_resblock_int8_plain(x, atrous["tq"]).numpy())
    qi.multi_atrous_stage_int8(_t(atrous["xs_full"]), atrous["tqs"])
    assert all(v == 0 for v in ka.launches.values())


def test_kernel_wrappers_refuse_cpu_tensors(atrous):
    x = torch.zeros(1, 16, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        ka.atrous_resblock_int8(x, atrous["tq"], qi.RATES, qi.EPS)
    with pytest.raises(ValueError, match="CUDA"):
        ka.multi_atrous_stage_int8(x, atrous["tqs"], (1, 2, 3, 4), qi.EPS)
    with pytest.raises(ValueError, match="CUDA"):
        ka.conv3x3_dilated_s8(x.to(torch.int8),
                              torch.zeros(128, 9 * 128, dtype=torch.int8), 2)


@pytest.mark.parametrize("h,w,cin,cout", [
    (256, 256, 16, 32), (128, 128, 32, 64), (64, 64, 64, 128),
    (32, 32, 32, 64), (16, 16, 64, 128), (8, 8, 8, 16), (96, 96, 16, 32)])
def test_stage_routing_rule_is_jax(h, w, cin, cout):
    assert qi.atrous_stage_fits(h, w, cin, cout) \
        == qp.atrous_stage_fits(h, w, cin, cout)


# --------------------------------------------------------------------------- #
# The generator and its int8 engine
# --------------------------------------------------------------------------- #
NB, F, SIZE, BATCH = 2, 4, 64, 2


@pytest.fixture(scope="module")
def gens():
    rng = np.random.RandomState(4)
    jgen = JaxBilinear(output_nc=1, n_residual_blocks=NB, in_features=F)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 1), jnp.float32))
    params = _bump(params["params"], rng)
    tgen = MultiscaleBilinearGenerator(1, 1, NB, F)
    tgen.load_state_dict(generator_from_jax(_np(params)))
    x = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    return jgen, params, tgen.eval(), x


def test_generator_from_jax(gens):
    _, params, tgen, _ = gens
    sd = generator_from_jax(_np(params))
    ref = tgen.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32, k
    np.testing.assert_array_equal(
        sd["res.1.atrous.b3_conv.weight"].numpy(),
        np.asarray(params["res_1"]["atrous"]["b3_conv"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["up.2.conv.bias"].numpy(),
                                  np.asarray(params["up_2"]["conv"]["b"]))


def test_bilinear_generator_fp32_matches_jax(gens):
    # fp32 throughout: order of sums only (1.9e-6 measured)
    jgen, params, tgen, x = gens
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tgen(_t(x)).numpy()
    assert got.shape == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_stage_routing_at_64(gens):
    # 64², 4 features: stages 0 and 1 fit the JAX rule (int8), stage 2
    # (8×8 after the stride) does not (bf16), so both routes run below
    _, _, tgen, x = gens
    q = fi.quantize_bilinear_trunk(tgen)
    h = torch.zeros(1, SIZE, SIZE, F)
    fits = []
    for i, stage in enumerate(tgen.down):
        fits.append(fi.stage_kernel_fits(h, q["enc"][i]))
        h = torch.zeros(1, h.shape[1] // 2, h.shape[2] // 2,
                        q["enc"][i]["wbq"].shape[-1])
    assert fits == [True, True, False]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_engine_matches_jax_emulation(gens, dtype):
    # fp32: the int8 tensors agree, fp32 sum order is left (1.3e-6
    # measured), atol 1e-4. bf16: the frameworks round the bf16 convs at
    # other points, and a flipped bf16 value can move a requantized LSB
    # (9.8e-3 measured): the 0.1 engine budget of the JAX package.
    jgen, params, tgen, x = gens
    jdt, tdt, atol = {"fp32": (jnp.float32, torch.float32, 1e-4),
                      "bf16": (jnp.bfloat16, torch.bfloat16, 0.1)}[dtype]
    jq = jfi.quantize_bilinear_trunk(params, NB)
    ref = np.asarray(jax.jit(lambda p, q, x: jfi.bilinear_generator_int8_trunk_apply(
        p, q, x, NB))(params, jq, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = fi.bilinear_generator_int8_trunk_apply(
            tgen, fi.quantize_bilinear_trunk(tgen), _t(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


def test_int8_engine_res_only_matches_jax(gens):
    # a bare list of res blocks keeps every encoder stage in the input
    # dtype, as JAX's _q_parts does (fp32; 1.6e-6 measured)
    jgen, params, tgen, x = gens
    jq = jfi.quantize_bilinear_trunk(params, NB)["res"]
    ref = np.asarray(jfi.bilinear_generator_int8_trunk_apply(
        params, jq, jnp.asarray(x), NB))
    with torch.no_grad():
        got = fi.bilinear_generator_int8_trunk_apply(
            tgen, fi.quantize_bilinear_trunk(tgen)["res"], _t(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# The inference engine, bilinear_content (its default)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engines():
    jeng = CycleGAN(in_features=F, n_residual_blocks=NB, image_size=SIZE,
                    batch_size=BATCH, compute_dtype=jnp.float32)
    assert jeng.gen_type == "bilinear_content"
    state = jeng.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    state = state._replace(g_a2b=_bump(state.g_a2b, rng),
                           g_b2a=_bump(state.g_b2a, rng))
    teng = CycleGANInference(in_features=F, n_residual_blocks=NB,
                             compute_dtype=torch.float32, device="cpu")
    assert isinstance(teng.G_a2b, MultiscaleBilinearGenerator)
    teng.load_jax_params(_np(state.g_a2b), _np(state.g_b2a))
    a = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    b = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    return jeng, state, teng, a, b


def test_infer_step_matches_jax(engines):
    # fp32 compute, three generator calls (recover_B feeds fake_A back in;
    # 3.6e-6 measured)
    jeng, state, teng, a, b = engines
    ref = jeng.infer_step(state, jnp.asarray(a), jnp.asarray(b))
    got = teng.infer_step(_t(a), _t(b))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_infer_step_int8_matches_jax(engines):
    # fp32 compute, int8 stages and trunks. fake_B agrees to fp32 sum order
    # (3.9e-6 measured). In G_B2A one fp32 value lies within an ulp of a
    # rounding boundary and one requantized LSB flips against JAX (eager
    # or jitted alike): 7.2e-4 on fake_A, and 8.4e-3 on recover_B, which
    # feeds fake_A through G_A2B. 0.02 holds a few such flips, far below
    # the JAX package's 0.1 engine budget.
    jeng, state, teng, a, b = engines
    jq = jeng.quantize_generators(state)
    ref = jeng.infer_step_int8(state, *jq, (jnp.asarray(a), jnp.asarray(b)))
    got = teng.infer_step_int8(*teng.quantize_generators(), (_t(a), _t(b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=0.02)


def test_quantize_generators_match_jax(engines):
    jeng, state, teng, _, _ = engines
    for jq, tq in zip(jeng.quantize_generators(state),
                      teng.quantize_generators()):
        assert len(jq["res"]) == len(tq["res"]) == NB
        assert len(jq["enc"]) == len(tq["enc"]) == 3
        for part, keys in (("res", ("wbq", "wcq", "sb")), ("enc", ("wbq", "sb"))):
            for jb, tb in zip(jq[part], tq[part]):
                for k in keys:
                    np.testing.assert_array_equal(np.asarray(jb[k]),
                                                  tb[k].numpy())


def test_seeded_generator_is_device_independent():
    g = seeded_generator("bilinear_content", 1, 4, seed=3, device="cpu")
    h = seeded_generator("bilinear", 1, 4, seed=3, device="cpu")
    for (k, v), (_, u) in zip(g.state_dict().items(), h.state_dict().items()):
        assert torch.equal(v, u), k
