"""The slice as a whole: the port's int8-trunk engine
(``cistar_tpu_torch/models/fast_infer.py``) and its CycleGAN inference
engine (``cistar_tpu_torch/engines/cyclegan.py``) against the JAX package
on the CPU, on the same weights (the JAX init, converted) and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.engines.cyclegan import CycleGAN
from cistar_tpu.models.fast_infer import \
    resnet_generator_int8_trunk_apply as jax_int8_apply
from cistar_tpu.ops.quant_pallas import quantize_resnet_trunk as jax_quantize
from cistar_tpu_torch.engines.cyclegan import CycleGANInference
from cistar_tpu_torch.models.cyclegan import (MultiscaleDenseDecoderGenerator,
                                              UnetGenerator)
from cistar_tpu_torch.models.fast_infer import \
    resnet_generator_int8_trunk_apply
from cistar_tpu_torch.ops.quant_int8 import quantize_resnet_trunk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NB, F, SIZE, BATCH = 2, 8, 32, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jeng = CycleGAN(gen_type="p2p", in_features=F, n_residual_blocks=NB,
                    image_size=SIZE, batch_size=BATCH,
                    compute_dtype=jnp.float32)
    state = jeng.init_state(jax.random.PRNGKey(0))
    # nonzero biases, so that the bias rows of the int8 blocks matter
    rng = np.random.RandomState(0)
    bump = lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32)
    state = state._replace(g_a2b=jax.tree.map(bump, state.g_a2b),
                           g_b2a=jax.tree.map(bump, state.g_b2a))
    teng = CycleGANInference("p2p", in_features=F, n_residual_blocks=NB,
                             compute_dtype=torch.float32, device="cpu")
    teng.load_jax_params(_np(state.g_a2b), _np(state.g_b2a))
    a = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    b = (rng.rand(BATCH, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    return jeng, state, teng, a, b


@pytest.mark.parametrize("carrier", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_engine_matches_jax_emulation(setup, carrier, dtype):
    # fp32: the int8 tensors agree, only fp32 sum order is left (7.7e-7
    # measured), atol 1e-4. bf16: the two frameworks round bf16 convs at
    # other points, and a flipped bf16 value can move a requantized LSB
    # (2.9e-2 measured): the 0.1 engine budget of the JAX package.
    jeng, state, teng, a, _ = setup
    jdt, tdt, atol = {"fp32": (jnp.float32, torch.float32, 1e-4),
                      "bf16": (jnp.bfloat16, torch.bfloat16, 0.1)}[dtype]
    q = jax_quantize(state.g_a2b, NB)
    ref = np.asarray(jax.jit(lambda p, q, x: jax_int8_apply(
        p, q, x, NB, int8_carrier=carrier, force_emulate=True))(
            state.g_a2b, q, jnp.asarray(a).astype(jdt)).astype(jnp.float32))
    gen = teng.G_a2b
    with torch.no_grad():
        got = resnet_generator_int8_trunk_apply(
            gen, quantize_resnet_trunk(gen), torch.from_numpy(a).to(tdt),
            carrier)
    assert got.dtype == tdt and tuple(got.shape) == (BATCH, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


def test_infer_step_matches_jax(setup):
    # fp32 compute on both sides: order of sums only, through three
    # generator calls (recover_B feeds fake_A back in; 1.4e-5 measured)
    jeng, state, teng, a, b = setup
    ref = jeng.infer_step(state, jnp.asarray(a), jnp.asarray(b))
    got = teng.infer_step(torch.from_numpy(a), torch.from_numpy(b))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_infer_step_int8_matches_jax(setup):
    # fp32 compute, int8 trunks: as above (3.5e-6 measured)
    jeng, state, teng, a, b = setup
    jq = jeng.quantize_generators(state)
    ref = jeng.infer_step_int8(state, *jq, (jnp.asarray(a), jnp.asarray(b)))
    tq = teng.quantize_generators()
    got = teng.infer_step_int8(*tq, (torch.from_numpy(a), torch.from_numpy(b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_quantize_generators_match_jax(setup):
    jeng, state, teng, _, _ = setup
    for jq, tq in zip(jeng.quantize_generators(state),
                      teng.quantize_generators()):
        assert len(jq) == len(tq) == NB
        for jb, tb in zip(jq, tq):
            for k in ("w1q", "w2q", "sb"):
                np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())


@pytest.mark.parametrize("gen_type", ["atrous_dense", "atrous", "unet"])
def test_other_generators_not_ported(gen_type):
    # These generators are ported now: the engine builds the class of the
    # JAX prefix rule (dense decoder by default), where it raised before
    eng = CycleGANInference(gen_type, in_features=4, n_residual_blocks=1,
                            device="cpu")
    want = UnetGenerator if gen_type == "unet" \
        else MultiscaleDenseDecoderGenerator
    assert type(eng.G_a2b) is want and type(eng.G_b2a) is want


def test_int8_carrier_checked(setup):
    _, _, teng, a, _ = setup
    with pytest.raises(ValueError, match="int8_carrier"):
        resnet_generator_int8_trunk_apply(teng.G_a2b, [], torch.from_numpy(a),
                                          "fp8")
