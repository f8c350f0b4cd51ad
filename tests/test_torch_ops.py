"""Port primitives, weight conversion, head and ResNet generator
(``cistar_tpu_torch/ops``, ``core/convert.py``, ``models/cyclegan.py``)
against the JAX package on the CPU, from the same seeded numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.models.cyclegan import ResnetGenerator as JaxResnetGenerator
from cistar_tpu.ops import head_conv as jhead
from cistar_tpu.ops import nn as jnn
from cistar_tpu_torch.core.convert import (conv_transpose_w_from_hwio,
                                           conv_w_from_hwio,
                                           resnet_generator_from_jax)
from cistar_tpu_torch.models.cyclegan import ResnetGenerator
from cistar_tpu_torch.ops import head_conv as thead
from cistar_tpu_torch.ops import nn as tnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 on both sides: the JAX convs run at Precision.HIGHEST; what is left
# is the order of the fp32 sums
ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (3, 1, 0), (7, 1, 3)])
def test_conv2d(k, stride, pad):
    rng = np.random.RandomState(k + stride)
    x, w, b = _rand(rng, 2, 12, 12, 5), _rand(rng, k, k, 5, 6, scale=0.1), \
        _rand(rng, 6)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=pad)
    got = tnn.conv2d(_t(x), _t(conv_w_from_hwio(w)), _t(b), stride, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", [3, 7])
def test_conv2d_reflect(k):
    rng = np.random.RandomState(k)
    x, w, b = _rand(rng, 2, 10, 9, 4), _rand(rng, k, k, 4, 3, scale=0.1), \
        _rand(rng, 3)
    ref = jnn.conv2d_reflect(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tnn.conv2d_reflect(_t(x), _t(conv_w_from_hwio(w)), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_conv_transpose2d():
    rng = np.random.RandomState(1)
    x, w, b = _rand(rng, 2, 6, 7, 8), _rand(rng, 3, 3, 8, 4, scale=0.1), \
        _rand(rng, 4)
    ref = jnn.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=2, padding=1, output_padding=1)
    got = tnn.conv_transpose2d(_t(x), _t(conv_transpose_w_from_hwio(w)), _t(b),
                               stride=2, padding=1, output_padding=1)
    assert tuple(got.shape) == (2, 12, 14, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_instance_norm_and_stats():
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 8, 8, 6) * 3 + 1
    np.testing.assert_allclose(tnn.instance_norm(_t(x)).numpy(),
                               np.asarray(jnn.instance_norm(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    for got, ref in zip(tnn.instance_norm_stats(_t(x)),
                        jnn.instance_norm_stats(jnp.asarray(x))):
        assert tuple(got.shape) == (2, 1, 1, 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=ATOL)


def test_instance_norm_keeps_bf16_with_fp32_stats():
    x = torch.linspace(-3, 5, 2 * 4 * 4 * 3).reshape(2, 4, 4, 3)
    y = tnn.instance_norm(x.bfloat16())
    assert y.dtype == torch.bfloat16
    ref = tnn.instance_norm(x.bfloat16().float())
    np.testing.assert_array_equal(y.float().numpy(),
                                  ref.bfloat16().float().numpy())


def test_relu_tanh():
    x = np.linspace(-3, 3, 25, dtype=np.float32)
    np.testing.assert_array_equal(tnn.relu(_t(x)).numpy(),
                                  np.asarray(jnn.relu(jnp.asarray(x))))
    np.testing.assert_allclose(tnn.tanh(_t(x)).numpy(),
                               np.asarray(jnn.tanh(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_head_conv_prenorm_matches_jax():
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 32, 32, 8) * 2 + 0.5
    w, b = _rand(rng, 7, 7, 8, 1, scale=0.05), _rand(rng, 1)
    mean, rs = jnn.instance_norm_stats(jnp.asarray(x))
    ref = jhead.head_conv_tanh_shift_prenorm(jnp.asarray(x), mean, rs,
                                             jnp.asarray(w), jnp.asarray(b))
    tmean, trs = tnn.instance_norm_stats(_t(x))
    got = thead.head_conv_tanh_prenorm(_t(x), tmean, trs,
                                       _t(conv_w_from_hwio(w)), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


NB, F, SIZE = 2, 8, 32


@pytest.fixture(scope="module")
def gens():
    rng = np.random.RandomState(4)
    jgen = JaxResnetGenerator(output_nc=1, n_residual_blocks=NB, in_features=F)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 1), jnp.float32))["params"]
    # nonzero biases, so that the bias mapping is exercised
    params = jax.tree.map(lambda a: a + 0.01 * rng.randn(*a.shape)
                          .astype(np.float32), params)
    pnp = jax.tree.map(np.asarray, params)
    tgen = ResnetGenerator(1, 1, NB, F)
    tgen.load_state_dict(resnet_generator_from_jax(pnp))
    x = (rng.rand(2, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    return jgen, params, pnp, tgen.eval(), x


def test_resnet_generator_from_jax(gens):
    _, _, pnp, tgen, _ = gens
    sd = resnet_generator_from_jax(pnp)
    ref = tgen.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32, k
    np.testing.assert_array_equal(sd["res.1.conv2.weight"].numpy(),
                                  pnp["res_1"]["conv2"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["up.0.weight"].numpy(),
                                  pnp["up_0"]["w"].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["out_conv.bias"].numpy(),
                                  pnp["out_conv"]["b"])


def test_generator_fp32_matches_jax(gens):
    # 1e-4: fp32 throughout, order of sums only (2.2e-6 measured)
    jgen, params, _, tgen, x = gens
    ref = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tgen(_t(x)).numpy()
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_generator_bf16_matches_jax(gens):
    # 0.05: both round every conv output and IN to bf16, but at other points
    # of their sums, and the flips compound over the layers (3.9e-3
    # measured here, 1.3e-2 on other seeds: a few bf16 ulps of |y| < 1)
    jgen, params, _, tgen, x = gens
    ref = np.asarray(jax.jit(jgen.apply)(
        {"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
        .astype(jnp.float32))
    with torch.no_grad():
        out = tgen(_t(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=0.05)
