"""The dtype policies (``core/dtypes.py``) and the plain int8 path
(``ops/quant.py``) of the port against the JAX package's.

  * ``get_policy``: JAX's three names and their (compute, param) dtype
    pairs, the casts of a tree's floating leaves, the error on an unknown
    name;
  * ``ops/quant.py``: the int8 weights and their per-output-channel scales
    of every conv of a ``ResnetGenerator`` (8 features, 3 blocks) bit for
    bit against JAX's ``quantize_conv_tree`` of the same weights converted;
    the int32 accumulators of each conv kind (zero-padded stride 1 and 2,
    reflect, the stride-2 transpose) exactly against XLA's int8 conv; the
    three dequantized convs within 1e-6; ``resnet_generator_int8_apply``
    at 32² within 1e-5 of JAX's (1.8e-7 read; 0.12 from the fp32 forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from cistar_tpu.core import dtypes as jdtypes
from cistar_tpu.ops import quant as jquant
from cistar_tpu_torch.core import dtypes
from cistar_tpu_torch.core.convert import resnet_generator_to_jax
from cistar_tpu_torch.models.cyclegan import ResnetGenerator
from cistar_tpu_torch.ops import quant

FEATURES, BLOCKS, SIZE = 8, 3, 32
APPLY_ATOL = 1e-5
CONV_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# dtype policies
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["fp32", "bf16", "full_bf16"])
def test_policy_dtypes_match_jax(name):
    pol, jpol = dtypes.get_policy(name), jdtypes.get_policy(name)
    for got, want in ((pol.compute_dtype, jpol.compute_dtype),
                      (pol.param_dtype, jpol.param_dtype)):
        assert str(got).split(".")[1] == np.dtype(want).name
    tree = {"w": torch.ones(2), "n": torch.ones(2, dtype=torch.int32),
            "s": [torch.zeros(1, dtype=torch.float64), 3]}
    jtree = {"w": jnp.ones(2), "n": jnp.ones(2, jnp.int32),
             "s": [jnp.zeros(1, jnp.float32), 3]}
    for cast, jcast in ((pol.cast_to_compute, jpol.cast_to_compute),
                        (pol.cast_to_param, jpol.cast_to_param)):
        out, jout = cast(tree), jcast(jtree)
        for k in ("w", "n"):
            assert str(out[k].dtype).split(".")[1] == \
                np.dtype(jout[k].dtype).name
        assert str(out["s"][0].dtype).split(".")[1] == \
            np.dtype(jout["s"][0].dtype).name
        assert out["s"][1] == jout["s"][1] == 3


def test_unknown_policy_raises():
    for get in (dtypes.get_policy, jdtypes.get_policy):
        with pytest.raises(ValueError, match="unknown dtype policy"):
            get("fp8")


# --------------------------------------------------------------------------- #
# ops/quant.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gen():
    torch.manual_seed(0)
    g = ResnetGenerator(1, 1, BLOCKS, FEATURES)
    with torch.no_grad():          # biases away from 0, so they count
        for m in g.modules():
            if getattr(m, "bias", None) is not None:
                m.bias.normal_(0.0, 0.05)
    return g


def _jax_tree(g):
    return jax.tree.map(jnp.asarray, resnet_generator_to_jax(g.state_dict()))


def _hwio(name, wq):
    # OIHW → HWIO; a transpose conv's (in, out, kh, kw) → HWIO (I = in)
    return wq.permute(2, 3, 0, 1) if name.startswith("up.") \
        else wq.permute(2, 3, 1, 0)


def _jax_node(jq, name):
    node = jq
    for part in name.replace("down.", "down_").replace("res.", "res_") \
            .replace("up.", "up_").split("."):
        node = node[part]
    return node


def test_quantized_weights_match_jax_bit_for_bit(gen):
    q = quant.quantize_conv_tree(gen)
    jq = jquant.quantize_conv_tree(_jax_tree(gen))
    assert len(q) == 2 + 3 + 2 * BLOCKS + 3
    for name, node in q.items():
        jnode = _jax_node(jq, name)
        assert node["wq"].dtype == torch.int8
        np.testing.assert_array_equal(_hwio(name, node["wq"]).numpy(),
                                      np.asarray(jnode["wq"]))
        np.testing.assert_array_equal(node["scale"].numpy(),
                                      np.asarray(jnode["scale"]))
        np.testing.assert_array_equal(node["b"].numpy(),
                                      np.asarray(jnode["b"]))


def _acts(seed, shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    xq, _ = quant.quantize_act(torch.from_numpy(x))
    jxq, _ = jquant._quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    return x, xq, jxq


@pytest.mark.parametrize("kind", ["zero_s1", "zero_s2", "reflect",
                                  "transpose"])
def test_int32_accumulators_match_xla(gen, kind):
    name = {"zero_s1": "res.0.conv1", "zero_s2": "down.1",
            "reflect": "res.1.conv2", "transpose": "up.0"}[kind]
    node = quant.quantize_conv_tree(gen)[name]
    cin = node["wq"].shape[0 if kind == "transpose" else 1]
    x, xq, jxq = _acts(1, (2, 16, 12, cin))
    jw = jnp.asarray(_hwio(name, node["wq"]).numpy())
    dn = ("NHWC", "HWIO", "NHWC")
    if kind == "transpose":
        xd = xq.new_zeros((2, 31, 23, cin))
        xd[:, ::2, ::2] = xq
        got = quant.conv_acc(torch.nn.functional.pad(xd, (0, 0, 1, 2, 1, 2)),
                             torch.flip(node["wq"], (2, 3)).transpose(0, 1))
        want = lax.conv_general_dilated(
            jxq, jnp.flip(jw, (0, 1)), (1, 1), [(1, 2), (1, 2)],
            lhs_dilation=(2, 2), dimension_numbers=dn,
            preferred_element_type=jnp.int32)
    elif kind == "reflect":
        got = quant.conv_acc(quant._reflect_pad(xq, 1), node["wq"])
        want = lax.conv_general_dilated(
            jnp.pad(jxq, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"),
            jw, (1, 1), "VALID", dimension_numbers=dn,
            preferred_element_type=jnp.int32)
    else:
        s = 2 if kind == "zero_s2" else 1
        got = quant.conv_acc(torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1)),
                             node["wq"], s)
        want = lax.conv_general_dilated(
            jxq, jw, (s, s), [(1, 1), (1, 1)], dimension_numbers=dn,
            preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32 and int(got.abs().max()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn,jfn,name,kw", [
    (quant.int8_conv2d, jquant.int8_conv2d, "down.0", {"stride": 2}),
    (quant.int8_conv2d_reflect, jquant.int8_conv2d_reflect, "res.0.conv2",
     {}),
    (quant.int8_conv_transpose2d, jquant.int8_conv_transpose2d, "up.1", {})])
def test_dequantized_convs_match_jax(gen, fn, jfn, name, kw):
    node = quant.quantize_conv_tree(gen)[name]
    jnode = _jax_node(jquant.quantize_conv_tree(_jax_tree(gen)), name)
    cin = node["wq"].shape[0 if name.startswith("up.") else 1]
    x = np.random.RandomState(2).randn(2, 16, 16, cin).astype(np.float32)
    got = fn(torch.from_numpy(x), node, **kw)
    want = jfn(jnp.asarray(x), jnode, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CONV_ATOL)


def test_resnet_generator_int8_apply_matches_jax(gen):
    x = np.random.RandomState(3).randn(2, SIZE, SIZE, 1).astype(np.float32)
    got = quant.resnet_generator_int8_apply(quant.quantize_conv_tree(gen),
                                            torch.from_numpy(x), BLOCKS)
    want = jax.jit(lambda q, x: jquant.resnet_generator_int8_apply(
        q, x, BLOCKS))(jquant.quantize_conv_tree(_jax_tree(gen)),
                       jnp.asarray(x))
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=APPLY_ATOL)
    # and it is an int8 forward: within int8 rounding of the fp32 one, not
    # equal to it
    with torch.no_grad():
        ref = gen(torch.from_numpy(x))
    assert 0 < float((got - ref).abs().max()) < 0.2
