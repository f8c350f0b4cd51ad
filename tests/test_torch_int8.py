"""Port int8 quantizers and the plain versions of K1 / K2
(``cistar_tpu_torch/ops/quant_int8.py``) against the JAX package
(``cistar_tpu/ops/quant_pallas.py``) on the CPU.

The same seeded numpy weights and activations go through both. The CUDA
kernels themselves are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu_torch.core.convert import conv_w_from_hwio
from cistar_tpu_torch.kernels import int8_resblock as kr
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import ResidualBlock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, H, W, C = 2, 16, 16, 128
BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value (8-bit significand)


def _jax_block(rng):
    return {f"conv{j}": {"w": (0.05 * rng.randn(3, 3, C, C)).astype(np.float32),
                         "b": (0.1 * rng.randn(C)).astype(np.float32)}
            for j in (1, 2)}


def _jax_tree(blk):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in blk.items()}


def _port_block(jblk):
    blk = ResidualBlock(C)
    with torch.no_grad():
        for j in (1, 2):
            conv = getattr(blk, f"conv{j}")
            conv.weight.copy_(torch.from_numpy(conv_w_from_hwio(jblk[f"conv{j}"]["w"])))
            conv.bias.copy_(torch.from_numpy(jblk[f"conv{j}"]["b"]))
    return blk


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, C).astype(np.float32)
    jblks = [_jax_block(rng) for _ in range(2)]
    jq = [qp.quantize_resblock(_jax_tree(b)) for b in jblks]
    tq = [qi.quantize_resblock(_port_block(b)) for b in jblks]
    return x, jq, tq


@pytest.mark.parametrize("key", ["w1q", "w2q", "sb"])
def test_quantize_resblock_exact(data, key):
    _, jq, tq = data
    np.testing.assert_array_equal(np.asarray(jq[0][key]), tq[0][key].numpy())


def test_quantize_act_exact(data):
    # 65,536 activations: with a scalar-numerator division (127 * 1/amax)
    # about one of them quantizes one LSB off; the port divides as IEEE.
    x, _, _ = data
    jq_, js = qp.quantize_act(jnp.asarray(x))
    tq_, ts = qi.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq_), tq_.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_kernel_operand_layout(data):
    # wk (Cout, 9·Cin), k = tap·Cin + cin, holds the same int8 values as wq
    _, _, tq = data
    wq, wk = tq[0]["w1q"], tq[0]["w1k"]
    np.testing.assert_array_equal(wk.numpy(),
                                  wq.permute(2, 0, 1).reshape(C, 9 * C).numpy())


def test_conv3x3_reflect_s8_plain_exact(data):
    x, _, tq = data
    xq, _ = qi.quantize_act(torch.from_numpy(x))
    wq = tq[0]["w1q"].numpy().astype(np.int64)
    xp = np.pad(xq.numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                mode="reflect")
    ref = np.zeros((N, H, W, C), np.int64)
    for k in range(9):
        dy, dx = divmod(k, 3)
        ref += np.einsum("nhwi,io->nhwo", xp[:, dy:dy + H, dx:dx + W], wq[k])
    got = qi.conv3x3_reflect_s8_plain(xq, tq[0]["w1q"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k1_plain_fp32_matches_emulation(data):
    # fp32 carrier: the int8 tensors agree exactly; what is left is the
    # order of the fp32 IN sums (1.9e-6 measured)
    x, jq, tq = data
    ref = np.asarray(qp._resblock_int8_bf16io_emulate(jnp.asarray(x), jq[0]))
    got = qi.resblock_int8_bf16io_plain(torch.from_numpy(x), tq[0]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k1_plain_bf16_within_one_ulp(data):
    # bf16 carrier: the fp32 block output differs by ~1e-6, which can round
    # to the neighbouring bf16 value: at most one bf16 ulp
    x, jq, tq = data
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(qp._resblock_int8_bf16io_emulate(xb, jq[0])
                     .astype(jnp.float32))
    got = qi.resblock_int8_bf16io_plain(
        torch.from_numpy(x).bfloat16(), tq[0]).float().numpy()
    assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) * 1.0001)


def test_k1_plain_matches_pallas_interpret(data):
    # the TPU kernel itself, run by Pallas's interpreter (as the JAX tests
    # do): fp32 sum order only (2.4e-6 measured)
    x, jq, tq = data
    ref = np.asarray(qp._run_resblock_int8_bf16io(jnp.asarray(x), jq[0],
                                                  interpret=True))
    got = qi.resblock_int8_bf16io_plain(torch.from_numpy(x), tq[0]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k2_plain_matches_emulation(data):
    x, jq, tq = data
    jhq, jhs = qp.quantize_act(jnp.asarray(x))
    thq, ths = qi.quantize_act(torch.from_numpy(x))
    ref_q, ref_s = qp._resblock_int8_emulate(jhq, jhs, jq[0])
    got_q, got_s = qi.resblock_int8_plain(thq, ths, tq[0])
    # the int8 tensors are equal: no LSB flips at this shape and seed
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-6)


@pytest.mark.parametrize("name", ["resblock_chain_int8_bf16io",
                                  "resblock_chain_int8"])
def test_chains_match_emulation(data, name):
    # two blocks through either carrier: the int8 tensors agree, what is
    # left is the order of the fp32 sums (2.4e-6 measured)
    x, jq, tq = data
    ref = np.asarray(getattr(qp, name)(jnp.asarray(x), jq, force_emulate=True))
    got = getattr(qi, name)(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cpu_dispatch_uses_plain_and_launches_nothing(data):
    x, _, tq = data
    kr.reset_launches()
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(qi.resblock_int8_bf16io(xt, tq[0]).numpy(),
                                  qi.resblock_int8_bf16io_plain(xt, tq[0]).numpy())
    assert all(v == 0 for v in kr.launches.values())
