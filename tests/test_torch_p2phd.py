"""Slice 3 of the port: pix2pixHD inference for ``netG`` global and UNet.
``conv2d_reflect_thin``, ``MSRB``, the two generators, the int8 blocks K7
(cout-tiled res block) and K8 (MSRB branch) as plain versions, the two int8
engines and the inference engine, against the JAX package on the CPU from
the same seeded inputs.

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
from cistar_tpu.models.pix2pixhd import GlobalGenerator as JaxGlobal
from cistar_tpu.models.pix2pixhd import UNetGeneratorHD as JaxUNet
from cistar_tpu.models.pix2pixhd import define_g as jax_define_g
from cistar_tpu.ops import nn as jnn
from cistar_tpu.ops import quant_pallas as qp
from cistar_tpu.ops.blocks import MSRB as JaxMSRB
from cistar_tpu_torch.core.convert import (conv_w_from_hwio, generator_from_jax,
                                           global_generator_from_jax,
                                           unet_generator_hd_from_jax)
from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
from cistar_tpu_torch.kernels import int8_msrb as km
from cistar_tpu_torch.kernels import int8_tiled as kt
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import (AutoEncoder, BatchNorm,
                                               Encoder, GlobalGenerator,
                                               UNetGeneratorHD, define_g)
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops import quant_int8 as qi
from cistar_tpu_torch.ops.blocks import MSRB


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
# conv2d_reflect_thin and MSRB
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("form", ["stem", "head"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d_reflect_thin(form, dtype):
    # fp32: order of sums only (9.5e-7 measured), 1e-5. bf16: both
    # frameworks round the matmul to bf16 and add the 49 shifted maps in
    # bf16 in tap order; a matmul value on a rounding boundary may round the
    # other way, so within 2 bf16 ulps of the value.
    rng = np.random.RandomState(len(form) + len(dtype))
    cin, cout = (1, 6) if form == "stem" else (6, 1)
    x = _rand(rng, 2, 11, 13, cin)
    w, b = _rand(rng, 7, 7, cin, cout, scale=0.1), _rand(rng, cout)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(jnn.conv2d_reflect_thin(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
        .astype(jnp.float32))
    got = tnn.conv2d_reflect_thin(_t(x).to(tdt), _t(conv_w_from_hwio(w)), _t(b))
    assert got.dtype == tdt and tuple(got.shape) == (2, 11, 13, cout)
    got = got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= 2 * BF16_ULP * np.abs(ref))


def test_conv2d_reflect_thin_other_shapes_are_reflect_conv():
    rng = np.random.RandomState(2)
    x, w = _rand(rng, 1, 6, 6, 3), _rand(rng, 3, 3, 3, 4)
    tw = _t(conv_w_from_hwio(w))
    assert torch.equal(tnn.conv2d_reflect_thin(_t(x), tw),
                       tnn.conv2d_reflect(_t(x), tw))


# --------------------------------------------------------------------------- #
# The generators (global: ngf 8, 2 downs, 2 blocks, 32²; UNet: 8 features,
# 2 MSRB blocks, 64²)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gens():
    rng = np.random.RandomState(4)
    xg = (rng.rand(2, 32, 32, 1) * 2 - 1).astype(np.float32)
    xu = (rng.rand(2, 64, 64, 1) * 2 - 1).astype(np.float32)
    jg, ju = JaxGlobal(1, 8, 2, 2), JaxUNet(1, 2, 8)
    pg = _bump(_np(jax.jit(jg.init)(jax.random.PRNGKey(0),
                                    jnp.asarray(xg))["params"]), rng)
    pu = _bump(_np(jax.jit(ju.init)(jax.random.PRNGKey(1),
                                    jnp.asarray(xu))["params"]), rng)
    g = GlobalGenerator(1, 1, 8, 2, 2)
    g.load_state_dict(global_generator_from_jax(pg))
    u = UNetGeneratorHD(1, 1, 2, 8)
    u.load_state_dict(unet_generator_hd_from_jax(pu))
    return dict(xg=xg, xu=xu, jg=jg, ju=ju, pg=pg, pu=pu, g=g.eval(),
                u=u.eval())


def test_converters_map_every_node(gens):
    for conv, params, gen, key, path in (
            (global_generator_from_jax, gens["pg"], gens["g"],
             "trunk.up.1.convt.weight", ("trunk", "up_1", "convt")),
            (unet_generator_hd_from_jax, gens["pu"], gens["u"],
             "up_convt.2.weight", ("up_2_convt",))):
        sd, ref = conv(params), gen.state_dict()
        assert set(sd) == set(ref)
        for k, v in sd.items():
            assert v.shape == ref[k].shape, k
        w = params
        for p in path:
            w = w[p]
        # transpose conv: HWIO → (in, out, kh, kw), no flip
        np.testing.assert_array_equal(sd[key].numpy(),
                                      np.asarray(w["w"]).transpose(2, 3, 0, 1))
    sd = unet_generator_hd_from_jax(gens["pu"])
    np.testing.assert_array_equal(
        sd["msrb.1.b11_conv.weight"].numpy(),
        gens["pu"]["msrb_1"]["b11_conv"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["down_conv.0.bias"].numpy(),
                                  gens["pu"]["down_0_conv"]["b"])


@pytest.mark.parametrize("family", ["global", "UNet"])
def test_generator_fp32_matches_jax(gens, family):
    # fp32 throughout: order of sums only (1.4e-6 both measured); the gate
    # of tests/test_convert.py:89 is 2e-3, tightened to 1e-4
    jm, p, m, x = {"global": ("jg", "pg", "g", "xg"),
                   "UNet": ("ju", "pu", "u", "xu")}[family]
    ref = np.asarray(jax.jit(gens[jm].apply)({"params": gens[p]},
                                             jnp.asarray(gens[x])))
    with torch.no_grad():
        got = gens[m](_t(gens[x])).numpy()
    assert got.shape == gens[x].shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_define_g_dispatch():
    assert isinstance(define_g("global", 1, 1, 4, 1, 1), GlobalGenerator)
    assert isinstance(define_g("UNet", 1, 1, 4, 1, 1), UNetGeneratorHD)
    # encoder and autoencoder are ported now: JAX's Encoder(output_nc, ngf,
    # n_downsample_global) and AutoEncoder; an unknown netG raises as JAX's
    enc = define_g("encoder", 1, 3, 4, 2)
    assert isinstance(enc, Encoder) and len(enc.down) == 2
    assert enc.head.conv.weight.shape[0] == 3
    ae = define_g("autoencoder", 1, 1, 4, 2, 1)
    assert isinstance(ae, AutoEncoder)
    assert {"init_layer", "encoder_1", "resblock_0", "decoder_1",
            "output_layer"} <= set(dict(ae.named_children()))
    with pytest.raises(ValueError, match="not implemented"):
        define_g("nope", 1, 1, 4)
    # norm="batch" is ported now: every stage of the trunk gets a BatchNorm
    g = define_g("global", 1, 1, 4, 1, 1, norm="batch")
    assert isinstance(g.trunk.res[0].norm1, BatchNorm)
    assert isinstance(g.trunk.stem.norm, BatchNorm)


def test_define_g_unet_takes_any_norm():
    # JAX's define_g builds the same UNet whatever ``norm`` says; so does
    # the port's. fp32 forwards within test_generator_fp32_matches_jax's 1e-4.
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 64, 64, 1) * 2 - 1).astype(np.float32)
    jm = jax_define_g("UNet", 1, 8, n_blocks_global=2, norm="batch")
    assert isinstance(jm, JaxUNet)
    params = _bump(_np(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                        jnp.asarray(x))["params"]), rng)
    m = define_g("UNet", 1, 1, 8, n_blocks_global=2, norm="batch")
    assert isinstance(m, UNetGeneratorHD)
    m.load_state_dict(unet_generator_hd_from_jax(params))
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = m.eval()(_t(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# K7: the cout-tiled res block, plain
# --------------------------------------------------------------------------- #
C7 = 64


@pytest.fixture(scope="module")
def k7():
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 8, 8, C7)
    blk = {f"conv{i}": {"w": _rand(rng, 3, 3, C7, C7, scale=0.05),
                        "b": _rand(rng, C7, scale=0.01)} for i in (1, 2)}
    jq = qp.quantize_resblock(blk)
    from cistar_tpu_torch.ops.blocks import ResidualBlock
    tb = ResidualBlock(C7)
    tb.load_state_dict(generator_from_jax(blk))
    return x, jq, qi.quantize_resblock(tb)


def _jax_tiled_a(hx, qblk, ct):
    """Kernel A of ``_run_resblock_int8_tiled`` (its first pallas_call,
    quant_pallas.py:519-531) alone, in interpret mode: (rq, (n, t) rs)."""
    n, h, w, c = hx.shape
    t = c // ct
    hq, hs = qp.quantize_act(hx)
    vm, sm = pltpu.VMEM, pltpu.SMEM
    rq, rs = pl.pallas_call(
        functools.partial(qp._resblock_a_kernel, h=h, w=w, c=c, ct=ct,
                          eps=qp._EPS),
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


@pytest.mark.parametrize("ct", [64, 32, 16])
def test_k7_plain_matches_pallas_interpret_and_emulation(k7, ct):
    # K7a's int8 rq equals the TPU kernel A's exactly. Its IN statistics
    # are fp32 sums taken in another order (and its amax / 127.0 is
    # rewritten by XLA, see the K8 test), so a tile's scale may differ by an
    # ulp (1.2e-7 relative measured) while every int8 value is equal. The
    # block output is within 2e-5 of the emulation and of both TPU kernels
    # in interpret mode (1.9e-6 measured).
    x, jq, tq = k7
    jrq, jrs = _jax_tiled_a(jnp.asarray(x), jq, ct)
    rq, rs = qi.resblock_tiled_a_plain(_t(x), tq, ct)
    np.testing.assert_array_equal(rq.numpy(), jrq)
    np.testing.assert_allclose(rs.numpy(), jrs, rtol=1e-6, atol=0)
    got = qi.resblock_int8_tiled_plain(_t(x), tq, ct).numpy()
    for ref in (qp._resblock_int8_tiled_emulate(jnp.asarray(x), jq, ct),
                qp._run_resblock_int8_tiled(jnp.asarray(x), jq, ct,
                                            interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-5)


def test_k7_chain_matches_jax_and_takes_pick_cout_tile(k7, monkeypatch):
    # two blocks, explicit tile (fp32 sum order; 2.9e-6 measured)
    x, jq, tq = k7
    ref = np.asarray(qp.resblock_chain_int8_tiled(
        jnp.asarray(x), [jq, jq], cout_tile=32, force_emulate=True))
    got = qi.resblock_chain_int8_tiled(_t(x), [tq, tq], cout_tile=32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)
    # cout_tile=None: the port asks pick_cout_tile, as the JAX kernel path
    # does, and takes the first divisor where it raises
    seen, tiles = [], []
    monkeypatch.setattr(qi, "resblock_int8_tiled",
                        lambda hx, q, ct, bn: tiles.append(ct) or hx)
    monkeypatch.setattr(qi, "pick_cout_tile",
                        lambda hw, c: seen.append((hw, c)) or 16)
    qi.resblock_chain_int8_tiled(_t(x), [tq])
    assert seen == [(64, C7)] and tiles == [16]

    def over_budget(hw, c):
        raise ValueError("no cout tile")
    monkeypatch.setattr(qi, "pick_cout_tile", over_budget)
    qi.resblock_chain_int8_tiled(_t(x), [tq])
    assert tiles == [16, 64]
    # bn=True runs too (the BatchNorm form, tests/test_torch_multiscale.py);
    # on these IN weights it is another function, equal to JAX's
    monkeypatch.undo()
    got_bn = qi.resblock_chain_int8_tiled(_t(x), [tq], cout_tile=32, bn=True)
    np.testing.assert_array_equal(got_bn.numpy(), np.asarray(
        qp.resblock_chain_int8_tiled(jnp.asarray(x), [jq], cout_tile=32,
                                     force_emulate=True, bn=True)))


@pytest.mark.parametrize("hw,c", [(1024, 1024), (4096, 1024), (4096, 512),
                                  (1024, 512), (256, 256), (64, 64),
                                  (16384, 128), (4096, 96)])
def test_pick_cout_tile_is_jax(hw, c):
    def pick(mod):
        try:
            return mod.pick_cout_tile(hw, c)
        except ValueError:
            return "raises"
    assert pick(qi) == pick(qp)
    if (hw, c) == (1024, 1024):
        assert pick(qi) == 256


@pytest.mark.parametrize("h,w,c", [(32, 32, 1024), (32, 32, 512),
                                   (64, 64, 512), (16, 16, 1024), (8, 8, 64),
                                   (2, 40, 64), (64, 64, 256)])
def test_whole_image_resblock_fits_is_jax(h, w, c):
    assert qi.whole_image_resblock_fits(h, w, c) \
        == qp.whole_image_resblock_fits(h, w, c)
    if (h, w, c) == (32, 32, 1024):
        assert not qi.whole_image_resblock_fits(h, w, c)


@pytest.mark.parametrize("kk,groups,reflect", [(3, 4, True), (5, 2, False),
                                               (3, 1, False)])
def test_grouped_conv_plain_exact(k7, kk, groups, reflect):
    # each group's int32 partial, against int64 numpy; the partials sum to
    # the whole conv
    rng = np.random.RandomState(kk + groups)
    xq = rng.randint(-127, 128, (2, 6, 7, 32)).astype(np.int8)
    wq = rng.randint(-127, 128, (kk * kk, 32, 16)).astype(np.int8)
    p = kk // 2
    xp = np.pad(xq.astype(np.int64), ((0, 0), (p, p), (p, p), (0, 0)),
                mode="reflect" if reflect else "constant")
    cg = 32 // groups
    ref = np.zeros((groups, 2, 6, 7, 16), np.int64)
    for g in range(groups):
        for k in range(kk * kk):
            dy, dx = k // kk, k % kk
            ref[g] += np.einsum("nhwi,io->nhwo",
                                xp[:, dy:dy + 6, dx:dx + 7,
                                   g * cg:(g + 1) * cg],
                                wq[k, g * cg:(g + 1) * cg].astype(np.int64))
    got = (qi.conv3x3_reflect_grouped_s8_plain(_t(xq), _t(wq), groups)
           if reflect else qi.conv_zero_grouped_s8_plain(_t(xq), _t(wq), kk,
                                                         groups))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


# --------------------------------------------------------------------------- #
# K8: the MSRB branch, plain
# --------------------------------------------------------------------------- #
NF = 32


def _msrb_params(rng, n):
    mk = lambda kk, cin: {"w": _rand(rng, kk, kk, cin, n, scale=0.05),
                          "b": _rand(rng, n, scale=0.01)}
    return {"b00_conv": mk(3, n), "b01_conv": mk(5, n),
            "b10_conv": mk(3, 2 * n), "b11_conv": mk(5, 2 * n),
            "out_conv": mk(1, 2 * n)}


@pytest.fixture(scope="module")
def k8():
    rng = np.random.RandomState(8)
    x = _rand(rng, 2, 8, 8, NF)
    p = _msrb_params(rng, NF)
    m = MSRB(NF)
    m.load_state_dict(generator_from_jax(p))
    return x, p, qp.quantize_msrb(p), qi.quantize_msrb(m), m.eval()


def test_msrb_fp32_matches_jax(k8):
    # fp32, order of sums only (7.2e-7 measured); no residual add
    x, p, _, _, m = k8
    ref = np.asarray(JaxMSRB(NF).apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_quantize_msrb_exact(k8):
    _, _, jq, tq, _ = k8
    for k in ("w3a", "w5a", "sb1", "w3b", "w5b", "sb2", "w1x1", "b1x1"):
        ref = np.asarray(jq[k])
        np.testing.assert_array_equal(tq[k].numpy(), ref.reshape(tq[k].shape))
    # the CUDA operands hold the same int8: (Cout, kk²·Cin), k = tap·Cin + c
    for k in ("w3a", "w5a", "w3b", "w5b"):
        wq = tq[k]
        np.testing.assert_array_equal(
            tq[k + "k"].numpy(),
            wq.permute(2, 0, 1).reshape(wq.shape[2], -1).numpy())


@pytest.mark.parametrize("stage,quant_out", [("a", True), ("a", False),
                                             ("b", True), ("b", False)])
def test_k8_plain_matches_emulation_and_interpret(k8, stage, quant_out):
    # stage a: gin 1 on the input quantized per image; stage b: gin 2t on
    # the stage-1 int8 outputs with their tile scales (ct 16, t 2). Against
    # the emulation: int8 outputs and scales exact. Against the Pallas
    # kernel in interpret mode: int8 outputs exact, scales within an ulp,
    # because XLA rewrites the traced kernel's amax / 127.0 into a multiply
    # by 1/127, which misses IEEE division in ~4% of cases (37 of 1,000
    # values measured); the port divides, as the emulation does. Float
    # outputs within 2e-5 (4.8e-7 measured).
    x, _, jq, tq, _ = k8
    ct = 16
    xq, xs = qp.quantize_act(jnp.asarray(x))
    if stage == "b":
        o3, o5, s3, s5 = qp._msrb_stage_emulate(xq, xs, jq["w3a"], jq["w5a"],
                                                jq["sb1"], ct, True, None)
        xq = jnp.concatenate([o3, o5], -1)
        xs = jnp.concatenate([s3, s5], 1)
        assert xs.shape == (2, 2 * NF // ct)
    sb = "sb1" if stage == "a" else "sb2"
    args = (xq, xs, jq[f"w3{stage}"], jq[f"w5{stage}"], jq[sb], ct, quant_out,
            jnp.float32)
    got = qi.msrb_stage_plain(_t(np.asarray(xq)), _t(np.asarray(xs)),
                              tq[f"w3{stage}"], tq[f"w5{stage}"], tq[sb], ct,
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


def test_msrb_block_int8_matches_jax(k8):
    # int8 tensors agree; fp32 sums in the fuse (7.7e-7 measured). Within
    # the JAX msrb family budget (0.35) of the fp32 block (0.036 measured).
    x, p, jq, tq, _ = k8
    ref = np.asarray(qp.msrb_block_int8(jnp.asarray(x), jq, cout_tile=16,
                                        force_emulate=True))
    got = qi.msrb_block_int8(_t(x), tq, cout_tile=16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    fp32 = np.asarray(JaxMSRB(NF).apply({"params": p}, jnp.asarray(x)))
    assert np.abs(got.numpy() - fp32).max() < 0.35


def test_cpu_dispatch_uses_plain_and_launches_nothing(k7, k8):
    kt.reset_launches()
    km.reset_launches()
    x, _, tq = k7
    np.testing.assert_array_equal(
        qi.resblock_int8_tiled(_t(x), tq, 32).numpy(),
        qi.resblock_int8_tiled_plain(_t(x), tq, 32).numpy())
    assert torch.equal(qi.msrb_block_int8(_t(k8[0]), k8[3], 16),
                       qi.msrb_block_int8_plain(_t(k8[0]), k8[3], 16))
    assert all(v == 0 for v in (*kt.launches.values(), *km.launches.values()))


# --------------------------------------------------------------------------- #
# The int8 engines
# --------------------------------------------------------------------------- #
def test_global_int8_engine_matches_jax(gens):
    # K1 route (the trunk fits whole-image at this size, as at any CPU
    # size), explicit cout_tile as the JAX test passes it; fp32, int8
    # tensors equal, sum order left (5.5e-7 measured)
    x, p, g = gens["xg"], gens["pg"], gens["g"]
    h = fi.global_encode(g, _t(x))
    assert qi.whole_image_resblock_fits(*h.shape[1:])
    fwd = jax.jit(lambda p, q, x: jfi.global_generator_int8_trunk_apply(
        p, q, x, n_downsampling=2, n_blocks=2, cout_tile=16))
    ref = np.asarray(fwd(p, qp.quantize_global_trunk(p, 2), jnp.asarray(x)))
    with torch.no_grad():
        got = fi.global_generator_int8_trunk_apply(
            g, qi.quantize_global_trunk(g), _t(x), cout_tile=16).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_global_trunk_tiled_route_matches_jax(gens):
    # the K7 route of the same trunk, forced: JAX's tiled chain on the
    # trunk activation (fp32 sum order; 1.3e-6 measured)
    p, g = gens["pg"], gens["g"]
    with torch.no_grad():
        h = fi.global_encode(g, _t(gens["xg"]))
        got = qi.resblock_chain_int8_tiled(h, qi.quantize_global_trunk(g),
                                           16).numpy()
    ref = qp.resblock_chain_int8_tiled(jnp.asarray(h.numpy()),
                                       qp.quantize_global_trunk(p, 2),
                                       cout_tile=16, force_emulate=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)


def test_unet_int8_engine_matches_jax(gens):
    # fp32; int8 tensors equal, sum order left (1.3e-6 measured)
    x, p, u = gens["xu"], gens["pu"], gens["u"]
    fwd = jax.jit(lambda p, q, x: jfi.unet_msrb_int8_apply(p, q, x,
                                                           n_blocks=2))
    ref = np.asarray(fwd(p, jfi.quantize_unet_msrb(p, 2), jnp.asarray(x)))
    with torch.no_grad():
        got = fi.unet_msrb_int8_apply(u, fi.quantize_unet_msrb(u),
                                      _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# The inference engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["global", "UNet"])
def test_engine_matches_jax(gens, family):
    # fp32 compute: infer_step and infer_step_int8 of both engines on the
    # same params and labels (1.4e-6 / 1.3e-6 measured)
    p, x = (gens["pg"], gens["xg"]) if family == "global" \
        else (gens["pu"], gens["xu"])
    kw = dict(ngf=8, n_downsample_global=2, n_blocks_global=2)
    jeng = Pix2PixHD(net_g=family, compute_dtype=jnp.float32, **kw)
    teng = Pix2PixHDInference(family, compute_dtype=torch.float32,
                              device="cpu", **kw)
    teng.load_jax_params(p)
    label = jnp.asarray(x)
    pairs = [(jeng.infer_step(p, label), teng.infer_step(_t(x))),
             (jeng.infer_step_int8(p, jeng.quantize_generator(p), label),
              teng.infer_step_int8(teng.quantize_generator(), _t(x)))]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)


def test_encode_input_matches_jax():
    # one-hot labels (with one out of range) and the instance edge map
    rng = np.random.RandomState(9)
    label = rng.randint(0, 5, (2, 6, 7, 1)).astype(np.float32)
    label[0, 0, 0, 0] = 7
    inst = rng.randint(0, 3, (2, 6, 7, 1)).astype(np.float32)
    kw = dict(net_g="global", label_nc=5, r2l=False, no_instance=False)
    jeng = Pix2PixHD(**kw)
    teng = Pix2PixHDInference(ngf=4, n_downsample_global=1, n_blocks_global=1,
                              device="cpu", **kw)
    assert teng.g_input_nc() == jeng.g_input_nc() == 6
    ref = jeng.encode_input(jnp.asarray(label), jnp.asarray(inst))
    got = teng.encode_input(_t(label), _t(inst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_engine_refuses_unported_families():
    # encoder and autoencoder now build and serve; the int8 tier still
    # refuses them, as JAX's quantize_generator does
    for net_g in ("encoder", "autoencoder"):
        eng = Pix2PixHDInference(net_g, ngf=4, n_downsample_global=1,
                                 n_blocks_global=1, device="cpu")
        out = eng.infer_step(torch.zeros(1, 8, 8, 1))
        assert out.shape == (1, 8, 8, 1) and out.dtype == torch.float32
        with pytest.raises(NotImplementedError, match="no int8"):
            eng.quantize_generator()
    with pytest.raises(ValueError, match="not implemented"):
        Pix2PixHDInference("nope", device="cpu")
