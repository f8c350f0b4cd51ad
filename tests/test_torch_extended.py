"""Slice 15 of the port: the extended pix2pixHD modules and trainers
(``cistar_tpu_torch/models/pix2pixhd.py``: ``AutoEncoder``,
``InstanceNormAffine``, ``FeatureEncoder``, ``TransferGenerator``,
``TransferPairG``, ``WDiscriminator``, ``UDAEncoder``, ``UDADecoder``,
``DomainFeatureDiscriminator``; the converters; ``core/optim.py``'s
coupled weight decay and Python-float hyperparameters;
``engines/extended.py``: ``R2LAE``, ``R2LImageCritic``, ``R2LTransfer``,
``make_transfer_p2p``; the ``encoder`` / ``autoencoder`` / ``transfer``
families of ``engines/p2phd.py``; ``engines/factory.py``) against the JAX
package on the CPU, on seeded numpy inputs.

The weights are the port's, from its seed, converted to JAX's trees: one
conversion serves both the modules and the JAX trainers' states, so no JAX
``init`` is compiled (each costs 15-20 s on one core). The JAX trees'
structure and shapes are held to JAX's own ``init_state`` by
``jax.eval_shape``, which traces without compiling. The CLI, the UI
session and the feature tools are in ``tests/test_torch_extended_apps.py``.

Tolerances: fp32 forwards within 1e-4 of the reference's largest |value|
(the order of sums; 6.4e-6 measured, ``UDAEncoder`` with its linear head);
bf16 within 2⁻⁶ of it, two to four bf16 ulps at that value (1.4e-2
measured, the transfer pair; 9.3e-3 the next, ``UDAEncoder``); BatchNorm
running statistics within 1e-6 (6.0e-6 in bf16, where the batch mean is
of bf16 values: 1e-5). The steps, fp32: each metric within 1e-4 relative
(3.8e-7 measured), the decodes of the step within 2e-5 (3.9e-7), the
first Adam moment of each net within 2e-3 of its largest (6.2e-5, the
critic under the penalty's double backward; 5.8e-6 elsewhere), as
``tests/test_torch_p2phd_train.py`` holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cistar_tpu.engines import extended as jx
from cistar_tpu.engines import factory as jfactory
from cistar_tpu.engines.p2phd import P2PState as JaxP2PState
from cistar_tpu.engines.p2phd import Pix2PixHD as JaxP2P
from cistar_tpu.models import pix2pixhd as jm
from cistar_tpu_torch.apps import p2phd_options
from cistar_tpu_torch.core.convert import (batch_stats_to_jax,
                                           generator_from_jax,
                                           generator_to_jax)
from cistar_tpu_torch.core.optim import AdamState, adam_step
from cistar_tpu_torch.engines import extended as px
from cistar_tpu_torch.engines import factory
from cistar_tpu_torch.engines.p2phd import Pix2PixHD, Pix2PixHDInference
from cistar_tpu_torch.models import pix2pixhd as pm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_REL, BF16_REL, STATS_ABS = 1e-4, 2.0 ** -6, 1e-6
METRIC_RTOL, FAKE_ABS, GRAD_RTOL = 1e-4, 2e-5, 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_abs(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for (_, x), (_, y) in zip(la, lb))


def _frames(seed, n=2, size=32, c=1):
    r = np.random.RandomState(seed)
    return (r.rand(n, size, size, c) * 2 - 1).astype(np.float32)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


def _seeded_stats(net, seed):
    """Running statistics away from their 0 / 1 init, so that eval mode
    reads them."""
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, pm.BatchNorm):
                c = m.running_mean.shape[0]
                m.running_mean.copy_(_t(0.1 * r.randn(c).astype(np.float32)))
                m.running_var.copy_(_t(1 + 0.2 * r.rand(c).astype(np.float32)))


# --------------------------------------------------------------------------- #
# the modules
# --------------------------------------------------------------------------- #
# name → (port module, JAX module, input shape, has BatchNorm); built on
# demand, so that importing the file draws nothing from torch's generator
SPECS = {
    "autoencoder": (lambda: pm.AutoEncoder(1, 1, 4, 2, 1),
                    lambda: jm.AutoEncoder(1, 4, 2, 1), (2, 32, 32, 1), False),
    "feature_encoder": (lambda: pm.FeatureEncoder(1, 4, 3, 2),
                        lambda: jm.FeatureEncoder(4, 3, 2), (2, 32, 32, 1),
                        False),
    "feature_encoder_more_scales": (lambda: pm.FeatureEncoder(1, 4, 2, 3),
                                    lambda: jm.FeatureEncoder(4, 2, 3),
                                    (2, 32, 32, 1), False),
    "transfer_generator": (lambda: pm.TransferGenerator(1, 1, 4, 3),
                           lambda: jm.TransferGenerator(1, 1, 4, 3),
                           (2, 4, 4, 32), False),
    "transfer_pair": (lambda: pm.TransferPairG(1, 1, 4, 3, 2, 1),
                      lambda: jx.TransferPairG(1, 4, 3, 2, 1), (2, 32, 32, 1),
                      False),
    "wdisc": (lambda: pm.WDiscriminator(1, 4, 3, False, False),
              lambda: jm.WDiscriminator(4, 3, False, False), (2, 32, 32, 1),
              False),
    "wdisc_activate": (lambda: pm.WDiscriminator(1, 4, 3, True, False),
                       lambda: jm.WDiscriminator(4, 3, True, False),
                       (2, 32, 32, 1), False),
    "wdisc_flatten": (lambda: pm.WDiscriminator(1, 4, 3, False, True),
                      lambda: jm.WDiscriminator(4, 3, False, True),
                      (2, 32, 32, 1), False),
    "uda_encoder": (lambda: pm.UDAEncoder(1, 32, 2, 4, 1, False, 8),
                    lambda: jm.UDAEncoder(32, 2, 4, 1, False, 8),
                    (2, 32, 32, 1), True),
    "uda_encoder_linear": (lambda: pm.UDAEncoder(1, 32, 2, 4, 1, True, 8),
                           lambda: jm.UDAEncoder(32, 2, 4, 1, True, 8),
                           (2, 32, 32, 1), True),
    "uda_decoder": (lambda: pm.UDADecoder(8, 1, 2, 1),
                    lambda: jm.UDADecoder(1, 32, 8, 2, 1), (2, 8, 8, 8), True),
    "domain_feature_d": (lambda: pm.DomainFeatureDiscriminator(8),
                         lambda: jm.DomainFeatureDiscriminator(),
                         (2, 8, 8, 8), True),
}
MODULES = list(SPECS)
_CASES = [(n, dt, tr) for n in MODULES for dt in ("float32", "bfloat16")
          for tr in ((True, False) if SPECS[n][3] else (None,))]


def _build(name, seed):
    port, jax_, shape, has_bn = SPECS[name]
    torch.manual_seed(seed)
    return port(), jax_(), shape, has_bn


@pytest.mark.parametrize("name,dtype,train", _CASES)
def test_module_matches_jax(name, dtype, train):
    # the port's weights (and running statistics) through the converter
    # into JAX's module; train mode moves the running statistics as JAX's
    # mutable batch_stats
    net, jnet, shape, _ = _build(name, MODULES.index(name))
    _seeded_stats(net, 3)
    sd = net.state_dict()
    params, stats = generator_to_jax(sd), batch_stats_to_jax(sd)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    if train is None:
        ref, mut = jax.jit(jnet.apply)({"params": params}, xj), None
    else:
        ref, mut = jax.jit(functools.partial(
            jnet.apply, train=train, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, xj)
        net.train(train)
    with torch.no_grad():
        got = net(_t(x).to(tdt))
    # JAX's linear head and flatten promote to fp32; the maps keep the dtype
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    tol = (FWD_REL if dtype == "float32" else BF16_REL) * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    if train:
        want = _np(mut["batch_stats"])
        assert _max_abs(batch_stats_to_jax(net.state_dict()), want) <= (
            STATS_ABS if dtype == "float32" else 10 * STATS_ABS)
        assert _max_abs(want, stats) > 0      # they moved
    elif train is False:
        assert _max_abs(batch_stats_to_jax(net.state_dict()), stats) == 0


@pytest.mark.parametrize("name", MODULES)
def test_converters_round_trip(name):
    # port → JAX → port is the identity; the JAX tree has JAX init's
    # structure and shapes; JAX → port → JAX rounds only γ − 1 + 1
    net, jnet, shape, has_bn = _build(name, 7)
    _seeded_stats(net, 4)
    sd = net.state_dict()
    params, stats = generator_to_jax(sd), batch_stats_to_jax(sd)
    back = generator_from_jax(params, batch_stats=stats or {})
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    init = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    assert _shapes(params) == jax.tree.map(lambda s: s.shape, init["params"])
    assert (stats is not None) == has_bn == ("batch_stats" in init)
    if has_bn:
        assert _shapes(stats) == jax.tree.map(lambda s: s.shape,
                                              init["batch_stats"])
    r = np.random.RandomState(5)
    moved = jax.tree.map(lambda a: a + np.float32(0.01) * r.randn(
        *a.shape).astype(np.float32), params)
    net.load_state_dict(generator_from_jax(moved, batch_stats=stats or {}))
    assert _max_abs(generator_to_jax(net.state_dict()), moved) <= 1e-7


def test_autoencoder_stages_and_define_g():
    # encode / decode are JAX's named halves; define_g builds the two new
    # netG families, and refuses an unknown one as JAX does
    torch.manual_seed(0)
    ae = pm.define_g("autoencoder", 1, 1, 4, 2, 1)
    assert isinstance(ae, pm.AutoEncoder)
    params = generator_to_jax(ae.state_dict())
    assert set(params) == {"init_layer", "encoder_0", "encoder_1",
                           "resblock_0", "decoder_0", "decoder_1",
                           "output_layer"}
    x = _frames(2)
    jae = jm.AutoEncoder(1, 4, 2, 1)
    h = jae.apply({"params": params}, jnp.asarray(x), method=jm.AutoEncoder.encode)
    with torch.no_grad():
        got = ae.encode(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(h), rtol=0,
                                   atol=FWD_REL * float(np.abs(h).max()))
        assert torch.equal(ae.decode(got), ae(_t(x)))
    enc = pm.define_g("encoder", 2, 3, 4, 2)
    assert isinstance(enc, pm.Encoder) and enc.stem.conv.weight.shape[1] == 2
    assert enc.head.conv.weight.shape[0] == 3
    with pytest.raises(ValueError, match="not implemented"):
        pm.define_g("transfer", 1, 1, 4)


def test_instance_norm_affine_matches_jax():
    # γ = gamma + 1 and β over an instance norm, fp32 and bf16
    r = np.random.RandomState(9)
    x = (r.randn(2, 5, 6, 3) * 3 + 1).astype(np.float32)
    p = {"gamma": (0.1 * r.randn(3)).astype(np.float32),
         "beta": (0.1 * r.randn(3)).astype(np.float32)}
    norm = pm.InstanceNormAffine(3)
    norm.load_state_dict({k[2:]: v for k, v in
                          generator_from_jax({"n": p},
                                             batch_stats={}).items()})
    for dt, tol in (("float32", 1e-6), ("bfloat16", 2.0 ** -7)):
        ref = jm.NormLayer("instance_affine").apply(
            {"params": p}, jnp.asarray(x).astype(getattr(jnp, dt)))
        with torch.no_grad():
            got = norm(_t(x).to(getattr(torch, dt)))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


# --------------------------------------------------------------------------- #
# the critic's optimizer
# --------------------------------------------------------------------------- #
def test_critic_adam_is_optax_chain_bit_for_bit():
    # add_decayed_weights(1e-4) then adam(lr, 0.5, 0.9): Python-float
    # hyperparameters (1 − 0.9 rounded once), the decay coupled into the
    # gradient; three steps, params and both moments bit for bit
    import optax

    r = np.random.RandomState(0)
    ps = [r.randn(3, 4).astype(np.float32),
          (1e-3 * r.randn(5)).astype(np.float32)]
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.adam(1e-4, b1=0.5, b2=0.9))
    jp = [jnp.asarray(p) for p in ps]
    st = tx.init(jp)
    tp = [_t(p.copy()) for p in ps]
    ts = AdamState(tp)
    for step in range(3):
        gs = [(r.randn(*p.shape) * 10.0 ** -step).astype(np.float32)
              for p in ps]
        u, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, u)
        adam_step(tp, [_t(g) for g in gs], ts, torch.tensor(1e-4),
                  torch.tensor(True), b1=0.5, b2=0.9, weight_decay=1e-4,
                  injected=False)
        for a, b in zip(jp, tp):
            assert np.array_equal(np.asarray(a), b.numpy())
        for a, b in zip(st[1][0].mu + st[1][0].nu, ts.mu + ts.nu):
            assert np.array_equal(np.asarray(a), b.numpy())
    # the injected form differs: 1 − fp32(0.9) is not fp32(0.1)
    assert np.float32(1) - np.float32(0.9) != np.float32(1 - 0.9)


# --------------------------------------------------------------------------- #
# the trainers
# --------------------------------------------------------------------------- #
def _mu_err(net, opt, want):
    """Adam's first moment of ``net``'s params, port vs JAX: max-abs error
    over the largest |moment| of JAX's."""
    names = [n for n, _ in net.named_parameters()]
    sd = net.state_dict()
    got = jax.tree.map(
        np.subtract, generator_to_jax(dict(sd, **dict(zip(names, opt.mu)))),
        generator_to_jax(dict(sd, **{n: torch.zeros_like(sd[n])
                                     for n in names})))
    want = _np(want)
    scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
    assert scale > 0
    return _max_abs(got, want) / scale


def _metrics_close(m, jm_):
    assert set(m) == set(jm_)
    for k, v in m.items():
        assert v.dtype == torch.float32 and v.ndim == 0
        np.testing.assert_allclose(v.numpy(), np.asarray(jm_[k]),
                                   rtol=METRIC_RTOL, err_msg=k)


UDA = dict(size=64, n_downsample=1, ngf=4, max_ch=8, ndf=4)


@pytest.mark.parametrize("wgan", [False, True])
def test_r2lae_step_matches_jax(wgan):
    # one joint step: every metric, both decodes, the BatchNorm statistics
    # (the encoder's over radar ‖ lidar, DF's over the features, each
    # decoder's over its half), the first moments of all six nets; then
    # eval-mode inference after the step
    eng = px.R2LAE(wgan=wgan, compute_dtype=torch.float32, device="cpu", **UDA)
    st = eng.init_state(0)
    jeng = jx.R2LAE(wgan=wgan, compute_dtype=jnp.float32, **UDA)
    trees = eng.jax_params()
    jst = jx.R2LAEState(
        **{k: trees[k] for k in px.NETS},
        opts={k: jeng.tx.init(trees[k]) for k in px.NETS},
        stats=trees["stats"], rng=jax.random.PRNGKey(0),
        epoch=jnp.zeros((), jnp.int32))
    want = jax.eval_shape(jeng.init_state, jax.random.PRNGKey(0))
    assert _shapes({k: trees[k] for k in px.NETS} | {"stats": trees["stats"]}) \
        == jax.tree.map(lambda s: s.shape,
                        {k: getattr(want, k) for k in px.NETS + ("stats",)})
    radar, lidar = _frames(10, size=64), _frames(11, size=64)
    jst, jmet, jfakes = jeng.train_step(jst, jnp.asarray(radar),
                                        jnp.asarray(lidar))
    st, met, fakes = eng.train_step(st, _t(radar), _t(lidar))
    _metrics_close(met, jmet)
    for k in ("lidar_gen", "radar_gen"):
        np.testing.assert_allclose(fakes[k].numpy(), np.asarray(jfakes[k]),
                                   rtol=0, atol=FAKE_ABS)
    assert _max_abs(eng.jax_params()["stats"], _np(jst.stats)) <= STATS_ABS
    nets = eng.nets()
    for k in px.NETS:
        assert _mu_err(nets[k], st.opts[k], jst.opts[k].inner_state[0].mu) \
            <= GRAD_RTOL, k
        assert int(st.opts[k].count) == 1
    assert not any(b.training for m in nets.values() for b in m.modules()
                   if isinstance(b, pm.BatchNorm))
    assert all(p.grad is None for m in nets.values() for p in m.parameters())
    # eval mode with the running statistics, after the step: the weights
    # each package stepped (a gradient within rounding of 0 can take Adam's
    # ±lr either way) give outputs within 5e-4 (1.1e-4 measured)
    ref = jeng.infer(jst, jnp.asarray(radar), jnp.asarray(lidar))
    got = eng.infer(st, _t(radar), _t(lidar))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=5e-4)


def test_r2lae_eval_is_batch_independent():
    # eval mode normalizes with the running statistics: a frame's decode
    # does not depend on the rest of its batch
    eng = px.R2LAE(compute_dtype=torch.float32, device="cpu", **UDA)
    st = eng.init_state(0)
    radar, lidar = _frames(20, n=3, size=64), _frames(21, n=3, size=64)
    st, _, _ = eng.train_step(st, _t(radar[:2]), _t(lidar[:2]))
    both = eng.infer(st, _t(radar), _t(lidar))
    for i in range(3):
        one = eng.infer(st, _t(radar[i:i + 1]), _t(lidar[i:i + 1]))
        for k in both:
            np.testing.assert_allclose(one[k][0].numpy(), both[k][i].numpy(),
                                       rtol=0, atol=1e-6)
    # train mode does depend on it: the batch statistics
    assert not torch.equal(eng.E.down_0_bn.running_mean,
                           torch.zeros_like(eng.E.down_0_bn.running_mean))


def test_critic_step_matches_jax():
    # one step with JAX's own interpolation weights (split of its rng), fed
    # through gradient_penalty_at; the penalty's double backward
    eng = px.R2LImageCritic(ngf=4, n_layer=3, compute_dtype=torch.float32,
                            device="cpu")
    st = eng.init_state(0)
    jeng = jx.R2LImageCritic(ngf=4, n_layer=3, compute_dtype=jnp.float32)
    d = eng.jax_params()["d"]
    want = jax.eval_shape(lambda k: jeng.init_state(k, 32),
                          jax.random.PRNGKey(0))
    assert _shapes(d) == jax.tree.map(lambda s: s.shape, want.d)
    rng = jax.random.PRNGKey(3)
    jst = jx.CriticState(d=d, opt=jeng.tx.init(d), rng=rng)
    eps = np.asarray(jax.random.uniform(jax.random.split(rng)[1],
                                        (2, 1, 1, 1), dtype=jnp.float32))
    lidar, radar = _frames(30), _frames(31)
    jst, jmet = jeng.train_step(jst, jnp.asarray(lidar), jnp.asarray(radar))
    st, met = eng.train_step(st, _t(lidar), _t(radar), eps=_t(eps))
    _metrics_close(met, jmet)
    assert float(met["gp"]) > 0
    assert _mu_err(eng.D, st.opt, jst.opt[1][0].mu) <= GRAD_RTOL
    # without eps the draws come from the state's generator
    st, met2 = eng.train_step(st, _t(lidar), _t(radar))
    assert int(st.opt.count) == 2 and torch.isfinite(met2["gp"])


TRANSFER = dict(ngf=4, n_downsampling=3, n_scale=2, n_blocks=1, ndf=4,
                df_layers=2, image_size=32)


@pytest.mark.parametrize("floor,df_moves", [(0.0, True), (1e9, False)])
def test_r2ltransfer_step_matches_jax(floor, df_moves):
    # the feature critic's gate both ways (its params and whole Adam state,
    # count included, unchanged when closed), the encoder against the
    # updated critic, the log-only feature matching, the cross decodes; the
    # frozen nets bit for bit unchanged
    eng = px.R2LTransfer(compute_dtype=torch.float32, device="cpu",
                         d_loss_floor=floor, **TRANSFER)
    st = eng.init_state(0)
    frozen = eng.init_frozen(1)
    jeng = jx.R2LTransfer(compute_dtype=jnp.float32, d_loss_floor=floor,
                          **TRANSFER)
    trees, jfrozen = eng.jax_params(), eng.frozen_to_jax(frozen)
    shapes = jax.eval_shape(jeng.init_frozen, jax.random.PRNGKey(0))
    assert _shapes(jfrozen) == jax.tree.map(lambda s: s.shape, shapes)
    jst = jx.R2LState(lidar_e=trees["lidar_e"], net_df=trees["net_df"],
                      opt_lidar_e=jeng.tx.init(trees["lidar_e"]),
                      opt_df=jeng.tx.init(trees["net_df"]),
                      rng=jax.random.PRNGKey(0),
                      epoch=jnp.zeros((), jnp.int32))
    df0 = {k: v.detach().clone() for k, v in st.net_df.items()}
    opt0 = (st.opt_df.mu_flat.clone(), st.opt_df.nu_flat.clone())
    radar, lidar = _frames(40), _frames(41)
    jst, jmet, jdec = jeng.train_step(jst, jfrozen, jnp.asarray(radar),
                                      jnp.asarray(lidar))
    st, met, dec = eng.train_step(st, frozen, _t(radar), _t(lidar))
    _metrics_close(met, jmet)
    assert bool(met["D_Loss"] > floor) == df_moves
    for got, want in zip(dec, jdec):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FAKE_ABS)
    assert _mu_err(eng.E, st.opt_lidar_e,
                   jst.opt_lidar_e.inner_state[0].mu) <= GRAD_RTOL
    assert int(st.opt_df.count) == int(jst.opt_df.inner_state[0].count) \
        == int(df_moves)
    moved = any(not torch.equal(df0[k], v) for k, v in st.net_df.items())
    assert moved == df_moves
    if df_moves:
        assert _mu_err(eng.DF, st.opt_df,
                       jst.opt_df.inner_state[0].mu) <= GRAD_RTOL
    else:
        assert torch.equal(st.opt_df.mu_flat, opt0[0])
        assert torch.equal(st.opt_df.nu_flat, opt0[1])
    assert _max_abs(eng.frozen_to_jax(frozen), jfrozen) == 0
    assert all(not p.requires_grad and p.grad is None
               for m in frozen.values() for p in m.parameters())


def test_frozen_from_checkpoints():
    # a given JAX tree replaces its net's random init; the others keep it
    eng = px.R2LTransfer(compute_dtype=torch.float32, device="cpu",
                         **TRANSFER)
    base = eng.frozen_to_jax(eng.init_frozen(1))
    g = jax.tree.map(lambda a: a + np.float32(0.5), base["lidar_g"])
    got = eng.frozen_to_jax(eng.frozen_from_checkpoints(1, lidar_g=g))
    assert _max_abs(got["lidar_g"], g) == 0
    assert _max_abs({k: v for k, v in got.items() if k != "lidar_g"},
                    {k: v for k, v in base.items() if k != "lidar_g"}) == 0
    with pytest.raises(KeyError):
        eng.frozen_from_checkpoints(1, lidar_e=g)


P2P = dict(ndf=4, num_d=2, n_layers_d=2, image_size=32)


def _p2p_step_both(teng, jeng, seed):
    """One Pix2PixHD step of the port and of JAX from the port's weights."""
    st = teng.init_state(0)
    trees = teng.jax_params()
    want = jax.eval_shape(jeng.init_state, jax.random.PRNGKey(0))
    assert _shapes(trees["G"]) == jax.tree.map(lambda s: s.shape, want.g)
    jst = JaxP2PState(g=trees["G"], d=trees["D"], opt_g=jeng.tx.init(trees["G"]),
                      opt_d=jeng.tx.init(trees["D"]), pool=None,
                      rng=jax.random.PRNGKey(0),
                      epoch=jnp.zeros((), jnp.int32))
    label, image = _frames(seed), _frames(seed + 1)
    jst, jmet, jfake = jeng.train_step(jst, jnp.asarray(label), None,
                                       jnp.asarray(image))
    st, met, fake = teng.train_step(st, _t(label), None, _t(image))
    _metrics_close(met, jmet)
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=0,
                               atol=FAKE_ABS)
    assert _mu_err(teng.G, st.opt_g, jst.opt_g.inner_state[0].mu) <= GRAD_RTOL
    assert _mu_err(teng.D, st.opt_d, jst.opt_d.inner_state[0].mu) <= GRAD_RTOL
    return st


def test_transfer_pair_step_matches_jax():
    # make_transfer_p2p: Pix2PixHD with G = TransferGenerator ∘
    # FeatureEncoder, JAX's names E / G
    kw = dict(ngf=4, n_downsampling=3, n_scale=2, n_blocks=1, **P2P)
    teng = px.make_transfer_p2p(compute_dtype=torch.float32, device="cpu",
                                **kw)
    assert teng.net_g == "transfer" and isinstance(teng.G, pm.TransferPairG)
    _p2p_step_both(teng, jx.make_transfer_p2p(compute_dtype=jnp.float32, **kw),
                   50)


def test_autoencoder_p2p_step_matches_jax():
    kw = dict(net_g="autoencoder", ngf=4, n_downsample_global=2,
              n_blocks_global=1, **P2P)
    teng = Pix2PixHD(compute_dtype=torch.float32, device="cpu", **kw)
    _p2p_step_both(teng, JaxP2P(compute_dtype=jnp.float32, **kw), 60)


@pytest.mark.parametrize("net_g", ["encoder", "autoencoder", "transfer"])
def test_new_families_serve_and_refuse_int8(net_g):
    # the plain forward (bf16 and fp32) against JAX's, the weights through
    # jax_params / load_jax_params, and no int8 engine, as in JAX
    # transfer at n_scale 3 needs 3 downs: FeatureEncoder emits ngf·2^3
    # channels, which the TransferGenerator's blocks must take (in JAX too)
    n_down = 3 if net_g == "transfer" else 2
    kw = dict(ngf=4, n_downsample_global=n_down, n_blocks_global=1,
              device="cpu")
    outs = {}
    for cdt in (torch.float32, torch.bfloat16):
        eng = Pix2PixHDInference(net_g, compute_dtype=cdt, seed=2, **kw)
        trees = eng.jax_params()
        assert trees["G_stats"] is None
        eng.load_jax_params(trees["G"])
        outs[cdt] = eng.infer_step(_t(_frames(70)))
        with pytest.raises(NotImplementedError, match="no int8"):
            eng.quantize_generator()
    for cdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        if net_g == "transfer":
            jeng = jx.make_transfer_p2p(ngf=4, n_downsampling=n_down,
                                        n_blocks=1, compute_dtype=jdt)
        else:
            jeng = JaxP2P(net_g=net_g, ngf=4, n_downsample_global=n_down,
                          n_blocks_global=1, compute_dtype=jdt)
        ref = np.asarray(jeng.infer_step(trees["G"],
                                         jnp.asarray(_frames(70))))
        err = float(np.abs(outs[cdt].numpy() - ref).max())
        assert err <= (FWD_REL if cdt == torch.float32 else BF16_REL) \
            * float(np.abs(ref).max())
    with pytest.raises(NotImplementedError, match="no int8"):
        jeng.quantize_generator(trees["G"])


# --------------------------------------------------------------------------- #
# the factory
# --------------------------------------------------------------------------- #
def _opt(*flags):
    return p2phd_options.TrainOptions().parse(
        ["--dataroot", "x", "--checkpoints_dir", "/nonexistent",
         "--device", "cpu", "--ngf", "4", "--ndf", "4", "--r2l",
         "--r2l_res", "64", "--n_downsample_global", "1",
         "--n_blocks_global", "1", "--max_ch", "8", *flags], save=False)


@pytest.mark.parametrize("flags,cls,jcls", [
    ([], Pix2PixHD, JaxP2P),
    (["--wgan"], px.R2LTransfer, jx.R2LTransfer),
    (["--transfer"], Pix2PixHD, JaxP2P),
    (["--fp16"], Pix2PixHD, JaxP2P),
    (["--data_type", "16"], Pix2PixHD, JaxP2P),
    (["--wgan", "--fp16"], px.R2LTransfer, jx.R2LTransfer)])
def test_create_model_dispatch_and_dtype(flags, cls, jcls):
    # --wgan → R2LTransfer, --transfer → the transfer pair, else Pix2PixHD;
    # bf16 with --fp16 or --data_type 16, fp32 otherwise, as JAX's
    opt = _opt(*flags)
    eng, jeng = factory.create_model(opt), jfactory.create_model(opt)
    assert type(eng) is cls and type(jeng) is jcls
    assert str(eng.cdt).split(".")[-1] == jnp.dtype(jeng.cdt).name
    assert eng.device.type == "cpu"
    if "--transfer" in flags:
        assert eng.net_g == jeng.net_g == "transfer"
    if cls is Pix2PixHD:
        assert eng.net_g == jeng.net_g


@pytest.mark.parametrize("flags,cls,jcls", [
    ([], px.R2LImageCritic, jx.R2LImageCritic),
    (["--training_module", "autoencoder"], px.R2LAE, jx.R2LAE),
    (["--training_module", "autoencoder", "--wgan"], px.R2LAE, jx.R2LAE),
    (["--training_module", "autoencoder", "--fp16"], px.R2LAE, jx.R2LAE),
    (["--data_type", "16"], px.R2LImageCritic, jx.R2LImageCritic),
    (["--fp16"], px.R2LImageCritic, jx.R2LImageCritic)])
def test_create_uda_model_dispatch_and_dtype(flags, cls, jcls):
    # by --training_module; bf16 with --fp16 alone (not --data_type 16)
    opt = _opt(*flags)
    eng, jeng = factory.create_uda_model(opt), jfactory.create_uda_model(opt)
    assert type(eng) is cls and type(jeng) is jcls
    assert str(eng.cdt).split(".")[-1] == jnp.dtype(jeng.cdt).name
    if cls is px.R2LAE:
        assert isinstance(eng.DF, pm.WDiscriminator) == ("--wgan" in flags)
        assert isinstance(jeng.DF, jm.WDiscriminator) == ("--wgan" in flags)


def test_create_model_and_the_cli_build_the_same_pix2pixhd():
    # one mapping from options to Pix2PixHD serves the factory and
    # p2phd_train: the same nets from the same seed, the feature encoder's
    # options passed on (JAX's factory drops them), each its own dtype rule
    opt = _opt("--instance_feat", "--feat_num", "2", "--nef", "4",
               "--n_downsample_E", "2", "--no_vgg_loss")
    from cistar_tpu_torch.apps import p2phd_train

    eng, cli = factory.create_model(opt), p2phd_train.make_engine(opt, 64)
    assert isinstance(eng.E, pm.Encoder)
    assert eng.E.head.conv.weight.shape[0] == 2
    assert (eng.cdt, cli.cdt) == (torch.float32, torch.bfloat16)
    for name in ("G", "D", "E"):
        a, b = getattr(eng, name).state_dict(), getattr(cli, name).state_dict()
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), name
