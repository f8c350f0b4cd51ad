"""Slice 11 of the port: the CycleGAN training step and its CLI
(``cistar_tpu_torch/losses/gan.py``, ``models/cyclegan.py::
PatchDiscriminator``, ``utils/image_pool.py``, ``core/optim.py``,
``engines/cyclegan.py::CycleGAN``, ``core/checkpoint.py``,
``apps/cyclegan_train.py``) against the JAX package on the CPU, on the
same weights (the JAX init, converted) and inputs.

One JAX engine serves every test: its first ``train_step`` compiles for
about half a minute on one core, and a second engine would compile again.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from cistar_tpu.core import checkpoint as jckpt
from cistar_tpu.engines.cyclegan import CycleGAN as JaxCycleGAN
from cistar_tpu.losses import gan as jgan
from cistar_tpu.models.cyclegan import \
    MultiscaleBilinearGenerator as JaxBilinear
from cistar_tpu.models.cyclegan import PatchDiscriminator as JaxD
from cistar_tpu.models.cyclegan import ResnetGenerator as JaxResnet
from cistar_tpu.utils import image_pool as jpool
from cistar_tpu_torch.apps import cyclegan_train
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.core.convert import (generator_from_jax,
                                           generator_to_jax,
                                           patch_discriminator_from_jax,
                                           patch_discriminator_to_jax,
                                           resnet_generator_from_jax,
                                           resnet_generator_to_jax)
from cistar_tpu_torch.core.optim import AdamState, adam_step
from cistar_tpu_torch.engines.cyclegan import CycleGAN, lambda_lr_factor
from cistar_tpu_torch.losses import gan
from cistar_tpu_torch.models.cyclegan import (MultiscaleBilinearGenerator,
                                              PatchDiscriminator,
                                              ResnetGenerator)
from cistar_tpu_torch.utils import image_pool as pool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F, NB, SIZE, BATCH, POOL, MIN_POINTS = 4, 1, 32, 2, 4, 10
CFG = dict(gen_type="bilinear_content", in_features=F, n_residual_blocks=NB,
           image_size=SIZE, batch_size=BATCH, pool_size=POOL,
           min_points=MIN_POINTS)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames(seed, n=BATCH, dense=True):
    """NHWC frames in [-1, 1]: dense ones (about half the pixels above 0,
    so far over ``MIN_POINTS``), or sparse ones (all -1, no points)."""
    if not dense:
        return -np.ones((n, SIZE, SIZE, 1), np.float32)
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 1) * 2
            - 1).astype(np.float32)


NETS = ("g_a2b", "g_b2a", "d_a", "d_b")


@pytest.fixture(scope="module")
def jeng():
    """The JAX engine, its initial params as numpy trees, and its initial
    state (copy it before a ``train_step``, which donates it)."""
    eng = JaxCycleGAN(compute_dtype=jnp.float32, **CFG)
    st = eng.init_state(jax.random.PRNGKey(0))
    return eng, {f: _np(getattr(st, f)) for f in NETS}, st


def _port(jeng, **kw):
    """The port's engine on the CPU, with the JAX engine's initial
    weights, and its state."""
    _, params, _ = jeng
    cfg = dict(CFG, compute_dtype=torch.float32, device="cpu")
    cfg.update(kw)
    eng = CycleGAN(**cfg)
    state = eng.init_state(0)
    eng.load_jax_params(**params)
    return eng, state


# --------------------------------------------------------------------------- #
# losses/gan.py
# --------------------------------------------------------------------------- #
def _loss_cases():
    r = np.random.RandomState(1)
    a = (r.randn(2, 8, 8, 1) * 2).astype(np.float32)
    b = r.rand(2, 8, 8, 1).astype(np.float32)
    p = [r.randn(3).astype(np.float32) for _ in range(3)]
    return {
        "mse": (lambda m: m.mse_loss, (a, b)),
        "l1": (lambda m: m.l1_loss, (a, b)),
        "bce": (lambda m: m.bce_with_logits, (a, b)),
        "lsgan_real": (lambda m: lambda x: m.lsgan_loss(x, True), (a,)),
        "lsgan_fake": (lambda m: lambda x: m.lsgan_loss(x, False), (a,)),
        "gan_tensor": (lambda m: lambda x: m.gan_loss(x, True), (a,)),
        "gan_list_bce": (lambda m: lambda *x: m.gan_loss(
            list(x), False, use_lsgan=False), tuple(p)),
        "gan_list_of_lists": (lambda m: lambda x, y, z: m.gan_loss(
            [[x, y], [z]], True), tuple(p)),
        "energy_reg": (lambda m: m.energy_reg, (a, b)),
        "count_points": (lambda m: m.count_points, (a,)),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_loss_matches_jax(name):
    fn, args = _loss_cases()[name]
    want = np.asarray(fn(jgan)(*(jnp.asarray(x) for x in args)))
    got = fn(gan)(*(_t(x) for x in args))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_gradient_penalty_matches_jax():
    # an elementwise critic, so the comparison sees the penalty's own
    # arithmetic; eps is JAX's own draw, fed to the port's core
    r = np.random.RandomState(2)
    real, fake = r.randn(2, 2, 6, 6, 1).astype(np.float32)
    w = r.randn(6, 6, 1).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jcrit(wt):
        return lambda x: jnp.tanh(x * wt).mean(axis=(1, 2, 3))

    def jgp(wt):
        return jgan.gradient_penalty(jcrit(wt), jnp.asarray(real),
                                     jnp.asarray(fake), key)

    want, want_dw = jax.value_and_grad(jgp)(jnp.asarray(w))
    eps = jax.random.uniform(key, (2, 1, 1, 1), dtype=jnp.float32)
    wt = _t(w).requires_grad_(True)
    crit = lambda x: torch.tanh(x * wt).mean(dim=(1, 2, 3))  # noqa: E731
    got = gan.gradient_penalty_at(crit, _t(real), _t(fake), _t(np.asarray(eps)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # create_graph: the penalty trains the critic
    got_dw, = torch.autograd.grad(got, wt)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-6)
    # the drawing form: eps from an explicit generator, reproducibly
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(gan.gradient_penalty(crit, _t(real), _t(fake), g1),
                       gan.gradient_penalty(crit, _t(real), _t(fake), g2))


# --------------------------------------------------------------------------- #
# PatchDiscriminator, converters, gradients
# --------------------------------------------------------------------------- #
def test_discriminator_forward_matches_jax(jeng):
    _, params, _ = jeng
    x = _frames(7)
    want = np.asarray(JaxD().apply({"params": params["d_a"]}, jnp.asarray(x)))
    d = PatchDiscriminator(1)
    d.load_state_dict(patch_discriminator_from_jax(params["d_a"]))
    with torch.no_grad():
        got = d(_t(x))
    assert tuple(got.shape) == (BATCH,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert [n for n, _ in d.named_children()] == [f"conv{i}" for i in range(5)]
    # N(0, 0.02) weights, zero biases
    w = torch.cat([m.weight.reshape(-1) for m in d.children()])
    assert abs(w.std().item() - 0.02) < 2e-3
    assert all(not m.bias.any() for m in PatchDiscriminator(1).children())


@functools.lru_cache(maxsize=None)
def _jax_resnet_params():
    x = jnp.zeros((1, SIZE, SIZE, 1))
    return _np(jax.jit(JaxResnet(1, NB, F).init)(jax.random.PRNGKey(4),
                                                 x)["params"])


def _family(name, jeng):
    """(JAX module, JAX params, port module, to state_dict, to JAX)."""
    _, params, _ = jeng
    if name == "bilinear":
        return (JaxBilinear(1, NB, F), params["g_a2b"],
                MultiscaleBilinearGenerator(1, 1, NB, F), generator_from_jax,
                generator_to_jax)
    if name == "p2p":
        return (JaxResnet(1, NB, F), _jax_resnet_params(),
                ResnetGenerator(1, 1, NB, F), resnet_generator_from_jax,
                resnet_generator_to_jax)
    return (JaxD(), params["d_b"], PatchDiscriminator(1),
            patch_discriminator_from_jax, patch_discriminator_to_jax)


@pytest.mark.parametrize("name", ["bilinear", "p2p", "D"])
def test_converters_round_trip(name, jeng):
    _, jparams, module, from_jax, to_jax = _family(name, jeng)
    sd = from_jax(jparams)
    module.load_state_dict(sd)
    back = to_jax(module.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa
    assert flat(back).keys() == flat(jparams).keys()
    for k, v in flat(jparams).items():
        assert flat(back)[k].dtype == np.float32
        np.testing.assert_array_equal(flat(back)[k], v)


# The loss is mean(out · R), R a fixed random projection. Each leaf within
# GRAD_REL of its max-abs gradient: 2.8e-6 measured on the weights, 1.5e-5
# on the head bias, whose small gradient sums terms that cancel; 1e-4 was
# the start, 5e-5 holds. A leaf whose true gradient is 0 (a conv bias
# ahead of an instance norm) holds rounding noise only, at most 2.5e-8
# measured: an absolute 1e-6.
GRAD_REL, GRAD_ZERO_ABS = 5e-5, 1e-6


@pytest.mark.parametrize("name", ["bilinear", "p2p", "D"])
def test_param_grads_match_jax(name, jeng):
    jmod, jparams, module, from_jax, _ = _family(name, jeng)
    module.load_state_dict(from_jax(jparams))
    x = _frames(8)
    out_shape = (BATCH,) if name == "D" else x.shape
    proj = np.random.RandomState(9).randn(*out_shape).astype(np.float32)

    def jloss(p):
        return jnp.mean(jmod.apply({"params": p}, jnp.asarray(x)) * proj)

    want = from_jax(_np(jax.jit(jax.grad(jloss))(jparams)))
    loss = torch.mean(module(_t(x)) * _t(proj))
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()))
    for n, g in zip(names, grads):
        w = want[n].numpy()
        tol = max(GRAD_REL * np.abs(w).max(), GRAD_ZERO_ABS)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=n)


# --------------------------------------------------------------------------- #
# utils/image_pool.py on JAX's own draws
# --------------------------------------------------------------------------- #
def _jax_draws(key, n, cap):
    """The coins and slots ``push_and_pop`` draws from ``key``."""
    swaps, idx = [], []
    for k in jax.random.split(key, n):
        k_coin, k_idx = jax.random.split(k)
        swaps.append(bool(jax.random.uniform(k_coin) > 0.5))
        idx.append(int(jax.random.randint(k_idx, (), 0, cap)))
    return torch.tensor(swaps), torch.tensor(idx)


@pytest.mark.parametrize("active", [True, False])
def test_pool_core_matches_jax_draws(active):
    cap, n, shape = 4, 3, (5, 5, 1)
    jst = jpool.init_pool(cap, shape)
    st = pool.init_pool(cap, shape, torch.device("cpu"))
    r = np.random.RandomState(10)
    key = jax.random.PRNGKey(11)
    n_swaps = 0
    for step in range(5):       # 3, 6 (full at 4), then swaps
        key, k = jax.random.split(key)
        batch = r.randn(n, *shape).astype(np.float32)
        jnew, jout = jpool.push_and_pop(jst, jnp.asarray(batch), k)
        swaps, idx = _jax_draws(k, n, cap)
        before = (st.images.clone(), st.size.clone())
        st, out = pool.push_and_pop_core(st, _t(batch), swaps, idx,
                                         torch.tensor(active))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        if active:
            jst = jnew
            n_swaps += int((swaps & (before[1] >= cap)).sum())
            np.testing.assert_array_equal(st.images.numpy(),
                                          np.asarray(jst.images))
            assert st.size.dtype == torch.int32
            assert int(st.size) == int(jst.size) == min(cap, n * (step + 1))
        else:   # the JAX step keeps the old pool: jnp.where(do_step, ...)
            assert torch.equal(st.images, before[0])
            assert torch.equal(st.size, before[1])
    assert not active or n_swaps > 0


def test_pool_draws_from_its_generator():
    st = pool.init_pool(4, (2, 2, 1), torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 2, 2, 1)
    st, out = pool.push_and_pop(st, x, g)
    assert int(st.size) == 4 and tuple(out.shape) == (6, 2, 2, 1)
    assert torch.equal(out[:4], x[:4])
    # once full, each element passes through or swaps with a stored image
    stored = list(x[:4]) + list(x[4:])
    for i in (4, 5):
        assert any(torch.equal(out[i], s) for s in stored)
    g2 = torch.Generator().manual_seed(0)
    st2, out2 = pool.push_and_pop(pool.init_pool(4, (2, 2, 1),
                                                 torch.device("cpu")), x, g2)
    assert torch.equal(out2, out) and torch.equal(st2.images, st.images)


# --------------------------------------------------------------------------- #
# core/optim.py against optax.adam
# --------------------------------------------------------------------------- #
def test_adam_matches_optax():
    r = np.random.RandomState(12)
    shapes = [(3, 3, 2, 4), (4,), (1, 1, 4, 1)]
    p0 = [r.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=2e-4, b1=0.5,
                                              b2=0.999)
    jp, jst = list(map(jnp.asarray, p0)), None
    jst = tx.init(jp)
    params = [_t(a.copy()) for a in p0]
    st = AdamState(params)
    for step, on in enumerate([True, False, True, True, False]):
        grads = [r.randn(*s).astype(np.float32) for s in shapes]
        lr = np.float32(2e-4 * (1 - 0.1 * step))
        # the JAX engine's masked update (engines/cyclegan.py:188-198)
        jst.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, new = tx.update(list(map(jnp.asarray, grads)), jst, jp)
        jp = optax.apply_updates(jp, [u * np.float32(on) for u in upd])
        jst = jax.tree.map(lambda n, o: jnp.where(on, n, o), new, jst)

        before = ([p.clone() for p in params], st.mu_flat.clone(),
                  st.nu_flat.clone(), st.count.clone())
        adam_step(params, [_t(g) for g in grads], st, torch.tensor(lr),
                  torch.tensor(on))
        if not on:
            assert all(torch.equal(a, b) for a, b in zip(params, before[0]))
            assert torch.equal(st.mu_flat, before[1])
            assert torch.equal(st.nu_flat, before[2])
            assert torch.equal(st.count, before[3])
        adam = jst.inner_state[0]
        assert int(st.count) == int(adam.count)
        for got, want in ((params, jp), (st.mu, adam.mu), (st.nu, adam.nu)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=0)


def test_lambda_lr_factor_matches_jax():
    from cistar_tpu.engines.cyclegan import lambda_lr_factor as jfactor

    for e in range(0, 13):
        for n, s, d in ((10, 0, 9), (10, 2, 5), (5, 0, 9)):
            want = float(jfactor(jnp.asarray(e, jnp.int32), n, s, d))
            got = lambda_lr_factor(torch.tensor(e, dtype=torch.int32), n, s, d)
            assert got.dtype == torch.float32
            assert got.item() == want


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
def test_two_train_steps_match_jax(jeng):
    # pool 4, batch 2: both steps stay in the pools' fill phase, where the
    # two frameworks' coin draws are not read
    eng, _, jst0 = jeng
    jst = jax.tree.map(jnp.array, jst0)
    teng, st = _port(jeng)
    for step in range(2):
        a, b = _frames(20 + step), _frames(30 + step)
        jst, jm = eng.train_step(jst, jnp.asarray(a), jnp.asarray(b))
        st, m = teng.train_step(st, _t(a), _t(b))
        assert set(m) == set(jm)
        for k, v in m.items():
            assert v.dtype == torch.float32 and v.ndim == 0
            np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {step}")
        assert float(m["skipped"]) == 0.0
    assert int(st.opt_g.count) == 2 and int(st.pool_a.size) == 2 * BATCH
    # G's loss gave D no gradient, and nothing is left in .grad
    assert all(p.grad is None for n in teng._nets() for p in n.parameters())


def _snapshot(st):
    t = {f"{f}.{k}": v.detach().clone() for f in ("g_a2b", "g_b2a", "d_a",
                                                  "d_b")
         for k, v in getattr(st, f).items()}
    for f in ("opt_g", "opt_d_a", "opt_d_b"):
        o = getattr(st, f)
        t.update({f"{f}.mu": o.mu_flat.clone(), f"{f}.nu": o.nu_flat.clone(),
                  f"{f}.count": o.count.clone()})
    for f in ("pool_a", "pool_b"):
        t.update({f"{f}.images": getattr(st, f).images.clone(),
                  f"{f}.size": getattr(st, f).size.clone()})
    return t


def _changed(before, after):
    return {k for k in before if not torch.equal(before[k], after[k])}


def test_sparse_frames_change_nothing(jeng):
    teng, st = _port(jeng)
    st, _ = teng.train_step(st, _t(_frames(40)), _t(_frames(41)))  # fill
    before = _snapshot(st)
    st, m = teng.train_step(st, _t(_frames(0, dense=False)), _t(_frames(42)))
    assert float(m["skipped"]) == 1.0
    assert not _changed(before, _snapshot(st))
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_d_gate_holds_d(jeng):
    teng, st = _port(jeng, d_loss_floor=1e9)
    before = _snapshot(st)
    st, m = teng.train_step(st, _t(_frames(50)), _t(_frames(51)))
    changed = _changed(before, _snapshot(st))
    assert float(m["skipped"]) == 0.0
    assert not {k for k in changed if k.startswith(("d_", "opt_d"))}
    assert {"opt_g.count", "opt_g.mu", "pool_a.images"} <= changed
    assert any(k.startswith("g_a2b.") for k in changed)


def test_bf16_step_keeps_fp32_state(jeng):
    teng, st = _port(jeng, compute_dtype=torch.bfloat16)
    a, b = _t(_frames(60)), _t(_frames(61))
    with torch.enable_grad():
        loss = teng._g_losses(a, b)["loss_G"]
        params = list(st.g_a2b.values())
        grads = torch.autograd.grad(loss, params)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    st, m = teng.train_step(st, a, b)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v))
               for v in m.values())
    for f in ("g_a2b", "g_b2a", "d_a", "d_b"):
        assert all(p.dtype == torch.float32 for p in getattr(st, f).values())
    for f in ("opt_g", "opt_d_a", "opt_d_b"):
        o = getattr(st, f)
        assert o.mu_flat.dtype == o.nu_flat.dtype == torch.float32
        assert o.count.dtype == torch.int32


# --------------------------------------------------------------------------- #
# checkpoints: the port's load in JAX and the other way round
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_g_forward(module):
    return jax.jit(lambda p, x: module.apply({"params": p}, x))


def _forwards_agree(jeng, jparams, teng):
    eng = jeng[0]
    x = _frames(70)
    want = np.asarray(_jax_g_forward(eng.G_a2b)(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = teng.G_a2b(_t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_port_checkpoint_loads_in_jax(jeng, tmp_path):
    _, _, jst0 = jeng
    teng, st = _port(jeng)
    st, _ = teng.train_step(st, _t(_frames(80)), _t(_frames(81)))
    ckpt.save_cyclegan_state(str(tmp_path), teng, epoch=3)
    names = ("netG_A2B", "netG_B2A", "netD_A", "netD_B")
    assert all(os.path.exists(tmp_path / f"{p}{n}.npz")
               for n in names for p in ("", "3_"))
    jst = jckpt.load_cyclegan_state(str(tmp_path), jst0)
    _forwards_agree(jeng, jst.g_a2b, teng)
    for f, tree in teng.jax_params().items():
        for (k, v), (k2, w) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                   jax.tree_util.tree_leaves_with_path(
                                       _np(getattr(jst, f)))):
            assert k == k2
            np.testing.assert_array_equal(v, w)


def test_jax_checkpoint_loads_in_port(jeng, tmp_path):
    _, params, jst0 = jeng
    # other weights than the port's init: the JAX init, moved
    r = np.random.RandomState(90)
    bump = lambda a: a + 0.01 * r.randn(*a.shape).astype(np.float32)  # noqa
    jst = jst0._replace(**{f: jax.tree.map(bump, params[f]) for f in NETS})
    jckpt.save_cyclegan_state(str(tmp_path), jst, epoch=0)
    teng, st = _port(jeng)
    st = ckpt.load_cyclegan_state(str(tmp_path), teng, st)
    _forwards_agree(jeng, jst.g_a2b, teng)
    assert st.g_a2b["init_conv.weight"] is teng.G_a2b.init_conv.weight


# --------------------------------------------------------------------------- #
# the CLI and the device rule
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for d in ("radar", "lidar"):
        os.makedirs(root / d)
        for i in range(10):
            arr = (rng.rand(32, 32) > 0.5).astype(np.uint8) * 255
            Image.fromarray(arr).save(root / d / f"{i:05d}.png")
    return str(root)


def test_train_cli_epoch_and_resume(dataroot, tmp_path, capsys):
    out = str(tmp_path / "run")
    args = ["--dataroot", dataroot, "--size", "32", "--n_epochs", "1",
            "--batchSize", "2", "--gen_type", "p2p", "--output_dir", out,
            "--log_every", "2", "--dtype", "fp32", "--min_points", "5",
            "--device", "cpu"]
    cyclegan_train.main(args)
    run = out + "_p2p"
    for net in ("netG_A2B", "netG_B2A", "netD_A", "netD_B"):
        assert os.path.exists(f"{run}/0_{net}.npz")
        assert os.path.exists(f"{run}/{net}.npz")
    saved = ckpt.load_pytree(f"{run}/netG_A2B.npz")
    assert os.path.exists(f"{run}/loss_log.csv")
    # --resume reloads the four nets and trains on from them
    cyclegan_train.main(args + ["--resume", "--epoch", "0"])
    assert "resumed from" in capsys.readouterr().out
    # 5 train pairs at batch 2: 3 steps an epoch, every one active
    log = open(f"{run}/loss_log.csv").read().splitlines()
    assert log[0].startswith("epoch,loss_D") and len(log) == 3
    assert float(log[1].split(",")[-1]) == 0.0       # skipped
    assert saved["init_conv"]["w"].shape == (7, 7, 1, 16)


def test_cli_refuses_what_is_not_ported(dataroot, tmp_path):
    # --content_loss and the 'unet' / 'atrous' generators are ported now:
    # the CLI builds them (no epoch to run), where it raised before
    for extra in (["--content_loss"], ["--gen_type", "unet"],
                  ["--gen_type", "atrous", "--dense_decoder", "False"]):
        st = cyclegan_train.main(["--dataroot", dataroot, "--size", "32",
                                  "--n_epochs", "0", "--device", "cpu",
                                  "--output_dir", str(tmp_path / "u"),
                                  *extra])
        assert int(st.opt_g.count) == 0


def test_trainer_needs_cuda_without_a_device(monkeypatch, dataroot,
                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CycleGAN(in_features=4, n_residual_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cyclegan_train.main(["--dataroot", dataroot, "--size", "32",
                             "--output_dir", str(tmp_path / "c")])


def test_same_weights_on_every_device(jeng):
    # init_state draws on the CPU: the seed alone fixes the weights
    a = CycleGAN(**dict(CFG, device="cpu")).init_state(3)
    b = CycleGAN(**dict(CFG, device="cpu", seed=9)).init_state(3)
    assert all(torch.equal(a.g_b2a[k], b.g_b2a[k]) for k in a.g_b2a)
    assert all(torch.equal(a.d_b[k], b.d_b[k]) for k in a.d_b)
    g = MultiscaleBilinearGenerator(1, 1, NB, F)
    assert set(a.g_a2b) == {n for n, _ in g.named_parameters()}
