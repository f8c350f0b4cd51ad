"""Slice 14 of the port: the pix2pixHD train step and its CLIs
(``cistar_tpu_torch/models/pix2pixhd.py``: training-mode ``BatchNorm``,
``NLayerDiscriminator`` / ``MultiscaleDiscriminator``, ``Encoder`` with
``instance_average_pool``; ``losses/perceptual.py::make_vgg_loss``; the
converters; ``engines/p2phd.py::Pix2PixHD``; ``data/datasets.py::
Radar2LidarDataset`` and the shuffling ``Loader``; ``core/checkpoint.py``'s
p2pHD layout; ``apps/p2phd_train.py`` / ``p2phd_test.py``) against the JAX
package on the CPU, on the same seeded numpy inputs and the JAX init's
weights, converted.

Three JAX train-step engines serve the file: ``UNet`` (the shipped
``r2l_MSRB_7`` recipe, narrow), ``multiscale`` (training-mode BatchNorm)
with netE (``instance_feat``) and the VGG19 loss, and ``global`` with netE
and the VGG19 loss. Each costs 10-20 s of XLA compiles on one core, its
``init_state`` and its first ``train_step``. (``norm="batch"`` trains in
neither package outside ``multiscale``: D takes G's norm, and a BatchNorm
D is refused.)
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cistar_tpu.core import checkpoint as jckpt
from cistar_tpu.data import datasets as jdata
from cistar_tpu.engines.p2phd import Pix2PixHD as JaxP2P
from cistar_tpu.engines.p2phd import sample_features as jsample
from cistar_tpu.losses.perceptual import make_vgg_loss as jvgg_loss
from cistar_tpu.models import pix2pixhd as jmodels
from cistar_tpu_torch.apps import p2phd_options, p2phd_test, p2phd_train
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.core.convert import (batch_stats_to_jax,
                                           generator_to_jax)
from cistar_tpu_torch.data import datasets as data
from cistar_tpu_torch.engines.p2phd import (Pix2PixHD, Pix2PixHDInference,
                                            sample_features)
from cistar_tpu_torch.losses.perceptual import make_vgg_loss
from cistar_tpu_torch.models import pix2pixhd as models


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One thread per xdist worker while this file runs; the previous count
    # comes back after, since other files' torch references depend on it.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE, BATCH = 32, 2
D_CFG = dict(ndf=8, num_d=2, n_layers_d=3, image_size=SIZE)
UNET = dict(net_g="UNet", ngf=8, n_blocks_global=1, **D_CFG)
# instance maps on: netE pools by instance id, and D sees the edge map
MS = dict(net_g="multiscale", ngf=4, n_blocks_global=1, no_instance=False,
          instance_feat=True, nef=4, n_downsample_e=2, **D_CFG)
GLOBAL = dict(MS, net_g="global", n_downsample_global=2)
N_IDS = 6
# The train step's gates, fp32 on both sides with the same weights: each
# metric within the CycleGAN step's 1e-4 relative (tests/test_torch_train.py;
# the order of sums, 3.5e-7 measured),
# G's fake of the step within 2e-5 (5.7e-6 measured, multiscale).
# The gradients: Adam's first moment of every leaf of G, D and netE after
# the step, (1 − b1)·grad after the first, within 2e-3 of its net's
# largest |moment| (measured after one step: UNet 1.4e-6, global 4.6e-6,
# multiscale 6.2e-4 in netE and 2.2e-4 in G, whose training-mode
# BatchNorm backward subtracts batch means; UNet's after 2 and 3 steps
# 1.3e-6). A leaf is not held to its own largest value: a bias ahead of an
# instance norm has a gradient within rounding of 0, which differs in
# relative terms by O(1).
# Params after k steps: Adam moves a weight by at most lr = 1e-4 a step
# whatever its gradient's size, so this holds the LR and the gates, not the
# gradients: a gradient within rounding of 0 can move a weight ±lr in
# either package, up to 2·lr a step (1.99e-4, 3.97e-4, 5.27e-4 measured
# after 1, 2, 3 steps). Such weights do not move UNet's output: the served
# output after the steps within 1e-5 (1.4e-6 measured).
METRIC_RTOL = 1e-4
FAKE_ABS = 2e-5
GRAD_RTOL = 2e-3
PARAM_ABS = 2e-4
SERVED_ABS = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(seed, n=BATCH):
    """label (radar) and image (lidar) in [-1, 1], instance ids in [0,
    N_IDS), NHWC float32."""
    r = np.random.RandomState(seed)
    label = (r.rand(n, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    image = (r.rand(n, SIZE, SIZE, 1) * 2 - 1).astype(np.float32)
    inst = r.randint(0, N_IDS, (n, SIZE, SIZE, 1)).astype(np.float32)
    return label, image, inst


def _jax_engine(cfg):
    kw = {k: v for k, v in cfg.items()}
    if kw.get("instance_feat"):
        kw["vgg_criterion"] = jvgg_loss(compute_dtype=jnp.float32)
    eng = JaxP2P(compute_dtype=jnp.float32, **kw)
    return eng, eng.init_state(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def junet():
    return _jax_engine(UNET)


@pytest.fixture(scope="module")
def jms():
    return _jax_engine(MS)


@pytest.fixture(scope="module")
def jglobal():
    return _jax_engine(GLOBAL)


def _port(jeng, cfg, **kw):
    """The port's engine on the CPU with the JAX engine's initial weights
    (G, its batch_stats, D, netE), and its state."""
    _, st = jeng
    cfg = dict(cfg, compute_dtype=torch.float32, device="cpu")
    if cfg.get("instance_feat"):
        cfg["vgg_criterion"] = make_vgg_loss(compute_dtype=torch.float32)
    cfg.update(kw)
    eng = Pix2PixHD(**cfg)
    state = eng.init_state(0)
    eng.load_jax_params(_np(st.g), None if st.g_stats is None
                        else _np(st.g_stats), _np(st.d),
                        None if st.e is None else _np(st.e))
    return eng, state


def _max_abs(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for (_, x), (_, y) in zip(la, lb))


# --------------------------------------------------------------------------- #
# training-mode BatchNorm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(2, 5, 6, 3), (1, 1, 1, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(shape, dtype):
    # the batch statistics (two-pass, biased), JAX's op order, the running
    # update (momentum 0.1, unbiased; n = 1 divides by 1): 1e-6, one bf16
    # ulp of the output in bf16
    c = shape[-1]
    r = np.random.RandomState(sum(shape))
    x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
    params = {"gamma": (0.02 * r.randn(c)).astype(np.float32),
              "beta": (0.1 * r.randn(c)).astype(np.float32)}
    stats = {"mean": (0.1 * r.randn(c)).astype(np.float32),
             "var": (1 + 0.1 * r.rand(c)).astype(np.float32)}
    jdt = getattr(jnp, dtype)
    ref, mut = jmodels.NormLayer("batch").apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x).astype(jdt),
        mutable=["batch_stats"])
    bn = models.BatchNorm(c)
    bn.load_state_dict({"weight": _t(params["gamma"] + np.float32(1)),
                        "bias": _t(params["beta"]),
                        "running_mean": _t(stats["mean"]),
                        "running_var": _t(stats["var"])})
    bn.train()
    got = bn(_t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=1e-6)
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)
    # eval: the running statistics, as use_running_average
    bn.eval()
    ref = jmodels.NormLayer("batch").apply(
        {"params": params, "batch_stats": _np(mut["batch_stats"])},
        jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        got = bn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_batchnorm_train_mode_is_autograd_through_the_statistics():
    # the batch statistics are part of the graph, the running update not
    bn = models.BatchNorm(3).train()
    x = torch.randn(2, 4, 4, 3, requires_grad=True)
    (bn(x) * torch.arange(3.0)).sum().backward()
    # d/dx of a normalized, affine output summed per channel is 0
    assert x.grad.abs().max() < 1e-5
    assert bn.running_mean.grad_fn is None and not bn.running_var.requires_grad


# --------------------------------------------------------------------------- #
# the discriminator, the encoder and instance pooling, the VGG loss
# --------------------------------------------------------------------------- #
def test_multiscale_discriminator_matches_jax(junet):
    # every layer of every scale, fp32: the order of sums (2.1e-6 measured)
    jeng, st = junet
    r = np.random.RandomState(3)
    x = (r.rand(BATCH, SIZE, SIZE, 2) * 2 - 1).astype(np.float32)
    ref = jax.jit(jeng.D.apply)({"params": st.d}, jnp.asarray(x))
    teng, _ = _port(junet, UNET)
    with torch.no_grad():
        got = teng.D(_t(x))
    assert len(got) == len(ref) == 2
    for scale_got, scale_ref in zip(got, ref):
        assert len(scale_got) == len(scale_ref) == 5
        for g, w in zip(scale_got, scale_ref):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
    # the stride-1 layers grow the map by one
    assert [t.shape[1] for t in got[0]] == [17, 9, 5, 6, 7]


def test_discriminator_options_and_refusal():
    d = models.define_d(2, 8, 2, use_sigmoid=True, num_d=3,
                        get_interm_feat=False)
    out = d(torch.randn(1, 32, 32, 2))
    assert [len(s) for s in out] == [1, 1, 1]
    assert all(bool(((s[0] >= 0) & (s[0] <= 1)).all()) for s in out)
    assert set(dict(d.named_children())) == {"scale_0", "scale_1",
                                             "scale_2"}
    with pytest.raises(NotImplementedError, match="instance norm"):
        models.define_d(2, 8, 3, norm="batch")
    with pytest.raises(NotImplementedError, match="instance norm"):
        Pix2PixHD("UNet", ngf=4, n_blocks_global=1, norm="batch",
                  device="cpu")


@pytest.mark.parametrize("k", [64, 4])
def test_encoder_and_pool_match_jax(jms, k):
    # K above and below the image's 6 ids; fp32 (4.2e-7 measured)
    jeng, st = jms
    _, image, inst = _batch(5)
    ref = jax.jit(jeng.E.apply, static_argnums=3)(
        {"params": st.e}, jnp.asarray(image),
        jnp.asarray(inst[..., 0].astype(np.int32)), k)
    teng, _ = _port(jms, MS)
    with torch.no_grad():
        got = teng.E(_t(image), _t(inst[..., 0]).int(), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("k", [8, 5, 2])
def test_instance_average_pool_matches_jax(k):
    # negative and sparse ids (5 of them, -1 among them), float ids cast by
    # truncation; K above, at and below the count: the uncaptured pixels
    # keep their value
    r = np.random.RandomState(k)
    feats = r.randn(2, 6, 7, 3).astype(np.float32)
    inst = r.choice([-1.0, 0.0, 3.7, 8.0, 1000.0], (2, 6, 7, 1)) \
        .astype(np.float32)
    ref = jmodels.instance_average_pool(jnp.asarray(feats), jnp.asarray(inst),
                                        k)
    got = models.instance_average_pool(_t(feats), _t(inst), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    if k == 2:   # ids -1 and 0 pooled, the other three kept
        keep = inst[..., 0] > 1
        np.testing.assert_array_equal(got.numpy()[keep], feats[keep])


def test_vgg_loss_matches_jax():
    # fp32, the value and its gradient w.r.t. the prediction. The value: the
    # order of sums (1e-5). The gradient: a feature within rounding of a
    # ReLU's kink, or of its target's value (L1's sign), can take the other
    # branch in the other package, which moves the gradient of the pixels
    # under it (2.9e-3 of the largest |gradient| measured): 1e-2 of it
    r = np.random.RandomState(7)
    pred = (r.rand(2, 32, 32, 1) * 2 - 1).astype(np.float32)
    target = (r.rand(2, 32, 32, 1) * 2 - 1).astype(np.float32)
    jfn = jvgg_loss(compute_dtype=jnp.float32)
    ref, ref_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(pred),
                                                  jnp.asarray(target))
    fn = make_vgg_loss(compute_dtype=torch.float32)
    x = _t(pred).requires_grad_()
    got = fn(x, _t(target))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=1e-2 * float(np.abs(ref_g).max()))


# --------------------------------------------------------------------------- #
# the schedule and the local-enhancer mask
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("niter,niter_decay", [(50, 50), (3, 4), (2, 0)])
def test_lr_at_matches_jax(niter, niter_decay):
    kw = dict(net_g="UNet", ngf=4, n_blocks_global=1, ndf=4, lr=2e-4,
              niter=niter, niter_decay=niter_decay)
    jeng = JaxP2P(**kw)
    teng = Pix2PixHD(device="cpu", **kw)
    for e in (0, 1, 2, 3, 4, 5, 6, 49, 50, 60, 99, 100, 120):
        want = float(jeng.lr_at(jnp.asarray(e, jnp.int32)))
        got = teng.lr_at(torch.tensor(e, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert got.item() == want, e


def test_fix_global_mask_matches_jax():
    kw = dict(net_g="local", ngf=4, n_downsample_global=1, n_blocks_global=1,
              n_blocks_local=1, ndf=4, niter_fix_global=2)
    jeng = JaxP2P(**kw)
    teng = Pix2PixHD(device="cpu", **kw)
    names = [n for n, _ in teng.G.named_parameters()]
    r = np.random.RandomState(11)
    grads = [_t(r.randn(*p.shape).astype(np.float32))
             for p in teng.G.parameters()]
    tops = set()
    for e in (0, 1, 2, 3):
        got = teng._fix_global_mask(names, grads,
                                    torch.tensor(e, dtype=torch.int32))
        sd = dict(zip(names, got))
        want = jeng._fix_global_mask(
            generator_to_jax(dict(zip(names, grads))),
            jnp.asarray(e, jnp.int32))
        assert _max_abs(generator_to_jax(sd), want) == 0.0
        frozen = {n.split(".")[0] for n, g in sd.items()
                  if not torch.equal(g, dict(zip(names, grads))[n])}
        tops |= frozen
        assert frozen == ({"global"} if e < 2 else set())
    assert tops == {"global"}
    # no mask off the local enhancer, or with niter_fix_global 0
    assert Pix2PixHD("UNet", ngf=4, n_blocks_global=1, device="cpu",
                     niter_fix_global=2)._fix_global_mask(
        names, grads, torch.tensor(0)) is grads


# --------------------------------------------------------------------------- #
# the data
# --------------------------------------------------------------------------- #
def _write_pairs(root, n, size, seed=0):
    rng = np.random.RandomState(seed)
    for d in ("radar", "lidar"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            arr = (rng.rand(size, size) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, d, f"{i:05d}.png"))


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """8 pairs of 32² frames (the CLIs' data) and 10 pairs of 40² frames,
    which the datasets resize."""
    root = tmp_path_factory.mktemp("p2phd_data")
    _write_pairs(str(root / "r32"), 8, SIZE)
    _write_pairs(str(root / "r40"), 10, 40, seed=1)
    return root


@pytest.mark.parametrize("mode", ["train", "test"])
def test_radar2lidar_items_match_jax(dataroot, mode):
    # the 70/30 split, the resize, the shared rotation drawn from
    # RandomState(0), the normalization: element for element, twice (the
    # second pass from the decode memo)
    root = str(dataroot / "r40")
    jds = jdata.Radar2LidarDataset(root, size=SIZE, mode=mode)
    ds = data.Radar2LidarDataset(root, size=SIZE, mode=mode)
    assert len(ds) == len(jds) == (7 if mode == "train" else 3)
    for _ in range(2):
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert set(a) == set(b) and a["path"] == b["path"]
            for k in ("label", "image", "inst", "feat"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert ds._cache_bytes == jds._cache_bytes > 0


def test_loader_shuffles_as_jax(dataroot):
    # the per-epoch reshuffle, the last short batch; the rotations drawn in
    # the same order
    root = str(dataroot / "r40")
    for kw in (dict(shuffle=True), dict()):
        jl = jdata.Loader(jdata.Radar2LidarDataset(root, size=SIZE), 3,
                          **kw)
        pl = data.Loader(data.Radar2LidarDataset(root, size=SIZE), 3, **kw)
        assert len(pl) == len(jl)
        for _ in range(2):
            got, want = list(pl), list(jl)
            assert [b["path"] for b in got] == [b["path"] for b in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["label"], w["label"])
        assert pl.epoch == 2


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
def _step_both(jeng, jst, teng, st, seed, use_inst):
    label, image, inst = _batch(seed)
    ji = jnp.asarray(inst) if use_inst else None
    ti = _t(inst) if use_inst else None
    jst, jm, jfake = jeng.train_step(jst, jnp.asarray(label), ji,
                                     jnp.asarray(image))
    st, m, fake = teng.train_step(st, _t(label), ti, _t(image))
    assert set(m) == set(jm)
    for k, v in m.items():
        assert v.dtype == torch.float32 and v.ndim == 0
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert fake.dtype == torch.float32
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=0,
                               atol=FAKE_ABS)   # the forward before the update
    return jst, st


def _moments_close(teng, st, jst):
    """Adam's first moments of G, D and netE, port vs JAX, each leaf's
    max-abs error over its net's largest |moment| (GRAD_RTOL)."""
    errs = {}
    for key, net, opt, jopt, to_jax in (
            ("G", teng.G, st.opt_g, jst.opt_g, teng._to_jax),
            ("D", teng.D, st.opt_d, jst.opt_d, generator_to_jax),
            ("E", teng.E, st.opt_e, jst.opt_e, generator_to_jax)):
        if opt is None:
            continue
        # the moments through the param converter, less its image of 0:
        # BatchNorm's γ − 1 shift cancels, the layouts stay
        names = [n for n, _ in net.named_parameters()]
        sd = net.state_dict()
        got = jax.tree.map(
            np.subtract, to_jax(dict(sd, **dict(zip(names, opt.mu)))),
            to_jax(dict(sd, **{n: torch.zeros_like(sd[n]) for n in names})))
        want = _np(jopt.inner_state[0].mu)
        scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
        errs[key] = _max_abs(got, want) / scale
        assert scale > 0 and errs[key] <= GRAD_RTOL, (key, errs[key])
    return errs


def _params_close(teng, jst, steps=1):
    trees = teng.jax_params()
    errs = {"G": _max_abs(trees["G"], _np(jst.g)),
            "D": _max_abs(trees["D"], _np(jst.d))}
    if jst.e is not None:
        errs["E"] = _max_abs(trees["E"], _np(jst.e))
    for k, err in errs.items():
        assert err <= PARAM_ABS * steps, (k, err)
    return errs


@pytest.mark.parametrize("steps", [1, 3])
def test_unet_train_steps_match_jax(junet, steps):
    # free-running, each package from its own state; the D gate opens on
    # every one of these steps (loss_D ≈ 1)
    jeng, jst0 = junet
    jst = jax.tree.map(jnp.array, jst0)
    teng, st = _port(junet, UNET)
    for i in range(steps):
        jst, st = _step_both(jeng, jst, teng, st, 20 + i, use_inst=False)
        _moments_close(teng, st, jst)
        _params_close(teng, jst, i + 1)
    assert int(st.opt_g.count) == int(st.opt_d.count) == steps
    # G's loss gave D no gradient, and nothing is left in .grad
    assert all(p.grad is None for n in (teng.G, teng.D)
               for p in n.parameters())
    assert not teng.G.training
    x = _batch(90)[0]
    ref = jeng.infer_step(jst.g, jnp.asarray(x))
    np.testing.assert_allclose(teng.infer_step(_t(x)).numpy(),
                               np.asarray(ref), rtol=0, atol=SERVED_ABS)


def test_multiscale_netE_vgg_step_matches_jax(jms):
    # training-mode BatchNorm (running statistics from this forward only),
    # netE trained through G's losses, the VGG19 loss, instance maps
    jeng, jst0 = jms
    jst = jax.tree.map(jnp.array, jst0)
    teng, st = _port(jms, MS)
    before = {k: v.clone() for k, v in st.g_stats.items()}
    e0 = {k: v.detach().clone() for k, v in st.e.items()}
    jst, st = _step_both(jeng, jst, teng, st, 30, use_inst=True)
    assert set(_moments_close(teng, st, jst)) == {"G", "D", "E"}
    _params_close(teng, jst)
    stats = teng.jax_params()["G_stats"]
    assert _max_abs(stats, _np(jst.g_stats)) <= 1e-6   # 6.3e-8 measured
    assert all(not torch.equal(before[k], v) for k, v in st.g_stats.items())
    assert any(not torch.equal(e0[k], v) for k, v in st.e.items())
    assert int(st.opt_e.count) == 1
    assert set(st.g_stats) == {n for n, _ in teng.G.named_buffers()}


def test_global_netE_vgg_step_matches_jax(jglobal):
    # global with netE trained through G's losses and the VGG19 loss, on
    # instance maps: the step's metrics and fake, the gradients of G, D and
    # netE, and the output served after the step
    jeng, jst0 = jglobal
    jst = jax.tree.map(jnp.array, jst0)
    teng, st = _port(jglobal, GLOBAL)
    jst, st = _step_both(jeng, jst, teng, st, 30, use_inst=True)
    assert set(_moments_close(teng, st, jst)) == {"G", "D", "E"}
    _params_close(teng, jst)
    assert int(st.opt_e.count) == 1 and st.g_stats is None
    label, image, inst = _batch(90)
    want = np.asarray(jeng.infer_encoded(jst.g, jst.e, jnp.asarray(label),
                                         jnp.asarray(inst),
                                         jnp.asarray(image)))

    def served_err():
        return float(np.abs(teng.infer_encoded(
            _t(label), _t(inst), _t(image)).numpy() - want).max())

    # Per-pixel random ids make the edge map 1 nearly everywhere, so the
    # stem's weights on it get gradients within rounding of 0 under the
    # instance norm that follows; Adam's first step moves each by ±lr on
    # the sign of its gradient, which the two packages draw differently (63
    # of 980 stem weights; 7.4e-4 of the served output measured). With
    # JAX's values wherever the two updates took opposite signs, the served
    # output within SERVED_ABS (2.9e-6 measured).
    trees, jtrees = teng.jax_params(), {"G": _np(jst.g), "E": _np(jst.e)}
    fixed = {k: jax.tree.map(
        lambda a, b: np.where(np.abs(a - b) > teng.lr / 2, b, a), trees[k],
        jtrees[k]) for k in ("G", "E")}
    stem = np.abs(trees["G"]["trunk"]["stem"]["conv"]["w"]
                  - jtrees["G"]["trunk"]["stem"]["conv"]["w"]) > teng.lr / 2
    # HWIO; the input channels: label, edges, netE's 3 features
    assert stem.sum(axis=(0, 1, 3))[[0, 2, 3, 4]].sum() == 0
    teng.load_jax_params(fixed["G"], None, None, fixed["E"])
    assert served_err() <= SERVED_ABS


def test_d_gate_both_ways(junet):
    def snapshot(st):
        return {**{f"d.{k}": v.detach().clone() for k, v in st.d.items()},
                **{f"g.{k}": v.detach().clone() for k, v in st.g.items()},
                "opt_d.mu": st.opt_d.mu_flat.clone(),
                "opt_d.count": st.opt_d.count.clone(),
                "opt_g.count": st.opt_g.count.clone()}

    label, image, _ = _batch(40)
    for floor, d_moves in ((1e9, False), (0.0, True)):
        teng, st = _port(junet, UNET, d_loss_floor=floor)
        before = snapshot(st)
        st, m, _ = teng.train_step(st, _t(label), None, _t(image))
        after = snapshot(st)
        changed = {k for k in before if not torch.equal(before[k], after[k])}
        assert bool(m["loss_D"] >= floor) == d_moves
        assert any(k.startswith("g.") for k in changed)
        assert "opt_g.count" in changed
        d_changed = {k for k in changed if k.startswith(("d.", "opt_d"))}
        assert bool(d_changed) == d_moves
        if d_moves:
            assert {"opt_d.mu", "opt_d.count"} <= d_changed


def test_pool_feeds_d_and_fills(junet):
    teng, st = _port(junet, UNET, pool_size=3)
    label, image, _ = _batch(45)
    st, m, _ = teng.train_step(st, _t(label), None, _t(image))
    assert int(st.pool.size) == BATCH and st.pool.images.shape == (
        3, SIZE, SIZE, 2)
    st, m, _ = teng.train_step(st, _t(label), None, _t(image))
    assert int(st.pool.size) == 3
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_chip_check_replays_the_cards_activation_patterns():
    # chip_smoke.py's phase 36 holds the card's step and backward against
    # the CPU's with the card's ReLU / LeakyReLU sides and max pool picks
    # replayed on the CPU (same_kinks): the replay keeps the ops'
    # gradients, holds an input moved across a kink to the recorded side,
    # counts it, and puts the port's ops back
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from cistar_tpu_torch.ops import nn as tnn

    ops = (tnn.relu, tnn.leaky_relu, tnn.max_pool2d)
    x = _t(np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32))

    def grad(x):
        x = x.clone().requires_grad_()
        y = tnn.max_pool2d(tnn.leaky_relu(tnn.relu(x) - 0.3), 3, 2, padding=1)
        return torch.autograd.grad((y ** 2).sum(), x)[0]

    want, masks, flips = grad(x), [], []
    with chip_smoke.same_kinks(masks):
        assert torch.equal(grad(x), want)
    assert [m.dtype for m in masks] == [torch.bool, torch.bool, torch.int64]
    with chip_smoke.same_kinks(masks, flips):
        assert torch.equal(grad(x), want)
    assert flips == [(0, 0.0)] * 3
    # one ReLU input in (0, 0.3) that a max pool picks, just across the
    # kink: the CPU alone drops its gradient at the ReLU; replayed, it
    # keeps it
    i = tuple(np.argwhere(((x > 0) & (x < 0.3) & (want != 0)).numpy())[0])
    moved = x.clone()
    moved[i] = -1e-6
    flips = []
    with chip_smoke.same_kinks(masks, flips):
        got = grad(moved)
    assert flips[0][0] == 1 and abs(flips[0][1] - 1e-6) < 1e-12
    assert float(grad(moved)[i]) == 0.0 and float(got[i]) != 0.0
    assert (tnn.relu, tnn.leaky_relu, tnn.max_pool2d) == ops


def test_infer_with_features_match_jax():
    # netE's pooled features into G, and given features (global, fp32): the
    # JAX engine's jitted inference on the port's weights, converted
    kw = dict(net_g="global", ngf=4, n_downsample_global=2,
              n_blocks_global=1, no_instance=False, instance_feat=True,
              nef=4, n_downsample_e=2, ndf=4)
    teng = Pix2PixHD(device="cpu", compute_dtype=torch.float32, **kw)
    teng.init_state(1)
    jeng = JaxP2P(compute_dtype=jnp.float32, **kw)
    trees = teng.jax_params()
    label, image, inst = _batch(50)
    ref = jeng.infer_encoded(trees["G"], trees["E"], jnp.asarray(label),
                             jnp.asarray(inst), jnp.asarray(image))
    got = teng.infer_encoded(_t(label), _t(inst), _t(image))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    feat = np.random.RandomState(51).randn(BATCH, SIZE, SIZE, 3) \
        .astype(np.float32)
    ref = jeng.infer_with_features(trees["G"], jnp.asarray(label),
                                   jnp.asarray(inst), jnp.asarray(feat))
    got = teng.infer_with_features(_t(label), _t(inst), _t(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_sample_features_matches_jax():
    r = np.random.RandomState(8)
    inst = r.choice([1, 2, 2001, 7], (2, 5, 6, 1)).astype(np.float32)
    clusters = {1: r.randn(4, 5).astype(np.float32),
                2: r.randn(3, 5).astype(np.float32)}
    want = jsample(inst, clusters, 3, np.random.RandomState(0))
    got = sample_features(inst, clusters, 3, np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)
    assert (got[inst[..., 0] == 7] == 0).all()


# --------------------------------------------------------------------------- #
# checkpoints: the port's load in JAX and the other way round
# --------------------------------------------------------------------------- #
def test_port_checkpoint_loads_in_jax(jms, tmp_path):
    jeng, jst0 = jms
    teng, st = _port(jms, MS)
    label, image, inst = _batch(60)
    st, _, _ = teng.train_step(st, _t(label), _t(inst), _t(image))
    p2phd_train.save_networks(str(tmp_path), teng, "latest")
    assert sorted(os.listdir(tmp_path)) == [
        "latest_net_D.npz", "latest_net_G.npz", "latest_net_G_stats.npz"]
    trees = teng.jax_params()
    for label_, field in (("G", "g"), ("D", "d"), ("G_stats", "g_stats")):
        got = jckpt.load_network(str(tmp_path), label_, "latest",
                                 getattr(jst0, field), strict=True)
        assert _max_abs(got, trees[label_]) == 0.0
    # JAX serves the loaded G with its statistics as the port does
    g = jckpt.load_network(str(tmp_path), "G", "latest", jst0.g)
    s = jckpt.load_network(str(tmp_path), "G_stats", "latest", jst0.g_stats)
    x = np.concatenate([label, np.zeros_like(label)], -1)  # label ‖ edges
    feat = np.zeros((BATCH, SIZE, SIZE, 3), np.float32)
    want = jeng._g_apply(g, jnp.concatenate(
        [jnp.asarray(x), jnp.asarray(feat)], -1), s)
    with torch.no_grad():
        got = teng.G(_t(np.concatenate([x, feat], -1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_jax_checkpoint_loads_in_port(junet, jms, tmp_path):
    # other weights than the port's init: the JAX init, moved; a partial
    # file (a key dropped) keeps the init there, as the tolerant load does
    r = np.random.RandomState(70)

    def bump(a):
        return a + np.float32(0.01) * r.randn(*a.shape).astype(np.float32)

    for jeng, jst, cfg in ((*junet, UNET), (*jms, MS)):
        g, d = jax.tree.map(bump, _np(jst.g)), jax.tree.map(bump, _np(jst.d))
        jckpt.save_network(str(tmp_path), "G", "3", g)
        jckpt.save_network(str(tmp_path), "D", "3", d)
        if jst.g_stats is not None:
            s = jax.tree.map(lambda a: np.abs(bump(a)), _np(jst.g_stats))
            jckpt.save_network(str(tmp_path), "G_stats", "3", s)
        teng, st = _port((jeng, jst), cfg)
        p2phd_train.load_networks(str(tmp_path), "3", teng)
        trees = teng.jax_params()
        assert _max_abs(trees["G"], g) <= 1e-7      # γ − 1 + 1 rounds
        assert _max_abs(trees["D"], d) == 0.0
        if jst.g_stats is not None:
            assert _max_abs(trees["G_stats"], s) == 0.0
        assert st.g[next(iter(st.g))] is next(teng.G.parameters())
    flat = ckpt._flatten("", d)
    dropped = sorted(flat)[0]
    del flat[dropped]
    ckpt.save_network(str(tmp_path), "D", "4", ckpt._unflatten(flat))
    like = teng.jax_params()["D"]
    got = ckpt.load_network(str(tmp_path), "D", "4", like)
    assert np.array_equal(ckpt._flatten("", got)[dropped],
                          ckpt._flatten("", like)[dropped])
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.load_network(str(tmp_path), "D", "4", like, strict=True)


def test_iter_txt_round_trip(tmp_path):
    assert ckpt.load_iter(str(tmp_path)) == (1, 0)
    ckpt.save_iter(str(tmp_path), 4, 37)
    assert ckpt.load_iter(str(tmp_path)) == jckpt.load_iter(str(tmp_path)) \
        == (4, 37)


def test_converters_round_trip():
    # port → JAX → port is the identity, BatchNorm and UNet names included
    for net_g in ("multiscale", "UNet", "global"):
        eng = Pix2PixHDInference(
            net_g, ngf=4, n_downsample_global=1, n_blocks_global=1,
            device="cpu", seed=3,
            norm="batch" if net_g == "global" else "instance")
        trees = eng.jax_params()
        if net_g == "UNet":
            assert {"down_0_conv", "msrb_0", "up_2_convt"} <= set(trees["G"])
            assert trees["G_stats"] is None
        else:
            assert "gamma" in (trees["G"]["res_0"]["norm1"] if net_g ==
                               "multiscale" else
                               trees["G"]["trunk"]["res_0"]["norm1"])
        sd = {k: v.clone() for k, v in eng.G.state_dict().items()}
        eng.G.load_state_dict(eng._convert(trees["G"], trees["G_stats"]))
        assert all(torch.equal(sd[k], v) for k, v in
                   eng.G.state_dict().items())
        if trees["G_stats"] is not None:
            assert _max_abs(batch_stats_to_jax(sd), trees["G_stats"]) == 0


# --------------------------------------------------------------------------- #
# options and the CLIs
# --------------------------------------------------------------------------- #
OPT_TXT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                       "r2l_MSRB_7", "opt.txt")


def test_load_opt_restores_the_recipe_not_the_machine(tmp_path):
    txt = tmp_path / "opt.txt"
    txt.write_text(open(OPT_TXT).read().replace(
        "platform: cpu", "platform: cpu\ndevice: cpu"))
    opt = p2phd_options.TrainOptions().parse(
        ["--load_opt", str(txt), "--checkpoints_dir", str(tmp_path),
         "--ngf", "8"], save=False)
    assert opt.device == "" and not hasattr(opt, "platform")
    assert (opt.netG, opt.ngf, opt.n_blocks_global, opt.num_D) == (
        "UNet", 8, 3, 2)
    assert (opt.no_vgg_loss, opt.r2l, opt.r2l_res, opt.lr) == (
        True, True, 512, 0.0001)
    # keys that only the JAX parser knew about still parse
    assert (opt.max_ch, opt.n_scale, opt.compile_timeout) == (256, 3, None)


def _cli_args(root, ck, extra=()):
    return ["--load_opt", OPT_TXT, "--dataroot", str(root / "r32"),
            "--r2l_res", str(SIZE), "--ngf", "8", "--ndf", "8",
            "--n_blocks_global", "1", "--checkpoints_dir", str(ck),
            "--device", "cpu", "--print_freq", "2", *extra]


def test_train_cli_epoch_and_resume(dataroot, tmp_path, capsys):
    ck = tmp_path / "ck"
    args = _cli_args(dataroot, ck, ["--niter", "1", "--niter_decay", "0",
                                    "--compute", "fp32"])
    p2phd_train.main(args)
    run = ck / "r2l_MSRB_7"
    for name in ("latest_net_G.npz", "latest_net_D.npz", "iter.txt",
                 "opt.txt", "loss_log.csv"):
        assert os.path.exists(run / name), name
    assert ckpt.load_iter(str(run)) == (2, 0)
    saved = ckpt.load_pytree(str(run / "latest_net_G.npz"))
    assert saved["init_block"]["conv"]["w"].shape == (7, 7, 1, 8)
    # 8 pairs, 5 in the train split at batch 1: 5 steps of one epoch
    log = open(run / "loss_log.csv").read().splitlines()
    assert log[0] == "epoch,D_fake,D_real,G_GAN,G_GAN_Feat,G_VGG,loss_D," \
        "loss_G" and len(log) == 2
    # --continue_train at epoch 2 of 2: loads the latest nets, trains on
    args[args.index("--niter") + 1] = "2"
    st = p2phd_train.main(args + ["--continue_train"])
    out = capsys.readouterr().out
    assert "Resuming from epoch 2 at iteration 0" in out
    assert "loaded networks from" in out
    assert int(st.opt_g.count) == 5 and int(st.epoch) == 1
    assert ckpt.load_iter(str(run)) == (3, 0)


@pytest.mark.parametrize("data_type", [32, 8])
def test_test_cli_writes_the_gallery(dataroot, tmp_path, data_type):
    ck, res = tmp_path / "ck", tmp_path / "res"
    p2phd_train.main(_cli_args(dataroot, ck, ["--niter", "1",
                                              "--niter_decay", "0"]))
    web = p2phd_test.main(_cli_args(dataroot, ck, [
        "--results_dir", str(res), "--phase", "test", "--data_type",
        str(data_type)]))
    assert web == os.path.join(str(res), "r2l_MSRB_7", "test_latest")
    pngs = sorted(os.listdir(os.path.join(web, "images")))
    # 3 test pairs, 3 tiles each
    assert len(pngs) == 9 and "00005_synthesized_image.png" in pngs
    html = open(os.path.join(web, "index.html")).read()
    assert html.count("<img") == 9 and "Epoch = latest" in html


@pytest.mark.parametrize("app,flag,item", [
    (p2phd_train, ["--spatial_shard"], "item 11.5"),
    (p2phd_test, ["--spatial_shard"], "item 11.5"),
    (p2phd_train, ["--uda"], "item 11.5")])
def test_clis_refuse_what_is_not_ported(dataroot, tmp_path, monkeypatch, app,
                                        flag, item):
    # --uda at a world size above 1 (read from torchrun's environment
    # before any process group starts)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match=item):
        app.main(_cli_args(dataroot, tmp_path, flag))


@pytest.fixture(scope="module")
def trained(dataroot, tmp_path_factory):
    """The checkpoints of one CLI epoch."""
    ck = tmp_path_factory.mktemp("p2phd_ck")
    p2phd_train.main(_cli_args(dataroot, ck, ["--niter", "1",
                                              "--niter_decay", "0"]))
    return ck


@pytest.mark.parametrize("flag", ["--export_onnx", "--engine", "--onnx"])
def test_test_cli_exports_and_serves(dataroot, trained, tmp_path, capsys,
                                     flag):
    # the flags that raised until the exported programs were ported: the
    # UNet int8 engine exported to a .pt2, then loaded, profiled and served
    # (--engine, or its alias --onnx); the served gallery equals the eager
    # int8 run's, bit for bit
    ck = trained
    pt2 = str(tmp_path / "g.pt2")
    test = ["--phase", "test", "--data_type", "8"]
    assert p2phd_test.main(_cli_args(dataroot, ck, test + [
        "--export_onnx", pt2])) == pt2
    assert os.path.getsize(pt2) > 0
    if flag == "--export_onnx":
        return
    capsys.readouterr()
    webs = [p2phd_test.main(_cli_args(dataroot, ck, test + [
        "--results_dir", str(tmp_path / res), *extra]))
        for res, extra in (("eager", ()), ("engine", (flag, pt2)))]
    out = capsys.readouterr().out
    assert f"engine {pt2}: " in out and "ms/iter" in out
    assert "per-op device time — plane /host:CPU (10 traced runs)" in out
    assert "cistar::msrb_branch_int8" in out
    pngs = [sorted(os.listdir(os.path.join(w, "images"))) for w in webs]
    assert pngs[0] == pngs[1] and len(pngs[0]) == 9
    for name in pngs[0]:
        a, b = (np.asarray(Image.open(os.path.join(w, "images", name)))
                for w in webs)
        np.testing.assert_array_equal(a, b)


def test_trainer_needs_cuda_without_a_device(monkeypatch, dataroot,
                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pix2PixHD("UNet", ngf=4, n_blocks_global=1, ndf=4)
    args = [a for a in _cli_args(dataroot, tmp_path) if a not in ("--device",
                                                                  "cpu")]
    for app in (p2phd_train, p2phd_test):
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(args)
