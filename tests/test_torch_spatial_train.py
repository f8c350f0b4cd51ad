"""The pix2pixHD train step and CLIs with G spatially sharded
(``Pix2PixHD``'s ``spatial_mesh``, ``--spatial_shard``) against one
process, as ``tests/test_spatial.py::
test_spatial_sharded_train_step_matches_single_device`` holds the JAX
engine's.

Two gloo processes (``tests/_spatial_workers.py``, under ``spawn``) read
the same whole batches, each runs its H-slab of G, and the step reduces
over them: G's gradients summed, D's averaged. The one-process references
run here meanwhile. Each case compares:

  * two steps of ``global`` (with a replay pool) and of ``UNet`` at 4
    features, 64², batch 2: the metrics within 1e-5 relative (1.1e-7
    read) and Adam's first moments of G and D within 2e-5 of their net's
    largest (7.0e-7 read), PR 17's budgets for the data-parallel step;
    after the steps every rank's parameters equal bit for bit;
  * the inference path (``p2phd_test --spatial_shard``'s route) within
    JAX's 5e-4 gate (5.2e-7 read);
  * ``p2phd_train --spatial_shard`` (one epoch of ``r2l_MSRB_7``'s
    ``UNet`` at 8 features, 32², fp32) and ``p2phd_test --spatial_shard``
    on its checkpoint, against the same CLIs in one process: the saved G
    within Adam's divergence bound (:func:`adam_divergence_bound`, 1.15e-3
    for five steps; 6.0e-4 read), the galleries' file lists equal and
    their images within one grey level.

One step from the JAX engine's initial weights, converted, is also held
against the JAX engine's own spatially sharded step (``shard_map`` over 2
of the virtual CPU devices) on the same batch, within the budgets of the
port's one-process step against JAX's (``tests/test_torch_p2phd_train.py``):
the metrics within 1e-4 relative, the fake within 2e-5, and Adam's first
moments of G and D within 2e-3 of their net's largest (2.9e-7, 5.4e-7
and 5.1e-7 read; with G's gradients averaged instead of summed over the
ranks the moments are 0.5 off).

The engine refuses what JAX's refuses (norms other than instance, other
generators) and a data mesh beside a spatial one.
"""

import multiprocessing
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from PIL import Image

import _spatial_workers as W
from cistar_tpu.engines.p2phd import Pix2PixHD as JaxP2P
from cistar_tpu_torch.apps import p2phd_test, p2phd_train
from cistar_tpu_torch.core import checkpoint as ckpt
from cistar_tpu_torch.core.convert import generator_to_jax
from cistar_tpu_torch.engines.p2phd import Pix2PixHD, Pix2PixHDInference
from cistar_tpu_torch.parallel.sharding import Mesh

METRIC_RTOL = 1e-5
MOMENT_RTOL = 2e-5
INFER_ATOL = 5e-4
# the port's step against JAX's (tests/test_torch_p2phd_train.py's budgets)
JAX_METRIC_RTOL, JAX_FAKE_ABS, JAX_GRAD_RTOL = 1e-4, 2e-5, 2e-3
CLI_SIZE, CLI_PAIRS, CLI_LR = 32, 8, 1e-4
JOIN_S = 240
OPT_TXT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                       "r2l_MSRB_7", "opt.txt")


def adam_divergence_bound(lr, steps, b1=0.5, b2=0.999):
    """The most two runs of Adam can move a parameter apart in ``steps``
    steps: 2 · lr · Σ_t r_t, where r_t = sqrt(Σ_i a_i² / c_i) bounds the
    bias-corrected |m̂ / √v̂| of step t by Cauchy-Schwarz (a_i, c_i the
    first and second moments' weights of gradient i); r_1 = 1, r_2 =
    1.054 at b1 = 0.5, b2 = 0.999. A gradient within rounding of 0 (a
    bias ahead of a norm) takes either sign in either run."""
    total = 0.0
    for t in range(1, steps + 1):
        i = np.arange(1, t + 1)
        a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
        c = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
        total += float(np.sqrt((a * a / c).sum()))
    return 2 * lr * total + 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_pairs(root, n, size, seed=0):
    rng = np.random.RandomState(seed)
    for d in ("radar", "lidar"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            arr = np.where(rng.rand(size, size) > 0.85, 255,
                           0).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, d, f"{i:05d}.png"))


def _cli_args(tmp, tag):
    common = ["--load_opt", OPT_TXT, "--dataroot", os.path.join(tmp, "data"),
              "--r2l_res", str(CLI_SIZE), "--ngf", "8", "--ndf", "8",
              "--n_blocks_global", "1", "--checkpoints_dir",
              os.path.join(tmp, f"ck_{tag}"), "--device", "cpu"]
    return (common + ["--niter", "1", "--niter_decay", "0", "--compute",
                      "fp32", "--print_freq", "2"],
            common + ["--phase", "test", "--how_many", "2", "--results_dir",
                      os.path.join(tmp, f"res_{tag}")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the one-process references, the run
    directory)."""
    tmp = str(tmp_path_factory.mktemp("spatial_train"))
    _write_pairs(os.path.join(tmp, "data"), CLI_PAIRS, CLI_SIZE)
    # the JAX engine, G sharded over 2 devices, and its initial weights,
    # which the ranks load
    jeng = JaxP2P(compute_dtype=jnp.float32, image_size=W.TRAIN_SIZE,
                  spatial_mesh=JaxMesh(np.asarray(jax.devices()[:2]),
                                       ("spatial",)), **W.P2P["global"])
    jst = jeng.init_state(jax.random.PRNGKey(0))
    with open(os.path.join(tmp, "jax_init.pkl"), "wb") as f:
        pickle.dump({"g": jax.tree.map(np.asarray, jst.g),
                     "d": jax.tree.map(np.asarray, jst.d)}, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.train_worker,
                         args=(r, tmp, _cli_args(tmp, "sharded")))
             for r in range(W.TRAIN_WORLD)]
    for p in procs:
        p.start()
    try:
        label, image = (jnp.asarray(a.numpy())
                        for a in W.train_batches(40)[0])
        jst, jm, jfake = jeng.train_step(jst, label, None, image)
        ref = {"jax": ({k: float(v) for k, v in jm.items()},
                       np.asarray(jfake),
                       [jax.tree.map(np.asarray, o.inner_state[0].mu)
                        for o in (jst.opt_g, jst.opt_d)])}
        ref.update({net: W.p2phd_run(net) for net in W.P2P})
        train_args, test_args = _cli_args(tmp, "one")
        p2phd_train.main(train_args)
        ref["test_dir"] = p2phd_test.main(test_args)
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
    assert not hung, "a spatial train worker hung"
    assert [p.exitcode for p in procs] == [0] * W.TRAIN_WORLD
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(W.TRAIN_WORLD)]
    return ranks, ref, tmp


@pytest.mark.parametrize("net", list(W.P2P))
def test_sharded_step_matches_one_process(runs, net):
    ranks, ref, _ = runs
    for res in ranks:
        for (gm, gmu), (wm, wmu) in zip(res[net][0], ref[net][0],
                                        strict=True):
            assert gm.keys() == wm.keys()
            for k in wm:
                assert gm[k] == pytest.approx(wm[k], rel=METRIC_RTOL,
                                              abs=1e-7), k
            for g, w in zip(gmu, wmu, strict=True):
                assert float((g - w).abs().max()) <= MOMENT_RTOL * max(
                    float(w.abs().max()), 1e-3)


def _moment_trees(mus):
    """The port's first moments of G and D (per parameter) as JAX trees:
    through the param converters, less their image of 0."""
    eng = Pix2PixHD(image_size=W.TRAIN_SIZE, compute_dtype=torch.float32,
                    device="cpu", **W.P2P["global"])
    out = []
    for net, to_jax, mu in ((eng.G, eng._to_jax, mus[0]),
                            (eng.D, generator_to_jax, mus[1])):
        names = [n for n, _ in net.named_parameters()]
        sd = net.state_dict()
        out.append(jax.tree.map(
            np.subtract, to_jax(dict(sd, **dict(zip(names, mu)))),
            to_jax(dict(sd, **{n: torch.zeros_like(sd[n]) for n in names}))))
    return out


def test_sharded_step_matches_jax_sharded_step(runs):
    ranks, ref, _ = runs
    jm, jfake, jmus = ref["jax"]
    for res in ranks:
        m, fake, *mus = res["jax"]
        assert m.keys() == jm.keys()
        for k in jm:
            assert m[k] == pytest.approx(jm[k], rel=JAX_METRIC_RTOL), k
        np.testing.assert_allclose(fake.numpy(), jfake, rtol=0,
                                   atol=JAX_FAKE_ABS)
        for got, want in zip(_moment_trees(mus), jmus, strict=True):
            lg = jax.tree_util.tree_leaves_with_path(got)
            lw = jax.tree_util.tree_leaves_with_path(want)
            assert [p for p, _ in lg] == [p for p, _ in lw]
            scale = max(float(np.abs(w).max()) for _, w in lw)
            err = max(float(np.abs(np.asarray(g) - w).max())
                      for (_, g), (_, w) in zip(lg, lw))
            assert scale > 0 and err <= JAX_GRAD_RTOL * scale


@pytest.mark.parametrize("net", list(W.P2P))
def test_rank_replicas_stay_equal(runs, net):
    ranks, ref, _ = runs
    for a, b, w in zip(ranks[0][net][1], ranks[1][net][1], ref[net][1],
                       strict=True):
        assert torch.equal(a, b)
        assert a.shape == w.shape
    # D stepped: its first moments moved
    assert float(ref[net][0][-1][1][1].abs().max()) > 0


@pytest.mark.parametrize("net", list(W.P2P))
def test_sharded_inference_matches_one_process(runs, net):
    ranks, ref, _ = runs
    for res in ranks:
        assert res[net][2].shape == (W.TRAIN_BATCH, W.TRAIN_SIZE,
                                     W.TRAIN_SIZE, 1)
        torch.testing.assert_close(res[net][2], ref[net][2], rtol=0,
                                   atol=INFER_ATOL)


def test_train_cli_spatial_shard_matches_one_process(runs):
    _, _, tmp = runs
    trees = {}
    for tag in ("sharded", "one"):
        run = os.path.join(tmp, f"ck_{tag}", "r2l_MSRB_7")
        assert ckpt.load_iter(run) == (2, 0)
        for name in ("latest_net_G.npz", "latest_net_D.npz", "loss_log.csv"):
            assert os.path.exists(os.path.join(run, name)), (tag, name)
        trees[tag] = ckpt.load_pytree(os.path.join(run, "latest_net_G.npz"))
    # 8 pairs, 5 in the train split at batch 1: 5 steps
    bound = adam_divergence_bound(CLI_LR, 5)
    flat = [torch.utils._pytree.tree_leaves(trees[t])
            for t in ("sharded", "one")]
    assert len(flat[0]) == len(flat[1]) > 0
    for a, b in zip(*flat):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= bound


def test_test_cli_spatial_shard_matches_one_process(runs):
    ranks, ref, _ = runs
    dirs = [r["test_dir"] for r in ranks] + [ref["test_dir"]]
    assert dirs[0] == dirs[1]
    files = [sorted(os.listdir(os.path.join(d, "images"))) for d in dirs[1:]]
    assert files[0] == files[1] and len(files[0]) == 6
    assert os.path.exists(os.path.join(dirs[0], "index.html"))
    for f in files[0]:
        a, b = (np.asarray(Image.open(os.path.join(d, "images", f)),
                           np.int16) for d in dirs[1:])
        assert np.abs(a - b).max() <= 1, f


@pytest.mark.parametrize("kw,err", [
    (dict(net_g="multiscale"), NotImplementedError),
    (dict(net_g="global", norm="batch"), NotImplementedError),
    (dict(net_g="encoder"), NotImplementedError)])
def test_engine_refuses_what_jax_refuses(kw, err):
    with pytest.raises(err, match="spatial sharding supports"):
        Pix2PixHDInference(ngf=4, device="cpu", spatial_mesh=Mesh(), **kw)


def test_data_and_spatial_meshes_exclude_each_other():
    with pytest.raises(ValueError, match="exclude each other"):
        Pix2PixHD(ngf=4, device="cpu", mesh=Mesh(), spatial_mesh=Mesh())
