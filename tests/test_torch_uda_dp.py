"""Data parallelism of the UDA trainers (``R2LAE``, ``R2LImageCritic``
with a ``mesh``; ``p2phd_train --uda`` under ``torchrun``) against one
process, as ``tests/test_torch_parallel.py`` holds the pix2pixHD and
CycleGAN steps.

Two gloo processes (``tests/_uda_workers.py``, under ``spawn``), each
with its half of a global batch of 4, run every case once for the module;
the one-process references at the full batch run here meanwhile. Each
case compares, within PR 17's budgets:

  * ``R2LAE`` (fp32; the domain classifier and, with ``wgan``, the
    Wasserstein feature critic), two steps: the metrics within 1e-5
    relative, the first moments of all six nets within 2e-5 of their
    net's largest, the BatchNorm running statistics (the encoder's over
    radar ‖ lidar, DF's, each decoder's) within 1e-7 after the first step
    and 1e-4 after the second (Adam's first step moves a bias ahead of a
    training-mode BatchNorm by ±lr on a gradient within rounding of 0);
    read: metrics 1.7e-7, moments 6.0e-6, statistics 6.0e-8 and 2.0e-5;
  * the image critic, two steps with the interpolation weights drawn for
    the global batch from the state's generator on every rank and sliced,
    and the penalty's per-image gradient 1/N of the global N: the same
    metrics and first-moment budgets (3.2e-6 and 2.2e-6 read);
  * ``p2phd_train --uda`` of both modules at world size 2 (4 train pairs
    of 32², batch 2, one epoch): the files of the JAX layout, the same as
    one process writes; each step's metrics as rank 0 logs them (the
    global means, from ``live_log.jsonl``) within 1e-5 relative of one
    process's (1.5e-6 read; 1.2 and 3.9e-2 when rank 1 steps on rank 0's
    half); each rank stepped on its own half of the step's batch, the
    two halves in rank order the one process's batch; the saved nets
    within Adam's divergence bound of one process's
    (:func:`adam_divergence_bound`, 4.1e-4 for two steps; 4.08e-4 read:
    biases ahead of a BatchNorm, whose gradients are rounding noise,
    stepped ±lr apart); the ranks' nets equal bit for bit.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch
from PIL import Image

import _uda_workers as W
from cistar_tpu_torch.apps import p2phd_train
from cistar_tpu_torch.parallel import sharding

METRIC_RTOL = 1e-5
MOMENT_RTOL = 2e-5
STATS_ATOL = (1e-7, 1e-4)   # after the first, the second step
CLI_SIZE, CLI_PAIRS, CLI_LR, CLI_STEPS = 32, 14, 1e-4, 2
JOIN_S = 240
OPT_TXT = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                       "r2l_MSRB_7", "opt.txt")
MODULES = {"discriminator": ("img_D",),
           "autoencoder": ("E", "DF", "DR", "DL", "GL", "GR")}


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
            arr = (rng.rand(size, size) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, d, f"{i:05d}.png"))


def _cli_args(tmp, tag):
    """module → the UDA CLI's arguments; 14 pairs, 4 in the 30% split."""
    base = ["--load_opt", OPT_TXT, "--uda", "--dataroot",
            os.path.join(tmp, "data"), "--r2l_res", str(CLI_SIZE), "--ngf",
            "4", "--ndf", "4", "--n_downsample_global", "1", "--max_ch", "8",
            "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--batchSize", "2", "--serial_batches", "--device", "cpu"]
    return {m: base + ["--checkpoints_dir", os.path.join(tmp, f"{tag}_{m}"),
                       "--training_module", m] for m in MODULES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the one-process references, the run
    directory)."""
    tmp = str(tmp_path_factory.mktemp("uda_dp"))
    _write_pairs(os.path.join(tmp, "data"), CLI_PAIRS, CLI_SIZE)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.worker,
                         args=(r, tmp, _cli_args(tmp, "sharded")))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {"r2lae": {w: W.r2lae_run(w) for w in (False, True)},
               "critic": W.critic_run(), "shards": {}}
        for m, args in _cli_args(tmp, "one").items():
            ref["shards"][m] = []
            orig = W.record_shards(ref["shards"][m])
            try:
                p2phd_train.main(args)
            finally:
                sharding.shard_batch = orig
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
    assert not hung, "a UDA worker hung"
    assert [p.exitcode for p in procs] == [0] * W.WORLD
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(W.WORLD)]
    return ranks, ref, tmp


def _metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL,
                                       abs=1e-7), k


def _moments_close(got, want):
    for g, w in zip(got, want, strict=True):
        assert float((g - w).abs().max()) <= MOMENT_RTOL * max(
            float(w.abs().max()), 1e-3)


@pytest.mark.parametrize("wgan", [False, True])
def test_r2lae_step_matches_one_process(runs, wgan):
    ranks, ref, _ = runs
    want = ref["r2lae"][wgan]
    for res in ranks:
        for (gm, gmu, gst), (wm, wmu, wst), atol in zip(
                res["r2lae"][wgan], want, STATS_ATOL, strict=True):
            _metrics_close(gm, wm)
            _moments_close(gmu, wmu)
            assert len(gst) == len(wst) > 0
            for g, w in zip(gst, wst):
                torch.testing.assert_close(g, w, rtol=0, atol=atol)
    # every net stepped, and the statistics moved off their init
    assert all(float(m.abs().max()) > 0 for m in want[-1][1])
    assert any(float((s - s.mean()).abs().max()) > 0 for s in want[-1][2])


def test_critic_step_matches_one_process(runs):
    ranks, ref, _ = runs
    for res in ranks:
        for (gm, gmu), (wm, wmu) in zip(res["critic"], ref["critic"],
                                        strict=True):
            _metrics_close(gm, wm)
            _moments_close(gmu, wmu)
    assert ref["critic"][0][0]["gp"] > 0


def _step_metrics(run_dir):
    """Each step's metrics from the running means that rank 0 logs after
    every step (``--print_freq 1``, one epoch)."""
    with open(os.path.join(run_dir, "live_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["batch"] for r in recs] == list(range(1, len(recs) + 1))
    means = [{k: v for k, v in r.items()
              if k not in ("epoch", "batch", "img_per_s")} for r in recs]
    return [{k: (i + 1) * m[k] - (i * means[i - 1][k] if i else 0.0)
             for k in m} for i, m in enumerate(means)]


@pytest.mark.parametrize("module", list(MODULES))
def test_uda_cli_world_2_matches_one_process(runs, module):
    ranks, ref, tmp = runs
    from cistar_tpu_torch.core import checkpoint as ckpt

    dirs = {t: os.path.join(tmp, f"{t}_{module}", "r2l_MSRB_7")
            for t in ("sharded", "one")}
    files = {t: sorted(f for f in os.listdir(d) if f.endswith(".npz"))
             for t, d in dirs.items()}
    assert files["sharded"] == files["one"] == sorted(
        f"latest_net_{lab}.npz" for lab in MODULES[module])
    assert not os.path.exists(os.path.join(dirs["sharded"], "iter.txt"))
    got, want = (_step_metrics(d) for d in dirs.values())
    assert len(got) == len(want) == CLI_STEPS
    for g, w in zip(got, want):
        _metrics_close(g, w)
    # each rank stepped on its own half of every batch
    one = ref["shards"][module]
    assert len(one) == CLI_STEPS
    for step, whole in enumerate(one):
        for k, v in whole.items():
            halves = [r["shards"][module][step][k] for r in ranks]
            assert [h.shape[0] for h in halves] == [v.shape[0] // 2] * 2
            assert torch.equal(torch.cat(halves), v)
    bound = adam_divergence_bound(CLI_LR, CLI_STEPS)
    for f in files["one"]:
        a, b = (ckpt.load_pytree(os.path.join(d, f)) for d in dirs.values())
        la, lb = (torch.utils._pytree.tree_flatten(t) for t in (a, b))
        assert la[1] == lb[1], f          # the same keys and nesting
        for x, y in zip(la[0], lb[0]):
            assert x.shape == y.shape
            assert np.abs(np.asarray(x) - np.asarray(y)).max() <= bound, f
    for a, b in zip(ranks[0]["cli"][module], ranks[1]["cli"][module],
                    strict=True):
        assert torch.equal(a, b)
