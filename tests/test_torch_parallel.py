"""Data parallelism of the port (``parallel/sharding.py``) against one
process: two gloo processes, each with its half of the global batch, give
what one process gives at the full batch, as ``tests/test_dp_exactness.py``
holds the JAX package's sharded step to its one-device step.

The two processes (``tests/_dp_workers.py``, under ``spawn``) run every
case once for the module; the references run here meanwhile. Each case
compares:

  * the CycleGAN step, the skip gate met and not met, two steps with the
    replay pools full (capacity 2, a global batch of 4): the metrics, and
    the gradients through Adam's first moments of G, D_A and D_B (Adam's
    first step is ±lr·sign(g), so parameters would hide a gradient
    error); the pools;
  * the pix2pixHD step, ``global`` (with a pool) and ``multiscale``, whose
    training-mode BatchNorm reduces its statistics over the ranks: the
    metrics, the first moments of G and D, the running statistics;
  * ``make_sharded_infer``, both engines, with the wrapper's own per-rank
    program and with an export of it reloaded;
  * ``pad_batch_to_multiple`` against the JAX package's.

Tolerances, within ``test_dp_exactness.py``'s ceilings (metrics 1e-4
absolute; parameters 2e-6 after one step of lr 2e-4, i.e. 1e-2 in a
gradient): the metrics within 1e-5 relative (1.6e-6 measured); the first
moments within 2e-5 of their net's largest |moment| (2.6e-6 after the
first step, 8.8e-6 after the second: 1.5e-3 absolute, where the ceiling
allows 5e-3 in a first moment, (1 − b1) · 1e-2); the pools within 1e-6 (5.8e-7); BatchNorm's running
statistics within 1e-7 after the first step (8.6e-9) and 1e-4 after the
second (3.4e-5: Adam's first step moves a bias ahead of a training-mode
BatchNorm by ±lr on a gradient within rounding of 0, which that norm
subtracts, and its running mean moves by momentum 0.1 of that). The sums
run in another order over two processes; only the inference outputs,
image by image, are exact: the sharded programs bit for bit with the
one-process engine, the loaded program with the wrapper's own.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import _dp_workers as W
from cistar_tpu.parallel.sharding import \
    pad_batch_to_multiple as jax_pad_batch_to_multiple
from cistar_tpu_torch.parallel import sharding

METRIC_RTOL = 1e-5
MOMENT_RTOL = 2e-5
POOL_ATOL = 1e-6
STATS_ATOL = (1e-7, 1e-4)   # after the first, the second step
JOIN_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' results, the one-process references)."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.worker, args=(r, tmp))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    try:
        eng = W.infer_engine()
        a, b = W.batches(5, 1)[0], W.batches(6, 1)[0]
        q = eng.quantize_generators()
        ref = {"cyclegan": {g: W.cyclegan_run(mp)
                            for g, mp in W.GATES.items()},
               "p2phd": {net: W.p2phd_run(net) for net in W.P2P},
               "bf16": eng.infer_step(a, b),
               "int8": eng.infer_step_int8(*q, (a, b))}
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
    assert not hung, "a data-parallel worker hung"
    assert [p.exitcode for p in procs] == [0] * W.WORLD
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(W.WORLD)]
    return ranks, ref


def _metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL,
                                       abs=1e-7), k


def _moments_close(got, want):
    for g, w in zip(got, want, strict=True):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= MOMENT_RTOL * max(scale, 1e-3)


@pytest.mark.parametrize("gate", list(W.GATES))
def test_cyclegan_step_matches_one_process(runs, gate):
    ranks, ref = runs
    steps, pools = ref["cyclegan"][gate]
    for res in ranks:
        got_steps, got_pools = res["cyclegan"][gate]
        for (gm, gmu), (wm, wmu) in zip(got_steps, steps, strict=True):
            _metrics_close(gm, wm)
            _moments_close(gmu, wmu)
            assert gm["skipped"] == (1.0 if gate == "off" else 0.0)
        assert got_pools[2:] == pools[2:]
        for g, w in zip(got_pools[:2], pools[:2]):
            torch.testing.assert_close(g, w, rtol=0, atol=POOL_ATOL)
    if gate == "off":   # nothing moved: no moment, an empty pool
        assert all(float(m.abs().max()) == 0 for _, mu in steps for m in mu)
        assert pools[2:] == [0, 0]
    else:               # the pools filled, and D stepped
        assert pools[2:] == [2, 2]
        assert all(float(m.abs().max()) > 0 for m in steps[-1][1])


@pytest.mark.parametrize("net", list(W.P2P))
def test_p2phd_step_matches_one_process(runs, net):
    ranks, ref = runs
    want = ref["p2phd"][net]
    for res in ranks:
        for (gm, gmu, gst), (wm, wmu, wst), atol in zip(
                res["p2phd"][net], want, STATS_ATOL, strict=True):
            _metrics_close(gm, wm)
            _moments_close(gmu, wmu)
            for g, w in zip(gst, wst, strict=True):
                torch.testing.assert_close(g, w, rtol=0, atol=atol)
    # multiscale's BatchNorm statistics moved off their init (0 and 1)
    stats = want[-1][2]
    assert (len(stats) > 0) == (net == "multiscale")
    if stats:
        assert float(stats[0].abs().max()) > 0


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_sharded_infer_matches_one_process(runs, kind):
    ranks, ref = runs
    for res in ranks:
        own, loaded = res[kind]
        for o, l, w in zip(own, loaded, ref[kind], strict=True):
            assert o.shape == w.shape == (W.BATCH, W.SIZE, W.SIZE, 1)
            torch.testing.assert_close(o, w, rtol=0, atol=0)
            torch.testing.assert_close(l, o, rtol=0, atol=0)


def test_pad_batch_matches_jax():
    rng = np.random.RandomState(0)
    batch = {"A": rng.rand(5, 3, 3, 1).astype(np.float32),
             "B": rng.rand(5, 2).astype(np.float32)}
    for multiple in (1, 2, 4, 8):
        got, n = sharding.pad_batch_to_multiple(batch, multiple)
        want, wn = jax_pad_batch_to_multiple(batch, multiple)
        assert n == wn
        for k in batch:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    t, n = sharding.pad_batch_to_multiple(torch.from_numpy(batch["A"]), 4)
    np.testing.assert_array_equal(
        t.numpy(), jax_pad_batch_to_multiple(batch["A"], 4)[0])
    assert n == 3
    mesh = sharding.Mesh(rank=1, size=2)
    np.testing.assert_array_equal(
        sharding.shard_batch(got["A"], mesh), got["A"][4:])
