"""Training at the recipe fed from frames on disk, as `apps/p2phd_train.py`
feeds it: set-up writes a seeded set of radar / lidar pairs as 8-bit PNGs
at their stored size into a temporary directory, and builds over it
`Radar2LidarDataset` (the train split, resized to ``fineSize``, the shared
rotation) and `Loader` (shuffled each epoch, batches assembled on its
prefetch thread), and the trainer with the seed's weights
(:func:`.train_staged.build`). One epoch runs in set-up (its first
``checked_steps`` steps are the compared ones; it decodes every PNG,
which the dataset then keeps); the window steps through further epochs
for its whole length, each batch copied to the card from pinned memory
without blocking (the CLI's `to_device`), the state's epoch set at each
epoch's start, the outputs synchronised once at its end. The CLI's
metrics logger and checkpoints are left out.

Mix parameters (``params`` of ``traffic/<mix>.json``): ``compute_dtype``,
``batch``, ``pairs`` (written; the dataset trains on the first 70%),
``stored_scale`` (the PNGs' side over ``fineSize``), ``checked_steps``,
and for a traced run ``trace_seconds`` and ``trace_host``, as in
:mod:`.train_staged`.

Correct: as :mod:`.train_staged`, the plain float32 reference runs the
same first steps from the same weights on the batches the loader gave
(copied to the card apart from the program's copy); ``loss_gap``,
``grad_gap`` and ``change_gap`` as there.

Its cell, ``msrb7_512.train_loader``, is not among `BENCHMARK.json`'s: over
two sets of six 51 s runs on an H100 its ``train_img_s`` spread (quartile
distance over the median) read 23.5% and 22.7%, wider than half the
metric's 0.25 bound."""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from PIL import Image

from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.reference import p2phd as R
from portbench.trace import Trace
from portbench.traffic import scenes
from portbench.traffic import train_staged as T


def write_pairs(root: str, seed: int, n: int, size: int) -> None:
    """``n`` radar / lidar scenes of run seed ``seed`` as
    ``root/{radar,lidar}/<i>.png``, 8-bit grey, ``size``²."""
    seeds = np.random.SeedSequence(seed).generate_state(n)
    for sub in ("radar", "lidar"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, s in enumerate(seeds):
        for sub, arr in zip(("radar", "lidar"),
                            scenes.make_pair(int(s), size)):
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                os.path.join(root, sub, f"{i:05d}.png"))


def loader(ctx: Ctx, root: str):
    """The dataset and shuffled loader over ``root``, as the CLI builds
    them."""
    from cistar_tpu_torch.data.datasets import Loader, Radar2LidarDataset
    ds = Radar2LidarDataset(root, size=ctx.cfg["fineSize"], mode="train")
    return Loader(ds, ctx.cell["params"]["batch"], shuffle=True)


def stream(ld) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """(epoch, host batch) through the loader's epochs, from 1."""
    epoch = 0
    while True:
        epoch += 1
        for batch in ld:
            yield epoch, batch


def checked_batches(ctx: Ctx, root: str) -> Tuple[List[torch.Tensor],
                                                  List[torch.Tensor]]:
    """The first ``checked_steps`` batches the loader gives over ``root``,
    on the device."""
    it = stream(loader(ctx, root))
    got = [next(it)[1] for _ in range(ctx.cell["params"]["checked_steps"])]
    return _on_device(got, ctx.device)


def _on_device(batches, device) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
    return ([torch.from_numpy(b["label"]).to(device) for b in batches],
            [torch.from_numpy(b["image"]).to(device) for b in batches])


def run(ctx: Ctx) -> Outcome:
    with tempfile.TemporaryDirectory(prefix="portbench_pairs_") as root:
        return _run(ctx, root)


def _run(ctx: Ctx, root: str) -> Outcome:
    from cistar_tpu_torch.apps.cyclegan_train import to_device
    p, dev = ctx.cell["params"], ctx.device
    t = [time.perf_counter()]
    write_pairs(root, ctx.seed, p["pairs"],
                p["stored_scale"] * ctx.cfg["fineSize"])
    ld = loader(ctx, root)
    t.append(time.perf_counter())
    eng, state = T.build(ctx)
    T._sync(dev)
    t.append(time.perf_counter())
    feed = stream(ld)
    epoch_now = 0

    def step(mark=None):
        nonlocal state, epoch_now
        epoch, batch = next(feed)
        if epoch != epoch_now:
            state = state._replace(epoch=torch.full(
                (), epoch - 1, dtype=torch.int32, device=dev))
            epoch_now = epoch
        state, m, _ = eng.train_step(state, to_device(batch["label"], dev),
                                     None, to_device(batch["image"], dev),
                                     mark=mark)
        return batch, m

    # the first epoch: the checked steps, then the rest of it
    losses, first, checked = [], None, []
    c1 = float(np.float32(1) - np.float32(ctx.cfg["beta1"]))
    for i in range(p["checked_steps"]):
        batch, m = step()
        checked.append(batch)
        losses.append(torch.stack([m[k] for k in T.LOSSES]))
        if i == 0:
            first = (T._norms(state.opt_g.mu) / c1,
                     T._norms(state.opt_d.mu) / c1)
    names = (list(state.g), list(state.d))
    g0, d0 = T.split(weights.draw(T.spec(ctx.cfg), ctx.seed, dev))
    change = (T._norms([v - g0[k] for k, v in state.g.items()]),
              T._norms([v - d0[k] for k, v in state.d.items()]))
    del g0, d0
    prog = {"losses": torch.stack(losses).cpu().numpy(),
            "grad": [x.cpu().numpy() for x in first],
            "change": [x.cpu().numpy() for x in change]}
    for _ in range(len(ld) - p["checked_steps"]):
        step()
    T._sync(dev)
    t.append(time.perf_counter())

    marks: List[Dict[str, torch.cuda.Event]] = []
    timed = ctx.trace and dev.type == "cuda"

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = ev

    def loop(seconds: float, marked: bool) -> Tuple[int, float]:
        """Steps for ``seconds``, synchronised at the end: their number
        and the window's length."""
        n, t_open = 0, time.perf_counter()
        while True:
            if marked:
                marks.append({})
            step(mark if marked else None)
            n += 1
            ticks.append(time.perf_counter())
            if ticks[-1] - t_open >= seconds:
                break
        T._sync(dev)
        return n, time.perf_counter() - t_open

    ticks: List[float] = []
    t_open = time.perf_counter()
    steps, window = loop(ctx.seconds, timed)
    gaps_ms = np.diff([t_open] + ticks) * 1e3
    summary = None
    if ctx.trace:
        with Trace(p["trace_host"]) as tracer:
            with Trace.window():
                _, traced = loop(p["trace_seconds"], False)
        summary = tracer.summary(traced)
    adam_ms = [m["g_backward"].elapsed_time(m["g_adam"])
               + m["d_forward_backward"].elapsed_time(m["d_adam"])
               for m in marks]
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    feed.close()
    del eng, state, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    labels, images = _on_device(checked, dev)
    ref = T.reference(ctx, labels, images, R.FP32)
    gaps = T.gaps_of(prog, ref)
    logged = {k: gaps.pop(k) for k in T.LOGGED}
    notes = [f"setup: start to set-up {t[0] - ctx.t0:.3f} s, PNGs written "
             f"{t[1] - t[0]:.3f} s, trainer and weights {t[2] - t[1]:.3f} s,"
             f" first epoch ({len(ld)} steps) {t[3] - t[2]:.3f} s",
             f"steps {steps} in {window:.3f} s; host ms a step: deciles "
             + " ".join(f"{v:.2f}" for v in np.percentile(
                 gaps_ms, range(0, 101, 10)))
             + f"; first half {np.mean(gaps_ms[:len(gaps_ms) // 2]):.3f}, "
             f"second {np.mean(gaps_ms[len(gaps_ms) // 2:]):.3f}",
             f"not compared: {logged}"] + T.worst_leaves(prog, ref, names)
    lim = ctx.cell["checks"]
    e2e = {"setup_s": t_open - ctx.t0,
           "train_img_s": steps * p["batch"] / window}
    record = {"trace": summary, "steps": steps, "batch": p["batch"],
              "window_s": window, "adam_ms": adam_ms}
    checks = {k: (v, lim[k]["limit"]) for k, v in gaps.items()}
    return Outcome(e2e, record, checks, steps + len(ld),
                   sum(v > lim_ for v, lim_ in checks.values()), mem, notes)


def control(ctx: Ctx) -> Dict[str, float]:
    """The cell's numbers with the reference at the control's precision in
    the program's place, on the loader's first batches."""
    p = ctx.cell["params"]
    with tempfile.TemporaryDirectory(prefix="portbench_pairs_") as root:
        write_pairs(root, ctx.seed, p["pairs"],
                    p["stored_scale"] * ctx.cfg["fineSize"])
        labels, images = checked_batches(ctx, root)
    low = T.reference(ctx, labels, images,
                      R.Precision(**ctx.cell["control"]))
    return T.gaps_of(low, T.reference(ctx, labels, images, R.FP32))
