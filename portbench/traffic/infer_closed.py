"""Closed-loop inference: one client hands the engine a host batch of
radar frames, waits for the translated batch on the host, and sends the
next, for the whole window, as a batch job over a recorded drive does.

Mix parameters (``params`` of ``traffic/<mix>.json``): ``entry``
(``infer_step_int8``, the family's int8 engine, or ``infer_step``, the
plain forward), ``compute_dtype``, ``batch``, ``ring_frames`` (distinct
frames made in set-up, served in turn), ``warmup_calls``,
``sample_calls`` (the calls whose outputs are compared, drawn from the
seed over every call), and for a traced run ``trace_seconds`` (its
traced window, after the measured one) and ``trace_host`` (whether the
profiler records host events too).

Correct: every sampled output against the plain float32 reference on the
same frames, by the worst frame's relative error ‖y − ref‖ / ‖ref‖."""

from __future__ import annotations

import gc
import random
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.reference import p2phd as R
from portbench.trace import Trace
from portbench.traffic import scenes


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, make: Callable) -> None:
        if self.seen < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = make()
        self.seen += 1


def frames(ctx: Ctx) -> List[torch.Tensor]:
    """The ring of host batches of the run's seed."""
    p = ctx.cell["params"]
    radar, _ = scenes.ring(ctx.seed, p["ring_frames"], ctx.cfg["fineSize"])
    b = p["batch"]
    return [torch.from_numpy(radar[i:i + b])
            for i in range(0, len(radar), b)]


def build(ctx: Ctx):
    """The engine with the seed's weights, and its entry as a function of
    the host batch."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    cfg, p = ctx.cfg, ctx.cell["params"]
    eng = Pix2PixHDInference(
        cfg["netG"], ngf=cfg["ngf"],
        n_downsample_global=cfg["n_downsample_global"],
        n_blocks_global=cfg["n_blocks_global"], input_nc=cfg["input_nc"],
        output_nc=cfg["output_nc"], label_nc=cfg["label_nc"], r2l=True,
        no_instance=cfg["no_instance"], norm=cfg["norm"],
        compute_dtype=getattr(torch, p["compute_dtype"]), seed=0,
        device=ctx.device)
    weights.load_into(eng.G, weights.draw(R.generator_spec(cfg), ctx.seed,
                                          ctx.device))
    if p["entry"] == "infer_step_int8":
        qb = eng.quantize_generator()
        return eng, lambda x: eng.infer_step_int8(qb, x)
    if p["entry"] == "infer_step":
        return eng, eng.infer_step
    raise ValueError(f"unknown entry {p['entry']!r}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx: Ctx) -> Outcome:
    """Set-up, the measured window of ``ctx.seconds`` and, in a traced run,
    a second window of ``trace_seconds`` under the profiler; then the
    comparison."""
    p = ctx.cell["params"]
    t = [time.perf_counter()]
    batches = frames(ctx)
    t.append(time.perf_counter())
    eng, call = build(ctx)
    _sync(ctx.device)
    t.append(time.perf_counter())
    for _ in range(p["warmup_calls"]):
        call(batches[0]).cpu()
        t.append(time.perf_counter())
    sample = Reservoir(p["sample_calls"], ctx.seed)

    def loop(seconds: float) -> Tuple[List[float], float]:
        lat, t_open = [], time.perf_counter()
        while True:
            b = sample.seen % len(batches)   # the call's index in the ring
            tc = time.perf_counter()
            y = call(batches[b]).cpu()
            t1 = time.perf_counter()
            lat.append(t1 - tc)
            sample.offer(lambda: (b, y))
            if t1 - t_open >= seconds:
                return lat, t1 - t_open

    t_open = time.perf_counter()
    lat, window = loop(ctx.seconds)
    summary = None
    if ctx.trace:
        with Trace(p["trace_host"]) as tracer:
            with Trace.window():
                _, traced = loop(p["trace_seconds"])
        summary = tracer.summary(traced)
    mem = (torch.cuda.max_memory_allocated(ctx.device)
           if ctx.device.type == "cuda" else 0)
    del eng, call
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    errs = compare(ctx, batches, sample.items)
    limit = ctx.cell["checks"]["rel_err"]["limit"]
    calls = len(lat)
    e2e = {"setup_s": t_open - ctx.t0,
           "infer_img_s": calls * p["batch"] / window,
           "infer_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    record = {"trace": summary, "calls": calls, "batch": p["batch"],
              "window_s": window}
    q = np.percentile(lat, [0, 50, 95, 100]) * 1e3
    notes = [f"setup: start to set-up {t[0] - ctx.t0:.3f} s, frames "
             f"{t[1] - t[0]:.3f} s, engine and weights {t[2] - t[1]:.3f} s, "
             "warm-up calls " + ", ".join(f"{b - a:.3f}" for a, b in
                                          zip(t[2:], t[3:])) + " s",
             f"latency ms: min {q[0]:.3f} median {q[1]:.3f} p95 {q[2]:.3f} "
             f"max {q[3]:.3f} over {calls} calls; compared frames "
             f"{len(errs)}, worst {max(errs)!r}"]
    return Outcome(e2e, record, {"rel_err": (max(errs), limit)}, calls,
                   sum(e > limit for e in errs), mem, notes)


def rel_errs(y: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """‖y − ref‖ / ‖ref‖ of each frame; inf for a frame of another shape
    or with a non-finite value."""
    if y.shape != ref.shape:
        return [float("inf")] * ref.shape[0]
    out = []
    for a, r in zip(y.float(), ref):
        if not bool(torch.isfinite(a).all()):
            out.append(float("inf"))
        else:
            out.append(float((a - r).norm() / r.norm()))
    return out


def reference_outputs(ctx: Ctx, batches: List[torch.Tensor], which,
                      prec: R.Precision) -> Dict[int, torch.Tensor]:
    """The reference's outputs (on the host) of the ring batches
    ``which``, with the seed's weights drawn again."""
    params = weights.draw(R.generator_spec(ctx.cfg), ctx.seed, ctx.device)
    out = {}
    with R.fp32_exact():
        for b in sorted(set(which)):
            out[b] = R.generate_nhwc(ctx.cfg, params,
                                     batches[b].to(ctx.device), prec).cpu()
    return out


def compare(ctx: Ctx, batches: List[torch.Tensor],
            items: List[Tuple[int, torch.Tensor]]) -> List[float]:
    refs = reference_outputs(ctx, batches, [b for b, _ in items], R.FP32)
    return [e for b, y in items for e in rel_errs(y, refs[b])]


def control(ctx: Ctx) -> Dict[str, float]:
    """The cell's numbers with the reference at the control's precision
    (``control`` in the cell's file) in the program's place, on the
    ring's batches."""
    batches = frames(ctx)
    which = list(range(len(batches)))
    low = reference_outputs(ctx, batches, which,
                            R.Precision(**ctx.cell["control"]))
    refs = reference_outputs(ctx, batches, which, R.FP32)
    return {"rel_err": max(e for b in which
                           for e in rel_errs(low[b], refs[b]))}
