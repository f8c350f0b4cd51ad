"""Training at the recipe on paired frames staged on the device: set-up
builds the trainer and its state with the seed's weights, runs its first
``checked_steps`` steps on distinct pairs through the same call as the
window, and the window then steps through the ring of pairs for its whole
length, with the outputs synchronised once at its end.

Mix parameters (``params`` of ``traffic/<mix>.json``):
``compute_dtype``, ``batch``, ``ring_pairs``, ``checked_steps`` (3), and
for a traced run ``trace_seconds`` (its traced window, after the
measured one, in which CUDA events time the step's phase marks) and
``trace_host`` (whether the profiler records host events too).

Correct: the plain float32 reference runs the same first steps from the
same weights on the same pairs. Compared, each as a relative gap:
``loss_gap`` (each loss term of the first step), ``grad_gap`` (the first
gradient's norm, leaf by leaf, as Adam's first moment holds it after step
1: the median leaf's gap) and ``change_gap`` (each leaf's change after the
checked steps: the worst leaf's gap), a leaf's gap taken against the
larger of its reference norm and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's (biases
ahead of an instance norm) are left out of both. The later steps' losses
and the worst leaf's gradient gap go to the log: bf16 rounding alone
moves them by tenths (the stem conv's weight gradient, a sum that
cancels over the 512² pixels; Adam's first steps of ±lr on such
leaves)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.reference import p2phd as R
from portbench.trace import Trace
from portbench.traffic import scenes

LOSSES = ("G_GAN", "G_GAN_Feat", "D_real", "D_fake")
LOGGED = ("loss_gap_all_steps", "grad_gap_worst_leaf")
KEEP = 1e-3   # a leaf counts where its reference gradient ≥ KEEP × median


def spec(cfg: dict) -> R.Spec:
    return ([("G." + n, s) for n, s in R.generator_spec(cfg)]
            + [("D." + n, s) for n, s in R.discriminator_spec(cfg)])


def split(w: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    return ({k[2:]: v for k, v in w.items() if k.startswith("G.")},
            {k[2:]: v for k, v in w.items() if k.startswith("D.")})


def pairs(ctx: Ctx) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    p = ctx.cell["params"]
    radar, lidar = scenes.ring(ctx.seed, p["ring_pairs"] * p["batch"],
                               ctx.cfg["fineSize"])
    b = p["batch"]
    to = lambda a: [torch.from_numpy(a[i:i + b]).to(ctx.device)  # noqa: E731
                    for i in range(0, len(a), b)]
    return to(radar), to(lidar)


def build(ctx: Ctx):
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    cfg, p = ctx.cfg, ctx.cell["params"]
    eng = Pix2PixHD(
        cfg["netG"], input_nc=cfg["input_nc"], output_nc=cfg["output_nc"],
        label_nc=cfg["label_nc"], ngf=cfg["ngf"], ndf=cfg["ndf"],
        n_downsample_global=cfg["n_downsample_global"],
        n_blocks_global=cfg["n_blocks_global"], n_layers_d=cfg["n_layers_D"],
        num_d=cfg["num_D"], norm=cfg["norm"],
        no_instance=cfg["no_instance"], r2l=True,
        use_lsgan=not cfg["no_lsgan"], lambda_feat=cfg["lambda_feat"],
        use_ganfeat_loss=not cfg["no_ganFeat_loss"], vgg_criterion=None,
        lr=cfg["lr"], beta1=cfg["beta1"], niter=cfg["niter"],
        niter_decay=cfg["niter_decay"], pool_size=cfg["pool_size"],
        d_loss_floor=cfg["d_loss_floor"], image_size=cfg["fineSize"],
        compute_dtype=getattr(torch, p["compute_dtype"]), seed=0,
        device=ctx.device)
    state = eng.init_state(seed=0)
    g, d = split(weights.draw(spec(ctx.cfg), ctx.seed, ctx.device))
    weights.load_into(eng.G, g)
    weights.load_into(eng.D, d)
    return eng, state


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(ts) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in ts])


def run(ctx: Ctx) -> Outcome:
    p = ctx.cell["params"]
    t = [time.perf_counter()]
    labels, images = pairs(ctx)
    t.append(time.perf_counter())
    eng, state = build(ctx)
    _sync(ctx.device)
    t.append(time.perf_counter())
    n = len(labels)

    def step(i, mark=None):
        return eng.train_step(state, labels[i % n], None, images[i % n],
                              mark=mark)

    # the checked steps, through the window's own call and feed
    losses, first = [], None
    c1 = float(np.float32(1) - np.float32(ctx.cfg["beta1"]))
    for i in range(p["checked_steps"]):
        state, m, _ = step(i)
        losses.append(torch.stack([m[k] for k in LOSSES]))
        if i == 0:
            first = (_norms(state.opt_g.mu) / c1, _norms(state.opt_d.mu) / c1)
        _sync(ctx.device)
        t.append(time.perf_counter())
    names = (list(state.g), list(state.d))
    g0, d0 = split(weights.draw(spec(ctx.cfg), ctx.seed, ctx.device))
    change = (_norms([v - g0[k] for k, v in state.g.items()]),
              _norms([v - d0[k] for k, v in state.d.items()]))
    del g0, d0
    prog = {"losses": torch.stack(losses).cpu().numpy(),
            "grad": [t.cpu().numpy() for t in first],
            "change": [t.cpu().numpy() for t in change]}
    _sync(ctx.device)

    marks: List[Dict[str, torch.cuda.Event]] = []
    spans = ctx.trace and ctx.device.type == "cuda"

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = ev

    def loop(i: int, seconds: float, marked: bool) -> Tuple[int, float]:
        """Steps from ``i`` for ``seconds``, synchronised at the end: the
        next step's index and the window's length."""
        nonlocal state
        t_open = time.perf_counter()
        while True:
            if marked:
                marks.append({})
            state, _, _ = step(i, mark if marked else None)
            i += 1
            ticks.append(time.perf_counter())
            if ticks[-1] - t_open >= seconds:
                break
        _sync(ctx.device)
        return i, time.perf_counter() - t_open

    ticks: List[float] = []
    t_open = time.perf_counter()
    i, window = loop(p["checked_steps"], ctx.seconds, spans)
    gaps_ms = np.diff([t_open] + ticks[:i - p["checked_steps"]]) * 1e3
    steps = i - p["checked_steps"]
    summary = None
    if ctx.trace:
        with Trace(p["trace_host"]) as tracer:
            with Trace.window():
                _, traced = loop(i, p["trace_seconds"], False)
        summary = tracer.summary(traced)
    adam_ms = [m["g_backward"].elapsed_time(m["g_adam"])
               + m["d_forward_backward"].elapsed_time(m["d_adam"])
               for m in marks]
    mem = (torch.cuda.max_memory_allocated(ctx.device)
           if ctx.device.type == "cuda" else 0)
    del eng, state
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(ctx, labels, images, R.FP32)
    gaps = gaps_of(prog, ref)
    logged = {k: gaps.pop(k) for k in LOGGED}
    notes = [f"setup: start to set-up {t[0] - ctx.t0:.3f} s, frames "
             f"{t[1] - t[0]:.3f} s, trainer and weights {t[2] - t[1]:.3f} s, "
             "checked steps " + ", ".join(f"{b - a:.3f}" for a, b in
                                          zip(t[2:], t[3:])) + " s",
             f"steps {steps} in {window:.3f} s; host ms a step: deciles "
             + " ".join(f"{v:.2f}" for v in np.percentile(
                 gaps_ms, range(0, 101, 10)))
             + f"; first half {np.mean(gaps_ms[:len(gaps_ms) // 2]):.3f}, "
             f"second {np.mean(gaps_ms[len(gaps_ms) // 2:]):.3f}",
             f"not compared: {logged}"] + worst_leaves(prog, ref, names)
    lim = ctx.cell["checks"]
    e2e = {"setup_s": t_open - ctx.t0,
           "train_img_s": steps * p["batch"] / window}
    record = {"trace": summary, "steps": steps, "batch": p["batch"],
              "window_s": window, "adam_ms": adam_ms}
    checks = {k: (v, lim[k]["limit"]) for k, v in gaps.items()}
    return Outcome(e2e, record, checks, steps + p["checked_steps"],
                   sum(v > lim_ for v, lim_ in checks.values()), mem, notes)


def reference(ctx: Ctx, labels, images, prec: R.Precision) -> dict:
    """The reference's readings of the checked steps, from the seed's
    weights drawn again, at precision ``prec``."""
    cfg, p = ctx.cfg, ctx.cell["params"]
    g0, d0 = split(weights.draw(spec(cfg), ctx.seed, ctx.device))
    g = {k: v.clone().requires_grad_(True) for k, v in g0.items()}
    d = {k: v.clone().requires_grad_(True) for k, v in d0.items()}
    opt_g = R.Adam(g, cfg["lr"], cfg["beta1"])
    opt_d = R.Adam(d, cfg["lr"], cfg["beta1"])
    losses, first = [], None
    with R.fp32_exact():
        for i in range(p["checked_steps"]):
            ls, gg, dg = R.train_step(cfg, g, d, opt_g, opt_d, labels[i],
                                      images[i], prec)
            losses.append([ls[k] for k in LOSSES])
            if i == 0:
                first = (_norms(gg.values()).cpu().numpy(),
                         _norms(dg.values()).cpu().numpy())
    change = (_norms([g[k] - g0[k] for k in g]).cpu().numpy(),
              _norms([d[k] - d0[k] for k in d]).cpu().numpy())
    return {"losses": np.array(losses), "grad": list(first),
            "change": list(change)}


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray
               ) -> np.ndarray:
    med = float(np.median(ref[keep]))
    return np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], med)


def worst_leaves(prog: dict, ref: dict, names, k: int = 3) -> List[str]:
    """The ``k`` leaves of each net with the widest gradient and change
    gaps, for the log."""
    out = [f"losses program {prog['losses'].tolist()} reference "
           f"{ref['losses'].tolist()}"]
    for net in (0, 1):
        r = ref["grad"][net]
        keep = r >= KEEP * np.median(r)
        for what in ("grad", "change"):
            pr, rr = prog[what][net], ref[what][net]
            med = float(np.median(rr[keep]))
            gap = np.where(keep, np.abs(pr - rr) / np.maximum(rr, med), 0)
            top = np.argsort(-gap)[:k]
            out.append(f"{'GD'[net]} {what}: " + "; ".join(
                f"{names[net][i]} program {pr[i]!r} reference {rr[i]!r}"
                for i in top))
    return out


def gaps_of(prog: dict, ref: dict) -> Dict[str, float]:
    """The relative gaps of the program's readings to the reference's:
    the three compared, then those for the log."""
    loss = np.abs(prog["losses"] - ref["losses"]) / np.abs(ref["losses"])
    grad, grad_worst, change = [], 0.0, 0.0
    for net in (0, 1):
        r = ref["grad"][net]
        keep = r >= KEEP * np.median(r)
        gaps = _leaf_gaps(prog["grad"][net], r, keep)
        grad += list(gaps)
        grad_worst = max(grad_worst, float(gaps.max()))
        change = max(change, float(_leaf_gaps(prog["change"][net],
                                              ref["change"][net], keep).max()))
    return {"loss_gap": float(loss[0].max()),
            "grad_gap": float(np.median(grad)), "change_gap": change,
            "loss_gap_all_steps": float(loss.max()),
            "grad_gap_worst_leaf": grad_worst}


def control(ctx: Ctx) -> Dict[str, float]:
    """The cell's numbers with the reference at the control's precision in
    the program's place."""
    labels, images = pairs(ctx)
    low = reference(ctx, labels, images, R.Precision(**ctx.cell["control"]))
    return gaps_of(low, reference(ctx, labels, images, R.FP32))
