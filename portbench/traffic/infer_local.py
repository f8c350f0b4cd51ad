"""Closed-loop inference of pix2pixHD's `local` generator: the loop,
the mix parameters and the comparison of :mod:`.infer_closed`, run with
`LocalEnhancer`'s plain reference (:mod:`portbench.reference.p2phd_local`),
an engine built with the configuration's enhancer options, and, in a
traced run, the program's spans recorded over the traced window
(:func:`enhance_trace`), which give ``enhance_ms.infer``.

Correct: as :mod:`.infer_closed`, every sampled output against the
reference on the same frames, by the worst frame's ‖y − ref‖ / ‖ref‖."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from portbench import spans_trace as st
from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.reference import p2phd_local as L
from portbench.traffic import infer_closed as closed

KEY = "enhance_ms.infer"
SPAN = "g.enhance"


def build(ctx: Ctx):
    """The engine with the seed's weights, and its int8 entry as a
    function of the host batch."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference
    cfg, p = ctx.cfg, ctx.cell["params"]
    eng = Pix2PixHDInference(
        cfg["netG"], ngf=cfg["ngf"],
        n_downsample_global=cfg["n_downsample_global"],
        n_blocks_global=cfg["n_blocks_global"],
        n_local_enhancers=cfg["n_local_enhancers"],
        n_blocks_local=cfg["n_blocks_local"], input_nc=cfg["input_nc"],
        output_nc=cfg["output_nc"], label_nc=cfg["label_nc"], r2l=True,
        no_instance=cfg["no_instance"], norm=cfg["norm"],
        compute_dtype=getattr(torch, p["compute_dtype"]), seed=0,
        device=ctx.device)
    weights.load_into(eng.G, weights.draw(L.generator_spec(cfg), ctx.seed,
                                          ctx.device))
    if p["entry"] != "infer_step_int8":
        raise ValueError(f"unknown entry {p['entry']!r}")
    qb = eng.quantize_generator()
    return eng, lambda x: eng.infer_step_int8(qb, x)


def reading(spans, att: dict, window) -> Optional[float]:
    """:data:`KEY`: device ms a call launched inside :data:`SPAN` and the
    spans under it, from :func:`~portbench.spans_trace.attribute`'s
    ``att`` over ``window``; None where no such span was recorded."""
    calls = st.roots_in(spans, window)
    if not calls or not any(s.name == SPAN for s in spans):
        return None
    ids = st.subtree_ids(spans, {SPAN})
    return sum(v for k, v in att["device"].items() if k in ids) / 1e3 / calls


def enhance_trace(base) -> type:
    """A trace class that records the program's spans and adds :data:`KEY`
    to their readings: ``base`` where it is a
    :class:`~portbench.spans_trace.SpanTrace` (``spans_trace.py``, run as a
    script, puts its own in :mod:`.infer_closed`'s place and prints the
    per-span table from it), else that class."""
    span_base = base if hasattr(base, "last") else st.SpanTrace

    class EnhanceTrace(span_base):
        def summary(self, window_s: float) -> dict:
            out = super().summary(window_s)
            raw = st.raw_events(self.prof)
            spans = st.on_timeline(self.rec, raw["trace_start_ns"])
            window, gaps = st.window_and_gaps(self.prof.events(), window_s)
            att = st.attribute(window, gaps, spans, raw["device"],
                               raw["launches"])
            ms = reading(spans, att, window)
            if ms is not None:
                out["spans"]["readings"][KEY] = ms
            return out
    return EnhanceTrace


@contextlib.contextmanager
def _as_local() -> Iterator[None]:
    """:mod:`.infer_closed` (the accepted cells' generator, kept as it is)
    with this module's engine, the local reference and
    :func:`enhance_trace` in place of its own, for the body of the
    block."""
    saved = closed.build, closed.R, closed.Trace
    closed.build, closed.R = build, L
    closed.Trace = enhance_trace(closed.Trace)
    try:
        yield
    finally:
        closed.build, closed.R, closed.Trace = saved


def run(ctx: Ctx) -> Outcome:
    with _as_local():
        return closed.run(ctx)


def control(ctx: Ctx) -> Dict[str, float]:
    with _as_local():
        return closed.control(ctx)
