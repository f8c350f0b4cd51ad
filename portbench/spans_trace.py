"""The program's own spans on a traced window's timeline.

The port records spans and counters in memory
(`cistar_tpu_torch/runtime/spans.py`) and maps their clock onto the one
`torch.profiler` stamps its events on. :class:`SpanTrace` is the
benchmark's :class:`~portbench.trace.Trace` with the recorder on over the
traced window; its summary holds the usual keys and ``spans``: the
per-span attribution of :func:`attribute`, the six per-layer readings of
:func:`readings`, the counters and the clock checks.

Attribution, in the traced window:
  * each idle interval of the card (the gaps between the union of device
    intervals, as `trace.summarize` finds them) is split by the innermost
    program span open over each part; what no span covers is ``outside``
    (the client's loop and its copy of the output to the host);
  * each device activity (kernel, copy, memset) goes to the innermost span
    open when its launch call began: the CUDA runtime event that carries
    the same correlation id. One without such an event is ``unlinked``.

Run one cell as `run.py --trace 1` runs it (the same arguments and result
line), with the recorder on over the traced window and the per-span table
on standard error::

    python3 portbench/spans_trace.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import bisect  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, NamedTuple, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.trace import WINDOW, Trace, _union  # noqa: E402

ROOTS = ("p2phd.infer", "p2phd.train_step")
OUTSIDE, UNLINKED = "outside", "unlinked"
#: How far (µs) a launch or op may lie outside the span it belongs to.
SLACK_US = 20.0
#: Device activities listed under each span of the table.
TOP = 3
#: The int8 trunk kernels' ops, which belong inside ``g.trunk``.
TRUNK_OPS = ("cistar::msrb_branch_int8", "cistar::resblock_int8_tiled_")
#: The traffic generators whose traced window :func:`main` records.
TRAFFIC = ("infer_closed", "train_staged")


class S(NamedTuple):
    """A program span on the trace's timeline (µs from its start)."""
    id: int
    parent_id: Optional[int]
    root_id: int
    name: str
    t0: float
    t1: float


def on_timeline(rec, trace_start_ns: int) -> List[S]:
    """The recorder's spans in µs from the profile's start."""
    return [S(s.id, s.parent_id, s.root_id, s.name,
              (rec.to_unix_ns(s.t0_ns) - trace_start_ns) / 1e3,
              (rec.to_unix_ns(s.t1_ns) - trace_start_ns) / 1e3)
            for s in rec.spans]


# --------------------------------------------------------------------------- #
# the window and its idle gaps, as trace.summarize finds them
# --------------------------------------------------------------------------- #
def window_and_gaps(events, window_s: float
                    ) -> Tuple[Tuple[float, float], List[Tuple[float, float]]]:
    """The traced window (µs) and the card's idle intervals inside it, from
    a finished profile's events: `trace.summarize`'s window rule and its
    union of the device intervals, which `summarize` keeps to itself.
    :func:`span_summary` sets the idle they give beside `summarize`'s."""
    from torch.autograd import DeviceType
    win, dev = None, []
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                win = (e.time_range.start, e.time_range.end)
        elif e.device_type == DeviceType.CUDA and e.name != WINDOW:
            dev.append((e.time_range.start, e.time_range.end))
    if win is None:
        marks = [e.time_range.start for e in events if e.name == WINDOW] \
            or [s for s, _ in dev]
        if not marks:
            raise RuntimeError("the trace holds no device event")
        win = (min(marks), min(marks) + 1e6 * window_s)
    w0, w1 = win
    busy = _union([(max(s, w0), min(t, w1)) for s, t in dev
                   if min(t, w1) > max(s, w0)])
    return win, gaps_of(win, busy)


def gaps_of(win: Tuple[float, float], busy: List[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    """The parts of ``win`` outside the sorted, disjoint ``busy``."""
    gaps, prev = [], win[0]
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if win[1] > prev:
        gaps.append((prev, win[1]))
    return gaps


# --------------------------------------------------------------------------- #
# attribution
# --------------------------------------------------------------------------- #
def segments(spans: List[S]) -> List[Tuple[float, float, Optional[int]]]:
    """The timeline cut where a span opens or closes: ``(a, b, id)`` with
    ``id`` the innermost span open over ``(a, b)``, None between spans.
    Spans nest (one thread records them), so the innermost is the top of
    a stack of open spans."""
    out: List[Tuple[float, float, Optional[int]]] = []
    stack: List[S] = []
    cur = None

    def emit(b: float) -> None:
        if cur is not None and b > cur:
            out.append((cur, b, stack[-1].id if stack else None))

    for s in sorted(spans, key=lambda s: (s.t0, s.id)):
        while stack and stack[-1].t1 <= s.t0:
            emit(stack[-1].t1)
            cur = stack.pop().t1
        emit(s.t0)
        stack.append(s)
        cur = s.t0
    while stack:
        emit(stack[-1].t1)
        cur = stack.pop().t1
    return out


def _at(segs, starts, t: float) -> Optional[int]:
    """The innermost span open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i][2]
    return None


def attribute(window: Tuple[float, float], gaps, spans: List[S], device,
              launches: Dict[int, float]) -> dict:
    """The window's idle and device time by innermost span.

    ``gaps``: the card's idle intervals inside ``window`` (µs);
    ``device``: ``(start, end, correlation id, name)`` of each device
    activity; ``launches``: correlation id → start of its runtime call.
    Returns ``idle`` and ``device`` (µs) and ``launched`` (activities), each
    by span id, with :data:`OUTSIDE` (and for device time
    :data:`UNLINKED`) beside the ids, and ``by_name``: device µs by (span
    id, activity name)."""
    w0, w1 = window
    segs = segments(spans)
    starts = [a for a, _, _ in segs]
    idle: Dict = {OUTSIDE: 0.0}
    for g0, g1 in gaps:
        inside = 0.0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            a, b, sid = segs[i]
            part = min(b, g1) - max(a, g0)
            if part > 0 and sid is not None:
                idle[sid] = idle.get(sid, 0.0) + part
                inside += part
            i += 1
        idle[OUTSIDE] += (g1 - g0) - inside
    dev: Dict = {OUTSIDE: 0.0, UNLINKED: 0.0}
    n: Dict = {OUTSIDE: 0, UNLINKED: 0}
    by_name: Dict = {}
    for s, e, corr, what in device:
        part = min(e, w1) - max(s, w0)
        if part <= 0:
            continue
        t = launches.get(corr)
        key = UNLINKED if t is None else _at(segs, starts, t)
        key = OUTSIDE if key is None else key
        dev[key] = dev.get(key, 0.0) + part
        n[key] = n.get(key, 0) + 1
        by_name[key, what] = by_name.get((key, what), 0.0) + part
    return {"idle": idle, "device": dev, "launched": n, "by_name": by_name}


def subtree_ids(spans: List[S], names) -> set:
    """The ids of the spans named ``names`` and of every span under one."""
    by = {s.id: s for s in spans}
    out = set()
    for s in spans:
        p: Optional[S] = s
        while p is not None:
            if p.name in names:
                out.add(s.id)
                break
            p = by.get(p.parent_id) if p.parent_id is not None else None
    return out


def roots_in(spans: List[S], window: Tuple[float, float]) -> int:
    """Calls or steps of the window: root spans that began inside it."""
    return sum(1 for s in spans if s.parent_id is None and s.name in ROOTS
               and window[0] <= s.t0 < window[1])


def table(spans: List[S], att: dict, window: Tuple[float, float]) -> dict:
    """Per span name, per call or step of the window: ``host_ms`` (the
    spans' time inside the window), ``idle_ms``, ``launched`` and
    ``device_ms`` by innermost span, and ``top``, its :data:`TOP` device
    activities by ms; then the ``outside`` and ``unlinked`` rows."""
    calls = max(roots_in(spans, window), 1)
    w0, w1 = window
    rows: Dict[str, dict] = {}
    name = {s.id: s.name for s in spans}

    def row(k: str) -> dict:
        return rows.setdefault(k, {"host_ms": 0.0, "idle_ms": 0.0,
                                   "launched": 0.0, "device_ms": 0.0,
                                   "top": {}})
    for s in spans:
        row(s.name)["host_ms"] += max(0.0, min(s.t1, w1) - max(s.t0, w0))
    for k, v in att["idle"].items():
        row(name.get(k, k))["idle_ms"] += v
    for k, v in att["device"].items():
        row(name.get(k, k))["device_ms"] += v
    for k, v in att["launched"].items():
        row(name.get(k, k))["launched"] += v
    for (k, what), v in att["by_name"].items():
        top = row(name.get(k, k))["top"]
        top[what] = top.get(what, 0.0) + v
    for r in rows.values():
        for k in ("host_ms", "idle_ms", "device_ms"):
            r[k] /= 1e3 * calls
        r["launched"] /= calls
        r["top"] = [[what[:80], v / 1e3 / calls] for what, v in sorted(
            r["top"].items(), key=lambda kv: -kv[1])[:TOP]]
    return rows


def readings(spans: List[S], att: dict, window: Tuple[float, float]
             ) -> Dict[str, float]:
    """The per-layer readings the spans give, those whose spans the window
    holds: ``stage_in_idle.infer`` (% of the window the card idles inside
    ``p2phd.stage_in``), ``encode_ms.infer`` / ``trunk_ms.infer`` /
    ``decode_ms.infer`` (device ms a call launched inside ``g.encode`` /
    ``g.trunk`` / ``g.decode``), ``g_idle_ms.train`` / ``d_idle_ms.train``
    (ms a step the card idles inside ``g_forward`` + ``g_backward`` /
    ``d_forward_backward``), each span with the spans under it."""
    roots = {s.name for s in spans if s.parent_id is None}
    calls = roots_in(spans, window)
    win_us = window[1] - window[0]
    out: Dict[str, float] = {}
    if not calls:
        return out

    def under(what: str, names) -> float:
        ids = subtree_ids(spans, names)
        return sum(v for k, v in att[what].items() if k in ids)
    if "p2phd.infer" in roots:
        out["stage_in_idle.infer"] = 100.0 * under(
            "idle", {"p2phd.stage_in"}) / win_us
        for seg in ("encode", "trunk", "decode"):
            out[f"{seg}_ms.infer"] = under("device", {f"g.{seg}"}) \
                / 1e3 / calls
    if "p2phd.train_step" in roots:
        out["g_idle_ms.train"] = under(
            "idle", {"g_forward", "g_backward"}) / 1e3 / calls
        out["d_idle_ms.train"] = under(
            "idle", {"d_forward_backward"}) / 1e3 / calls
    return out


def _distance(cands: List[S], starts: List[float], t0: float, t1: float
              ) -> float:
    """How far ``[t0, t1]`` lies outside the nearest of ``cands``, which
    are disjoint and sorted by start."""
    i = bisect.bisect_right(starts, t0)
    best = float("inf")
    for s in cands[max(0, i - 1):i + 1]:
        best = min(best, max(0.0, s.t0 - t0, t1 - s.t1))
    return best


def clock_check(spans: List[S], window, launch_events, ops) -> dict:
    """Whether the spans and the trace share a clock: every kernel launch
    call in the window inside a root span, every int8 trunk op
    (:data:`TRUNK_OPS`) inside a ``g.trunk`` span and every other
    ``cistar::`` op inside some ``g.*`` span, to :data:`SLACK_US`.
    ``launch_events``, ``ops``: ``(name, start, end)``. Gives, for each,
    the events in the window, those outside and the farthest distance
    (µs)."""
    def check(events, want) -> dict:
        cands = sorted((s for s in spans if want(s)), key=lambda s: s.t0)
        starts = [s.t0 for s in cands]
        worst, bad, n = 0.0, 0, 0
        for _, t0, t1 in events:
            if window[0] <= t0 < window[1]:
                d = _distance(cands, starts, t0, t1)
                n += 1
                worst = max(worst, d)
                bad += d > SLACK_US
        return {"n": n, "outside": bad, "worst_us": worst}

    trunk = [o for o in ops if o[0].startswith(TRUNK_OPS)]
    return {"launches": check(launch_events, lambda s: s.parent_id is None
                              and s.name in ROOTS),
            "trunk_ops": check(trunk, lambda s: s.name == "g.trunk"),
            "other_ops": check([o for o in ops if o not in trunk],
                               lambda s: s.name.startswith("g."))}


# --------------------------------------------------------------------------- #
# the profile's raw events
# --------------------------------------------------------------------------- #
def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def raw_events(prof) -> dict:
    """From a finished profile: ``device`` activities ``(start, end,
    correlation id, name)``, ``launches`` (correlation id → start of its CUDA
    runtime call), ``launch_events`` and ``ops`` (the `cistar::` ops) as
    ``(name, start, end)``, all in µs from the profile's start. A device
    activity and the runtime call that launched it carry one correlation
    id (`_KinetoEvent.correlation_id`)."""
    from torch.autograd import DeviceType
    kr = prof.profiler.kineto_results
    t0 = kr.trace_start_ns()
    device, launches, launch_events = [], {}, []
    for e in kr.events():
        s, t = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name != WINDOW:
                device.append((s, t, e.correlation_id(), name))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = s
            if _is_launch(name):
                launch_events.append((name, s, t))
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CPU
           and e.name.startswith("cistar::")]
    return {"trace_start_ns": t0, "device": device, "launches": launches,
            "launch_events": launch_events, "ops": ops}


# --------------------------------------------------------------------------- #
# the traced window with the recorder on
# --------------------------------------------------------------------------- #
class SpanTrace(Trace):
    """:class:`~portbench.trace.Trace` with the program's recorder on over
    the traced window; its summary adds ``spans`` (:func:`span_summary`),
    which the last summary also leaves in ``SpanTrace.last``."""
    last: Optional[dict] = None

    def __enter__(self) -> "SpanTrace":
        from cistar_tpu_torch.runtime import spans
        super().__enter__()
        self._recording = spans.recording()
        self.rec = self._recording.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._recording.__exit__(*exc)
        super().__exit__(*exc)

    def summary(self, window_s: float) -> dict:
        out = super().summary(window_s)
        out["spans"] = SpanTrace.last = span_summary(
            self.prof, self.rec, window_s, out)
        return out


def span_summary(prof, rec, window_s: float, summ: dict) -> dict:
    """The attribution of a finished profile with the recorder ``rec``;
    ``summ``: `trace.summarize`'s summary of the same profile."""
    raw = raw_events(prof)
    spans = on_timeline(rec, raw["trace_start_ns"])
    window, gaps = window_and_gaps(prof.events(), window_s)
    att = attribute(window, gaps, spans, raw["device"], raw["launches"])
    calls = roots_in(spans, window)
    busy_s = summ["busy_s"]
    return {"table": table(spans, att, window),
            "readings": readings(spans, att, window),
            "calls": calls, "per_s": calls / summ["window_s"],
            "counters": dict(rec.counters), "dropped": rec.dropped,
            "n_spans": len(spans),
            "idle_pct": 100.0 * sum(att["idle"].values())
            / (window[1] - window[0]),
            "device_idle_pct": 100.0 * (1.0 - busy_s / summ["window_s"]),
            "unlinked_pct_of_busy": 100.0 * att["device"][UNLINKED] / 1e6
            / busy_s if busy_s else 0.0,
            "clock": clock_check(spans, window, raw["launch_events"],
                                 raw["ops"])}


def format_table(sp: dict) -> List[str]:
    """The per-span table and its checks, for the log."""
    lines = [f"spans: per call or step, {sp['calls']} in the traced window"
             f" ({sp['per_s']!r} a second); {sp['n_spans']} spans, dropped "
             f"{sp['dropped']}",
             f"{'span':<22}{'host_ms':>10}{'idle_ms':>10}{'launched':>10}"
             f"{'device_ms':>11}"]
    for k, r in sorted(sp["table"].items(),
                       key=lambda kv: kv[0] in (OUTSIDE, UNLINKED)):
        lines.append(f"{k:<22}{r['host_ms']:>10.3f}{r['idle_ms']:>10.3f}"
                     f"{r['launched']:>10.1f}{r['device_ms']:>11.3f}")
        lines += [f"{'':<4}{ms:>8.3f} ms {what}" for what, ms in r["top"]]
    lines += [f"span counters: {json.dumps(sp['counters'], sort_keys=True)}",
              f"span idle: {sp['idle_pct']!r}% of the window by span and "
              f"outside, {sp['device_idle_pct']!r}% by the trace's summary; "
              f"unlinked device time {sp['unlinked_pct_of_busy']!r}% of busy",
              f"span clock: {json.dumps(sp['clock'])}",
              f"span readings: {json.dumps(sp['readings'])}"]
    return lines


def main(argv=None) -> int:
    """`run.py`'s run of a cell with ``--trace 1``, the traffic traced by
    :class:`SpanTrace`; then the per-span table on standard error."""
    from portbench import run
    run.T0 = T0
    for mod in TRAFFIC:
        importlib.import_module(f"portbench.traffic.{mod}").Trace = SpanTrace
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    rc = run.main(argv)
    if rc == 0 and SpanTrace.last is not None:
        for line in format_table(SpanTrace.last):
            print(line, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
