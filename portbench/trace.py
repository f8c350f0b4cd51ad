"""The traced run's reading of `torch.profiler`: device busy time, kernel
time by name, device time of each `cistar::` custom op's kernels, and the
idle gaps with what the host was doing in them.

The aggregation of kernels under the op that launched them is a frozen
copy of the idea of the program's `runtime/profiler.py::_kernel_ids`: a
kernel belongs to the `cistar::<op>` CPU event whose launch the trace
links it to."""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
TOP = 10


class Trace:
    """A profiler around a traced window; :meth:`window` marks it. With
    ``host`` false it records the card's activity alone: the host's
    events cost a host-bound step several times its time, and without
    them no kernel is linked to a `cistar::` op and each idle gap is named
    by the device op that ends it."""

    def __init__(self, host: bool = True) -> None:
        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] if host or not self.cuda else []
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self) -> "Trace":
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    @staticmethod
    @contextlib.contextmanager
    def window() -> Iterator[None]:
        with record_function(WINDOW):
            yield

    def summary(self, window_s: float) -> dict:
        return summarize(self.prof.events(), window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events, window_s: float) -> dict:
    """From a finished profile's events (times in µs) and the traced
    window's length on the host clock: ``busy_s`` (the
    union of device activity inside the window), ``window_s``,
    ``device_ops`` (seconds by kernel name, most first), ``op_device_s`` /
    ``op_calls`` (each `cistar::` op's kernels' seconds and its calls),
    and ``idle_gaps`` (idle seconds inside the window by the innermost
    host event in progress when each gap began, most first)."""
    cpu, dev = [], []
    win = None
    op_s: Dict[str, float] = {}
    op_n: Dict[str, int] = {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                win = (e.time_range.start, e.time_range.end)
                continue
            cpu.append(e)
            if e.name.startswith("cistar::"):
                op = e.name.split("::", 1)[1].split(".")[0]
                op_n[op] = op_n.get(op, 0) + 1
                op_s[op] = op_s.get(op, 0.0) + 1e-6 * sum(
                    k.duration for k in e.kernels)
        elif e.device_type == DeviceType.CUDA and e.name != WINDOW:
            dev.append(e)
    dev.sort(key=lambda e: e.time_range.start)
    if win is None:
        # no host events: the window is the host's, laid over the device's
        # own span of the mark, or over the profile's device events
        marks = [e for e in events if e.name == WINDOW] or dev
        if not marks:
            raise RuntimeError("the trace holds no device event")
        w0 = min(e.time_range.start for e in marks)
        win = (w0, w0 + 1e6 * window_s)
    w0, w1 = win
    by_name: Dict[str, float] = {}
    spans = []
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        spans.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
    busy = _union(spans)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, float] = {}
    cpu.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    dev_starts = [e.time_range.start for e in dev]
    for g0, g1 in gaps:
        who = (_host_at(cpu, starts, g0) if cpu
               else "before " + _next(dev, dev_starts, g1))
        idle[who] = idle.get(who, 0.0) + (g1 - g0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(t - s for s, t in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[k[:160], v] for k, v in top[:TOP]],
            "op_device_s": op_s, "op_calls": op_n,
            "idle_gaps": [[k[:160], v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]}


def _next(dev, starts, t: float) -> str:
    """The first device op to start at or after ``t``."""
    i = bisect.bisect_left(starts, t)
    return dev[i].name if i < len(dev) else "the window's end"


def _host_at(cpu, starts, t: float) -> str:
    """The innermost host event running at ``t``: of those that began by
    then and had not ended, the latest to begin."""
    i = bisect.bisect_right(starts, t)
    best = None
    for e in reversed(cpu[max(0, i - 4000):i]):
        if e.time_range.end >= t:
            best = e
            break
    return best.name if best is not None else "host idle"


def idle_percent(rec: dict):
    """The share of the traced window with nothing running on the card, or
    None where the run has no trace or the trace saw no device work."""
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_percent(rec: dict, ops):
    """The `cistar::` ops ``ops``' share of their roofline in the traced
    window: Σ launches × the least seconds of one launch (``kernel_bounds``
    of the configuration's `counts` module, at the run's batch) over Σ the
    device seconds of their kernels; None where none of them ran."""
    tr = rec["trace"]
    if tr is None:
        return None
    calls = {op: tr["op_calls"].get(op, 0) for op in ops}
    t = sum(tr["op_device_s"].get(op, 0.0) for op in ops)
    if not any(calls.values()) or t <= 0:
        return None
    bounds = rec["counts"].kernel_bounds(rec["cfg"], rec["batch"])
    return 100.0 * sum(n * bounds[op] for op, n in calls.items() if n) / t
