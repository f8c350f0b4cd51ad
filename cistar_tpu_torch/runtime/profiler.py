"""Per-op time table (counterpart of ``cistar_tpu/runtime/profiler.py``).

The reference's engine driver registers a TensorRT ``IProfiler`` that sums
per-layer milliseconds over N iterations and prints a table with a total
(``p2pHD/run_engine.py:35-59,112-117``). The JAX package builds it from an
xprof trace; the port reads ``torch.profiler``:

  * :func:`profile_op_table` warms ``fn`` up once, profiles ``iters`` calls
    and returns ``(rows, totals)`` with the JAX keys: each row ``{op,
    count, total_ms, avg_us, pct}``, sorted by time; totals ``{plane,
    total_ms, runs, per_run_ms}``, and ``wall_ms``, the host time of the
    profiled calls up to the last one's end on the device.
  * :func:`op_table` builds the same from a finished profile.
  * :func:`format_op_table` renders the JAX package's text.

On the card (``fn`` returns CUDA tensors) the rows are the CUDA kernels by
name, each with its self device time; a kernel that one of the ``cistar``
custom ops launched (:mod:`cistar_tpu_torch.kernels.custom_ops`) is named
with the op's kernel id first, as in ``"K1 wg_conv_kernel<...>"``, where
the trace links it to the op. On the CPU the rows are the CPU ops, each
with its self CPU time.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from cistar_tpu_torch.kernels.custom_ops import KERNEL_IDS

Rows = List[Dict[str, Any]]
Totals = Dict[str, Any]


def _kernel_ids(prof) -> Dict[str, str]:
    """CUDA kernel name → the kernel ids of the ``cistar`` ops that
    launched it in this trace (``"K5+K6"`` for a name both launch)."""
    ids: Dict[str, set] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or \
                not ev.name.startswith("cistar::"):
            continue
        kid = KERNEL_IDS.get(ev.name.split("::", 1)[1].split(".")[0])
        for k in ev.kernels if kid is not None else ():
            ids.setdefault(k.name, set()).add(kid)
    return {k: "+".join(sorted(v)) for k, v in ids.items()}


def op_table(prof, cuda: bool, runs: int) -> Tuple[Rows, Totals]:
    """``(rows, totals)`` of a finished ``torch.profiler.profile``: the CUDA
    kernels by self device time (``cuda``), else the CPU ops by self CPU
    time; ``runs`` is the number of profiled calls."""
    ids = _kernel_ids(prof) if cuda else {}
    agg: Dict[str, List[float]] = {}
    for e in prof.key_averages():
        if cuda:
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.self_device_time_total
        else:
            if e.device_type != DeviceType.CPU:
                continue
            us = e.self_cpu_time_total
        label = f"{ids[e.key]} {e.key}" if e.key in ids else e.key
        row = agg.setdefault(label, [0, 0.0])
        row[0] += e.count
        row[1] += us
    total_us = sum(us for _, us in agg.values())
    rows = [{"op": op, "count": count, "total_ms": us / 1e3,
             "avg_us": us / count if count else 0.0,
             "pct": 100.0 * us / total_us if total_us else 0.0}
            for op, (count, us) in sorted(agg.items(), key=lambda r: -r[1][1])]
    plane = (f"/device:{torch.cuda.get_device_name()}" if cuda
             else "/host:CPU")
    totals = {"plane": plane, "total_ms": total_us / 1e3, "runs": runs,
              "per_run_ms": total_us / 1e3 / runs if runs else
              total_us / 1e3}
    return rows, totals


def _on_cuda(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in tree_leaves(out))


def profile_op_table(fn: Callable, *example_args, iters: int = 10,
                     logdir: Optional[str] = None,
                     device: Optional[str] = None) -> Tuple[Rows, Totals]:
    """Profile ``iters`` calls of ``fn(*example_args)`` after one warm-up
    call and return :func:`op_table`'s ``(rows, totals)``, with
    ``totals["wall_ms"]`` the host time of the profiled calls (on the card
    up to ``torch.cuda.synchronize()``). ``device`` (``"cuda"`` or
    ``"cpu"``) says what to trace; by default the card where ``fn``
    returns a CUDA tensor. ``logdir``: also write the Chrome trace
    there."""
    out = fn(*example_args)
    cuda = _on_cuda(out) if device is None else device == "cuda"
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*example_args)
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    rows, totals = op_table(prof, cuda, iters)
    totals["wall_ms"] = wall
    return rows, totals


def format_op_table(rows: Rows, totals: Totals,
                    top: Optional[int] = 30) -> str:
    """Render the TRT-profiler-style table (name, count, ms, avg µs, %)."""
    shown = rows if top is None else rows[:top]
    width = max([len(r["op"]) for r in shown] + [len("TOTAL (device)")])
    width = min(width, 64)
    lines = [
        f"per-op device time — plane {totals['plane']}"
        f" ({totals['runs']} traced runs)",
        f"{'op':<{width}}  {'count':>6}  {'total ms':>9}  "
        f"{'avg µs':>9}  {'%':>6}",
    ]
    for r in shown:
        lines.append(
            f"{r['op'][:width]:<{width}}  {r['count']:>6}  "
            f"{r['total_ms']:>9.3f}  {r['avg_us']:>9.1f}  {r['pct']:>6.2f}")
    if top is not None and len(rows) > top:
        rest_ms = sum(r["total_ms"] for r in rows[top:])
        rest_pct = sum(r["pct"] for r in rows[top:])
        lines.append(
            f"{f'... {len(rows) - top} more ops':<{width}}  {'':>6}  "
            f"{rest_ms:>9.3f}  {'':>9}  {rest_pct:>6.2f}")
    lines.append(
        f"{'TOTAL (device)':<{width}}  {'':>6}  "
        f"{totals['total_ms']:>9.3f}  {'':>9}  {100.0 if rows else 0.0:>6.2f}")
    if totals["runs"]:
        lines.append(f"per-run device time: {totals['per_run_ms']:.3f} ms")
    return "\n".join(lines)
