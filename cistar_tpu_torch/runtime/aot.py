"""Exported programs, their timing and cost (counterpart of
``cistar_tpu/runtime/aot.py``).

The JAX package fills the role of the reference's ONNX export and TensorRT
engine driver (``p2pHD/test.py:68-78``, ``p2pHD/run_engine.py:33-173``)
with ``jax.export``. The port does it with ``torch.export``:

  * :func:`save_compiled` — ``torch.export.export`` a module or function at
    example arguments and ``torch.export.save`` it to a ``.pt2`` file; the
    kernels are ``cistar`` custom ops in the graph
    (:mod:`cistar_tpu_torch.kernels.custom_ops`);
  * :func:`load_compiled` — load a ``.pt2`` and return a callable of it;
  * :func:`profile_fn` — steady-state latency: mean / p50 / p95 / best ms;
  * :func:`cost_analysis` — the FLOPs ``FlopCounterMode`` counts, and the
    ops it cannot count (the custom ops).

A ``torch.profiler`` trace of a function is
:func:`cistar_tpu_torch.runtime.profiler.profile_op_table`'s ``logdir``.

The JAX ``*_sharded`` pair has no counterpart here: a sharded program is
a per-rank program (exported and loaded as above) inside the wrapper of
``engines/cyclegan.py::CycleGANInference.make_sharded_infer``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


class _Fn(torch.nn.Module):
    """A function as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def save_compiled(fn: Callable, example_args: Sequence[Any],
                  path: str) -> int:
    """Export ``fn`` (an ``nn.Module``, whose parameters and buffers then
    travel in the file, or a function) at ``example_args`` and save the
    program to ``path`` (``.pt2``). Returns the file's size in bytes."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    ep = torch.export.export(mod, tuple(example_args))
    ep.example_inputs = None   # the file keeps the program, not the inputs
    torch.export.save(ep, path)
    return os.path.getsize(path)


def load_compiled(path: str) -> Callable:
    """The program of a ``.pt2`` file as a callable (its ``module()``),
    after importing :mod:`cistar_tpu_torch.kernels`, which registers the
    custom ops the graph calls."""
    import cistar_tpu_torch.kernels  # noqa: F401
    return torch.export.load(path).module()


def _on_cuda(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in tree_leaves(out))


def profile_fn(fn: Callable, *example_args, iters: int = 100,
               warmup: int = 5) -> Dict[str, float]:
    """Steady-state ms a call: samples of 10 calls each after ``warmup``
    calls, timed with CUDA events where ``fn`` returns CUDA tensors, else
    with the host clock; their mean, p50, p95 and best."""
    out = fn(*example_args)
    cuda = _on_cuda(out)
    for _ in range(warmup):
        fn(*example_args)
    if cuda:
        torch.cuda.synchronize()
    times, inner = [], 10
    for _ in range(max(1, iters // inner)):
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(inner):
                fn(*example_args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*example_args)
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    arr = np.asarray(times)
    return {"mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "best_ms": float(arr.min())}


class _Ops(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func._schema.name)
        return func(*args, **(kwargs or {}))


def cost_analysis(fn: Callable, *example_args) -> Dict[str, Any]:
    """One call of ``fn`` under ``FlopCounterMode``: ``flops``, the FLOPs
    of the ops it counts, and ``uncounted_ops``, the ``cistar`` custom ops
    the call ran, whose FLOPs are not in the count."""
    ops = _Ops()
    with FlopCounterMode(display=False) as counter, ops:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops()),
            "uncounted_ops": sorted(n for n in ops.names
                                    if n.startswith("cistar::"))}

