"""Data parallelism over processes (counterpart of
``cistar_tpu/parallel/sharding.py``).

The JAX package runs one SPMD program over a device mesh: the batch split
over its ``data`` axis, the parameters replicated, the reductions compiled
to ``psum``. The port runs one process a card under ``torch.distributed``
and computes the same global-batch step: each process holds its slice of
the batch, and the train steps reduce what JAX's program reduces (the
gradients, the gates, the metrics, BatchNorm's statistics) with the
collectives here.

  * :func:`make_mesh` — the process group: NCCL for a CUDA device, gloo
    for the CPU, chosen by the device; rank and world size from the
    arguments or from the environment ``torchrun`` sets.
  * :func:`shard_batch` — the rank's contiguous slice of a global batch,
    in rank order; :func:`replicate` — broadcast from rank 0;
    :func:`pad_batch_to_multiple` — JAX's edge padding of a tail batch.
  * :func:`all_reduce_sum` / :func:`all_reduce_mean` /
    :func:`all_gather_batch` — the collectives of the train steps and the
    sharded inference; :func:`all_reduce_sum_grad` is the sum that
    autograd differentiates (BatchNorm's statistics).

A :class:`Mesh` without a process group (``make_mesh()`` of one process,
nothing in the environment) makes every helper the identity. With a group,
the collectives run at every world size, 1 included, and at world size 1
their values are the identity.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from cistar_tpu_torch.device import DeviceLike, resolve_device

#: How long a collective waits for the other ranks before it fails.
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: ``rank`` of
    ``size`` processes, its ``device``, and whether a process group runs
    the collectives (``grouped``; False: one process, no collectives)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    grouped: bool = False


def make_mesh(device: DeviceLike = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """The process group of this process. ``rank`` / ``world_size``
    default to ``RANK`` / ``WORLD_SIZE`` (``torchrun``), else 0 / 1; a
    CUDA device is ``cuda:LOCAL_RANK``. The group starts (NCCL on CUDA,
    gloo on the CPU) where the world size exceeds 1 or ``init_method``
    is given (else ``env://``); one process with neither gets a mesh with
    no group. An already started group is joined as it is."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), dev, True)
    if size == 1 and init_method is None:
        return Mesh(0, 1, dev, False)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", rank=rank,
                            world_size=size, timeout=timeout)
    return Mesh(rank, size, dev, True)


def world_size() -> int:
    """The processes of the running group, else of ``WORLD_SIZE``, else 1:
    what :func:`make_mesh` would join."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def close_mesh(mesh: Mesh) -> None:
    """End the process group a :func:`make_mesh` started."""
    if mesh.grouped and dist.is_initialized():
        dist.destroy_process_group()


def _slice(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} does not divide over {mesh.size} "
                         "processes: pad it first (pad_batch_to_multiple)")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """The rank's contiguous slice of dim 0 of every array or tensor of a
    pytree, in rank order (rank r holds rows [r·n/size, (r+1)·n/size))."""
    return tree_map(lambda x: _slice(x, mesh), batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of a pytree from rank 0, in place."""
    if mesh.grouped:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                with torch.no_grad():
                    dist.broadcast(t.data, 0)
    return tree


def pad_batch_to_multiple(batch: Any, multiple: int) -> Tuple[Any, int]:
    """Pad dim 0 of every array of a pytree with copies of its last row
    (numpy's ``edge`` mode) until it divides ``multiple``; returns
    (batch, number of rows added)."""

    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])])
        return np.pad(np.asarray(x), [(0, rem)] + [(0, 0)] * (x.ndim - 1),
                      mode="edge")

    leaves = tree_leaves(batch)
    n = leaves[0].shape[0] if leaves else 0
    return tree_map(pad, batch), (-n) % multiple


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ over ranks of ``t`` (a new tensor; ``t`` itself without a
    group)."""
    if mesh is None or not mesh.grouped:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over ranks of ``t``."""
    if mesh is None or not mesh.grouped:
        return t
    return all_reduce_sum(t, mesh) / mesh.size


class _SumOverRanks(torch.autograd.Function):
    """Σ over ranks, whose gradient is the Σ over ranks of the gradients:
    each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum_grad(t: torch.Tensor, mesh: Optional[Mesh]
                        ) -> torch.Tensor:
    """:func:`all_reduce_sum` that autograd differentiates: its backward
    sums the gradients over ranks."""
    if mesh is None or not mesh.grouped:
        return t
    return _SumOverRanks.apply(t)


def all_gather_batch(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order: the
    global batch of a sharded one."""
    if mesh is None or not mesh.grouped:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def global_means(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                 ) -> Dict[str, torch.Tensor]:
    """Each scalar of ``metrics`` averaged over ranks, in one collective."""
    if mesh is None or not mesh.grouped or not metrics:
        return metrics
    vals = all_reduce_mean(torch.stack([v.float() for v in metrics.values()]),
                           mesh)
    return dict(zip(metrics, vals.unbind()))
