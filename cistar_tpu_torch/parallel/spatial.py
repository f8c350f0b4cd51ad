"""Spatial sharding with halo exchange (counterpart of
``cistar_tpu/parallel/spatial.py``).

Each process holds an H-slab of an NHWC batch: rank r of a process group
of n holds rows [r·h, (r+1)·h) of an image of n·h rows. A conv exchanges
``halo`` boundary rows with its neighbours, pads only at the true image
edges, and gives the slab's rows of the whole-image conv; instance norm
sums its statistics over the group. The process group plays the role of
JAX's ``axis_name``: a data × spatial grid is one group a data shard
(``torch.distributed.new_group``), each holding one image slice's slabs.
``group=None`` is one shard, the whole image, with no collective.

Halo transport: one ``all_gather`` a halo exchange, of each rank's top and
bottom rows, from which each rank takes its neighbours' rows. NCCL cannot
``send`` to its own rank, and gloo's ``send`` / ``recv`` deadlock unless
every pair is ordered; a collective has neither problem, at the cost of
every rank receiving every rank's few rows. A group of one (all that one
card allows) has no neighbour and exchanges nothing; its instance-norm
sums and the gather still run the collectives.

Gradients: each collective is a ``torch.autograd.Function`` with its
backward written out, so a train step differentiates through the sharded
forward as JAX's ``shard_map`` does:

  * halo exchange — the gradient of each received row goes back to the
    rank that owns the row and is added to that row's gradient (one more
    ``all_gather``);
  * instance norm's (Σx, Σx²) — an all-reduce whose backward all-reduces
    the gradients (:func:`~cistar_tpu_torch.parallel.sharding.psum_grad`);
  * :func:`gather_slabs` (slabs → the whole image on every rank) — the
    backward keeps the rank's own slab's gradient and sums nothing, since
    every rank computes the same loss from the whole image.

The JAX code assumes slab shapes it never checks; here a slab thinner
than its halo (rows two ranks away are never fetched), a reflect pad
wider than h − 1 rows, or an odd slab under a stride-2 op raises
ValueError with the shapes.

  * :func:`halo_rows`, :func:`halo_exchange`, :func:`spatial_pad`,
    :func:`spatial_conv2d`,
    :func:`spatial_conv_transpose2d`, :func:`spatial_instance_norm`,
    :func:`spatial_max_pool2`, :func:`spatial_avg_pool_3s2` — the JAX ops;
  * :func:`scatter_slab` / :func:`gather_slabs` / :func:`sharded_apply` —
    whole batch → this rank's slab → the whole output on every rank, the
    role of ``shard_map``'s in and out specs.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.parallel.sharding import Mesh, psum_grad


def group_of(mesh: Optional[Mesh]):
    """The process group of a :class:`Mesh` (every rank), ``None`` for a
    mesh without one: the spatial ops' ``group``."""
    if mesh is None or not mesh.grouped:
        return None
    return dist.group.WORLD


def rank_and_size(group) -> Tuple[int, int]:
    """This process's rank in ``group`` and the group's size (0, 1 for
    ``None``)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(rank_and_size(group)[1])]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _need(ok: bool, what: str, x: torch.Tensor) -> None:
    if not ok:
        raise ValueError(f"H-slab of shape {tuple(x.shape)}: {what}")


def _need_halo(x: torch.Tensor, rows: int) -> None:
    _need(x.shape[1] >= rows, f"a halo of {rows} rows needs at least as "
          "many rows a slab (rows two ranks away are never fetched)", x)


class _HaloRows(torch.autograd.Function):
    """``cat([the upper rank's last `up` rows, the lower rank's first
    `down` rows], H)``; zeros where there is no such rank."""

    @staticmethod
    def forward(ctx, x, up, down, group):
        r, n = rank_and_size(group)
        h = x.shape[1]
        ctx.up, ctx.down, ctx.group, ctx.h = up, down, group, h
        parts = _gather(torch.cat([x[:, h - up:], x[:, :down]], 1), group)
        zeros = x.new_zeros
        from_up = parts[r - 1][:, :up] if r > 0 \
            else zeros((x.shape[0], up) + x.shape[2:])
        from_down = parts[r + 1][:, up:] if r < n - 1 \
            else zeros((x.shape[0], down) + x.shape[2:])
        return torch.cat([from_up, from_down], 1)

    @staticmethod
    def backward(ctx, g):
        up, down, group, h = ctx.up, ctx.down, ctx.group, ctx.h
        r, n = rank_and_size(group)
        parts = _gather(g, group)
        gx = g.new_zeros((g.shape[0], h) + g.shape[2:])
        if r < n - 1:   # my last rows were the lower rank's upper halo
            gx[:, h - up:] += parts[r + 1][:, :up]
        if r > 0:       # my first rows were the upper rank's lower halo
            gx[:, :down] += parts[r - 1][:, up:]
        return gx, None, None, None


def halo_rows(x: torch.Tensor, halo_up: int, halo_down: int,
              group=None) -> torch.Tensor:
    """The ``halo_up`` last rows of the upper neighbour's slab and the
    ``halo_down`` first rows of the lower one's, concatenated in H; zeros
    past the true edges (and for one shard, which has no neighbour)."""
    _need_halo(x, max(halo_up, halo_down))
    if rank_and_size(group)[1] == 1:
        return x.new_zeros((x.shape[0], halo_up + halo_down) + x.shape[2:])
    return _HaloRows.apply(x, halo_up, halo_down, group)


def halo_exchange(x: torch.Tensor, halo_up: int, halo_down: int,
                  group=None) -> torch.Tensor:
    """The NHWC H-slab with ``halo_up`` rows of the upper neighbour
    prepended and ``halo_down`` rows of the lower one appended
    (:func:`halo_rows`); rows past the true edges are zeros, which
    :func:`spatial_pad` overwrites where its mode says otherwise."""
    rows = halo_rows(x, halo_up, halo_down, group)
    return torch.cat([rows[:, :halo_up], x, rows[:, halo_up:]], 1)


def spatial_pad(x: torch.Tensor, pad: int, mode: str = "reflect",
                group=None) -> torch.Tensor:
    """Pad an H-slab by ``pad`` rows and columns as the whole image is
    padded (``reflect``, ``zero``, ``replicate``): the slab padded as if
    it were the image, then, where a neighbour holds them, its halo rows
    (W-padded the same way) written over the top / bottom pad rows. One
    copy of the slab, as the whole-image pad makes."""
    if pad == 0:
        return x
    if mode not in ("reflect", "zero", "replicate"):
        raise ValueError(mode)
    h = x.shape[1]
    if mode == "reflect":
        _need(h >= pad + 1, f"a reflect pad of {pad} rows needs a slab of "
              f"at least {pad + 1}", x)
    _need_halo(x, pad)
    fmode = "constant" if mode == "zero" else mode
    r, n = rank_and_size(group)
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode=fmode)
    if n > 1:
        rows = halo_rows(x, pad, pad, group).permute(0, 3, 1, 2)
        hc = F.pad(rows, (pad, pad, 0, 0), mode=fmode)
        if r > 0:
            y[:, :, :pad] = hc[:, :, :pad]
        if r < n - 1:
            y[:, :, pad + h:] = hc[:, :, pad:]
    return y.permute(0, 2, 3, 1)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None, stride: int = 1,
                   padding: int = 0, pad_mode: str = "zero",
                   group=None) -> torch.Tensor:
    """Conv over an H-slab with the whole image's geometry, OIHW ``w``:
    an odd kernel with ``padding == (k − 1) // 2``, stride 1 or 2 (an even
    slab), so each rank's output rows need only ``padding`` halo rows."""
    k = w.shape[-1]
    if padding != (k - 1) // 2:
        raise ValueError(f"spatial_conv2d takes same-style padding, "
                         f"(k - 1) // 2 = {(k - 1) // 2}, got {padding}")
    _need(x.shape[1] % stride == 0, f"stride {stride} needs a slab whose "
          "rows it divides", x)
    if pad_mode == "zero" and rank_and_size(group)[1] == 1:
        # one shard is the whole image: the conv pads zeros itself
        _need_halo(x, padding)
        return tnn.conv2d(x, w, b, stride=stride, padding=padding)
    y = spatial_pad(x, padding, pad_mode, group)
    return tnn.conv2d(y, w, b, stride=stride)


def spatial_conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None,
                             group=None) -> torch.Tensor:
    """The k = 3, stride 2, pad 1, output padding 1 transpose conv of the
    decoders on an H-slab, ``w`` ``(in, out, 3, 3)``: 2·h output rows.

    Output rows [2rh, 2rh + 2h) read input rows rh … rh + h. The slab's own
    rows give the whole-image op on the slab; the one row of the next rank
    reaches only the last output row, through the kernel's first row, and
    is added there. On the last rank that row is past the image, where the
    whole-image op's output padding reads zeros: the halo is zero there."""
    if w.shape[-2:] != (3, 3):
        raise ValueError("spatial_conv_transpose2d takes the 3x3 stride-2 "
                         f"decoder conv, got kernel {tuple(w.shape[-2:])}")
    h = x.shape[1]
    wd = w.to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), wd, None, stride=2,
                             padding=1, output_padding=1)
    if rank_and_size(group)[1] > 1:
        row = halo_rows(x, 0, 1, group).permute(0, 3, 1, 2)
        out[:, :, 2 * h - 1:] += F.conv_transpose2d(
            row, wd[:, :, :1], None, stride=2, padding=(0, 1),
            output_padding=(0, 1))
    out = out.permute(0, 2, 3, 1)
    return out if b is None else out + b.to(out.dtype)


def spatial_instance_norm(x: torch.Tensor, eps: float = 1e-5,
                          group=None) -> torch.Tensor:
    """Instance norm whose (Σx, Σx²) sum over the group: the one-pass
    E[x²] − E[x]², clamped at 0, and rsqrt, in fp32, in JAX's order."""
    xf = x.float()
    local = torch.cat([xf.sum(dim=(1, 2), keepdim=True),
                       torch.square(xf).sum(dim=(1, 2), keepdim=True)], -1)
    n = rank_and_size(group)[1]
    total = local if group is None else psum_grad(local, group)
    count = float(x.shape[1] * x.shape[2] * n)
    c = x.shape[-1]
    mean = total[..., :c] / count
    var = total[..., c:] / count - torch.square(mean)
    out = (xf - mean) * torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return out.to(x.dtype)


def spatial_max_pool2(x: torch.Tensor, group=None) -> torch.Tensor:
    """2×2 / 2 max pool on an even H-slab (no halo)."""
    _need(x.shape[1] % 2 == 0, "a 2x2 pool needs an even slab", x)
    return tnn.max_pool2d(x, 2, 2)


@functools.lru_cache(maxsize=None)
def _slab_pool_counts(h: int, w: int, r: int, n: int,
                      device: torch.device) -> torch.Tensor:
    """The in-bounds counts of each 3×3 / 2 window of rank ``r``'s slab of
    ``n`` (h rows, w columns, one halo row each way), (ho, wo, 1) fp32.
    Made outside inference mode, like ``ops/nn.py::_pool_counts``: the
    cached table also serves train steps."""
    with torch.inference_mode(False):
        rows = torch.arange(h + 2) + (r * h - 1)
        cols = torch.arange(w + 2)
        valid = (((rows >= 0) & (rows < n * h))[:, None]
                 & ((cols >= 1) & (cols <= w))[None, :]).float()
        return _window_sum_3s2(valid[None, ..., None])[0].to(device)


def _window_sum_3s2(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sums of the 3×3 / 2 windows of an NHWC ``t`` already padded
    by one row and one column each way, taps in row-major order."""
    ho, wo = (t.shape[1] - 2) // 2, (t.shape[2] - 3) // 2 + 1
    s = torch.zeros(t.shape[0], ho, wo, t.shape[-1], device=t.device)
    for dy in range(3):
        for dx in range(3):
            s = s + t[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
    return s


def spatial_avg_pool_3s2(x: torch.Tensor, group=None) -> torch.Tensor:
    """``AvgPool2d(3, stride=2, padding=1, count_include_pad=False)`` on an
    even H-slab, the pix2pixHD pyramid's downsampler: one halo row each
    way (zeros at the true edges), the fp32 window sums, divided by the
    true in-bounds counts of each window (cached by slab shape and rank)."""
    _need(x.shape[1] % 2 == 0, "a stride-2 pool needs an even slab", x)
    r, n = rank_and_size(group)
    h, w = x.shape[1], x.shape[2]
    y = F.pad(halo_exchange(x, 1, 1, group).float(), (0, 0, 1, 1))
    counts = _slab_pool_counts(h, w, r, n, x.device)
    return (_window_sum_3s2(y) / counts).to(x.dtype)


def scatter_slab(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's H-slab of a whole NHWC batch that every rank holds."""
    r, n = rank_and_size(group)
    if x.shape[1] % n:
        raise ValueError(f"H = {x.shape[1]} does not divide into {n} slabs")
    h = x.shape[1] // n
    return x[:, r * h:(r + 1) * h]


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = rank_and_size(group)[0]
        ctx.h = x.shape[1]
        return torch.cat(_gather(x, group), 1)

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same loss from the whole image: each
        # keeps its own slab's gradient, and no sum over ranks is taken
        return g[:, ctx.rank * ctx.h:(ctx.rank + 1) * ctx.h], None


def gather_slabs(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's H-slab concatenated in rank order: the whole batch, on
    every rank."""
    if group is None:
        return x
    return _GatherSlabs.apply(x, group)


def sharded_apply(fn: Callable, x: torch.Tensor, group=None, params=None
                  ) -> torch.Tensor:
    """``fn(params, slab)`` (or ``fn(slab)``) on this rank's H-slab of the
    whole batch ``x``, the slabs gathered back into the whole output on
    every rank (JAX's ``sharded_apply``, whose ``shard_map`` takes and
    returns global arrays)."""
    slab = scatter_slab(x, group)
    out = fn(slab) if params is None else fn(params, slab)
    return gather_slabs(out, group)
