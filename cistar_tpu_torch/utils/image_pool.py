"""Device-resident replay buffer, the fake-image history pool (counterpart
of ``cistar_tpu/utils/image_pool.py``).

Reference: CycleGAN ``ReplayBuffer`` (``CycleGAN/utils.py:94-114``) and the
identical-semantics pix2pixHD ``ImagePool`` (``p2pHD/util/image_pool.py:4-31``):
a 50-image pool; each incoming fake fills the pool until full, afterwards
with p=0.5 it swaps with a random stored image (the old one is returned to
the discriminator) else passes through.

The pool is one (capacity, H, W, C) fp32 tensor and an int32 fill count,
both on the device. :func:`push_and_pop` draws its coins and slots from an
explicit device ``torch.Generator``; :func:`push_and_pop_core` takes them
as tensors, walks the batch element by element as the JAX ``lax.scan``
does, and writes slots with ``torch.where`` + ``index_copy_``. Nothing
reads a device value on the host, so a train step that uses the pool does
not wait for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class PoolState(NamedTuple):
    images: torch.Tensor   # (capacity, H, W, C) fp32
    size: torch.Tensor     # int32 () current fill


def init_pool(capacity: int, image_shape: Tuple[int, ...],
              device: torch.device) -> PoolState:
    return PoolState(
        images=torch.zeros((capacity,) + tuple(image_shape),
                           dtype=torch.float32, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device))


def draw(n: int, capacity: int, generator: torch.Generator
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per element of a batch of ``n``: the fair coin (True = swap) and the
    random slot in [0, capacity), on ``generator``'s device."""
    dev = generator.device
    use_swap = torch.rand(n, generator=generator, device=dev) > 0.5
    idx = torch.randint(0, capacity, (n,), generator=generator, device=dev)
    return use_swap, idx


def push_and_pop_core(state: PoolState, batch: torch.Tensor,
                      use_swap: torch.Tensor, idx_rand: torch.Tensor,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[PoolState, torch.Tensor]:
    """Insert a batch of fakes with the given draws, returning the images to
    train D on. Element-sequential, as ``ReplayBuffer.push_and_pop``: while
    the pool is not full each element is stored and passed through; once
    full, ``use_swap[i]`` decides between swapping with slot ``idx_rand[i]``
    (returning the old image) and passing through.

    Updates ``state.images`` in place. Where the device bool ``active`` is
    false, the pool and its size come back as they were (the writes are
    undone in reverse order), and the outputs are those of an active step,
    as the JAX step's ``jnp.where(do_step, new, old)`` leaves them."""
    images, size = state.images, state.size
    capacity = images.shape[0]
    batch = batch.to(images.dtype)
    outs, undo = [], []
    for i in range(batch.shape[0]):
        img = batch[i:i + 1]
        not_full = size < capacity
        slot = torch.where(not_full, size.long(), idx_rand[i].long()).view(1)
        old = images.index_select(0, slot)
        do_write = not_full | use_swap[i]
        images.index_copy_(0, slot, torch.where(do_write, img, old))
        outs.append(torch.where(not_full | ~use_swap[i], img, old))
        undo.append((slot, old))
        size = torch.where(not_full, size + 1, size)
    if active is not None:
        for slot, old in reversed(undo):
            images.index_copy_(0, slot, torch.where(
                active, images.index_select(0, slot), old))
        size = torch.where(active, size, state.size)
    return PoolState(images, size), torch.cat(outs)


def push_and_pop(state: PoolState, batch: torch.Tensor,
                 generator: torch.Generator,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[PoolState, torch.Tensor]:
    """:func:`push_and_pop_core` with coins and slots drawn from
    ``generator``; the draws are made whether or not the step is
    ``active``, as the JAX step splits its key on every step."""
    use_swap, idx = draw(batch.shape[0], state.images.shape[0], generator)
    return push_and_pop_core(state, batch, use_swap, idx, active)


def sharded_push_and_pop(state: PoolState, batch: torch.Tensor,
                         generator: torch.Generator, mesh=None,
                         active: Optional[torch.Tensor] = None
                         ) -> Tuple[PoolState, torch.Tensor]:
    """:func:`push_and_pop` of the global batch under data parallelism
    (``mesh``, a :class:`~cistar_tpu_torch.parallel.sharding.Mesh`): the
    ranks' fakes are gathered in rank order, every rank runs the same pool
    with the same ``generator`` state on the whole batch, as the JAX
    program's one pool does, and keeps its own slice of the images for D.
    Without a process group it is :func:`push_and_pop`."""
    from cistar_tpu_torch.parallel import sharding

    state, out = push_and_pop(state, sharding.all_gather_batch(batch, mesh),
                              generator, active)
    if mesh is None or not mesh.grouped:
        return state, out
    return state, sharding.shard_batch(out, mesh)
