"""CycleGAN training CLI (counterpart of ``cistar_tpu/apps/cyclegan_train.py``,
parity with ``CycleGAN/train.py``).

    python -m cistar_tpu_torch.apps.cyclegan_train --dataroot DIR [flags]

Same flags and defaults as the JAX CLI (``CycleGAN/train.py:24-42``), except:

  * ``--platform`` becomes ``--device``: ``""`` (the default) runs on CUDA
    and raises without a GPU; ``cpu`` runs the plain ops on the CPU;
  * ``--compile_timeout`` and the XLA executable cache are left out: they
    guard and cache XLA compiles, and the eager PyTorch step has none.

``--content_loss`` takes the VGG16 content loss
(``losses/perceptual.py``) for the cycle and identity terms in place of
L1; ``--dense_decoder False`` picks ``MultiscaleGenerator`` for an
``atrous*`` ``--gen_type``.

The loop is the JAX CLI's: per batch one :meth:`CycleGAN.train_step`
(sparse-frame skip, D-loss gates and replay pools inside it), metrics read
on the host only every ``--log_every`` steps, then per epoch ``next_epoch``
and the per-epoch + latest ``.npz`` checkpoints, which the JAX package
loads as well. Batches go to the device from pinned memory without
blocking.

Data parallelism, the JAX CLI's batch sharding over the mesh: under
``torchrun --nproc_per_node N`` (one process a card, NCCL; gloo with
``--device cpu``) every process reads the same global batch, pads it to a
multiple of N as JAX does, and steps on its slice
(:mod:`cistar_tpu_torch.parallel.sharding`); the step is the global
batch's (``CycleGAN``'s ``mesh``). Rank 0 logs and writes the
checkpoints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epoch", type=int, default=0, help="starting epoch")
    p.add_argument("--n_epochs", type=int, default=10)
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--dataroot", type=str, required=True,
                   help="root with radar/ and lidar/ png dirs")
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--decay_epoch", type=int, default=9)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--input_nc", type=int, default=1)
    p.add_argument("--output_nc", type=int, default=1)
    p.add_argument("--n_cpu", type=int, default=8)
    p.add_argument("--gen_type", type=str, default="bilinear_content")
    p.add_argument("--output_dir", type=str, default="./thesis/")
    p.add_argument("--content_loss", action="store_true",
                   help="VGG16 content loss for cycle/identity instead of L1")
    p.add_argument("--dense_decoder", type=lambda s: s != "False", default=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="'' runs on CUDA (no GPU raises); cpu runs the plain "
                        "ops on the CPU")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--min_points", type=float, default=300.0,
                   help="sparse-radar-frame skip threshold (reference value "
                        "300 is calibrated for 512^2 frames)")
    return p.parse_args(argv)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: from pinned memory without blocking on
    CUDA, as is on the CPU."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_engine(args, mesh=None):
    """The :class:`~cistar_tpu_torch.engines.cyclegan.CycleGAN` the flags
    describe, with the content criterion under ``--content_loss``, data-
    parallel over ``mesh`` (on its device) when given."""
    from cistar_tpu_torch.engines.cyclegan import CycleGAN
    from cistar_tpu_torch.losses.perceptual import make_content_criterion

    return CycleGAN(
        gen_type=args.gen_type, input_nc=args.input_nc,
        output_nc=args.output_nc, in_features=16, lr=args.lr,
        n_epochs=args.n_epochs, start_epoch=args.epoch,
        decay_epoch=args.decay_epoch, image_size=args.size,
        batch_size=args.batchSize, dense_decoder=args.dense_decoder,
        cycle_criterion=make_content_criterion() if args.content_loss
        else None, min_points=args.min_points,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        device=(args.device or None) if mesh is None else mesh.device,
        mesh=mesh)


def main(argv=None):
    args = parse_args(argv)

    import torch.distributed as dist

    from cistar_tpu_torch.parallel import sharding

    own_group = not dist.is_initialized()
    mesh = sharding.make_mesh(args.device or None)
    try:
        return _train(args, mesh)
    finally:
        if own_group:
            sharding.close_mesh(mesh)


def _train(args, mesh):
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import CycleGANImageDataset, Loader
    from cistar_tpu_torch.parallel.sharding import (pad_batch_to_multiple,
                                                    replicate, shard_batch)
    from cistar_tpu_torch.utils.metrics import MetricsLogger

    lead = mesh.rank == 0
    output_dir = args.output_dir + "_" + args.gen_type
    os.makedirs(output_dir, exist_ok=True)

    engine = make_engine(args, mesh)
    state = engine.init_state(0, image_size=args.size)
    if args.resume:
        state = ckpt.load_cyclegan_state(output_dir, engine, state)
        print("resumed from", output_dir)
    replicate([state.g_a2b, state.g_b2a, state.d_a, state.d_b], mesh)

    dataset = CycleGANImageDataset(args.dataroot, size=args.size,
                                   unaligned=True, mode="train")
    loader = Loader(dataset, args.batchSize)
    logger = MetricsLogger(output_dir, args.n_epochs, len(loader),
                           start_epoch=args.epoch, log_every=args.log_every) \
        if lead else None
    for epoch in range(args.epoch, args.n_epochs):
        for batch in loader:
            arrs, _ = pad_batch_to_multiple({"A": batch["A"], "B": batch["B"]},
                                            mesh.size)
            local = shard_batch(arrs, mesh)
            real_a = to_device(local["A"], engine.device)
            real_b = to_device(local["B"], engine.device)
            state, metrics = engine.train_step(state, real_a, real_b)
            if lead:
                logger.log(metrics, n_images=arrs["A"].shape[0])
        state = engine.next_epoch(state)
        if lead:
            logger.end_epoch()
            ckpt.save_cyclegan_state(output_dir, engine, epoch=epoch)
            print(f"saved checkpoints for epoch {epoch}")
    return state


if __name__ == "__main__":
    main()
