"""pix2pixHD training CLI (counterpart of ``cistar_tpu/apps/p2phd_train.py``,
parity with ``p2pHD/train.py``).

    python -m cistar_tpu_torch.apps.p2phd_train --load_opt \
        checkpoints/r2l_MSRB_7/opt.txt --dataroot DIR [flags]

The flags are ``apps/p2phd_options.py``'s. The loop is the JAX CLI's:
``--continue_train`` resumes at the epoch of ``iter.txt`` from the latest
networks (``--load_pretrain DIR`` loads them from another run), ``--debug``
shrinks the run to one epoch of 10 pairs, ``--max_dataset_size`` cuts the
split; per batch one :meth:`Pix2PixHD.train_step` (bf16 compute unless
``--compute fp32``), the metrics read on the host only every
``--print_freq`` steps; the latest networks (G, D and G's BatchNorm
statistics ``G_stats``) and ``iter.txt`` every ``--save_latest_freq``
images and at each epoch's end, the per-epoch ones every
``--save_epoch_freq`` epochs, as ``.npz`` files that the JAX package loads
as well. Batches go to the device from pinned memory without blocking.

``--uda`` trains the UDA pair instead (:func:`train_uda`): the image
critic (``--training_module discriminator``, the default) or the
shared-encoder autoencoder (``autoencoder``; with ``--wgan`` its feature
critic is a ``WDiscriminator``) on ``UDADataset``'s split, as the JAX CLI
does: no resume of the nets, the split not cut by ``--max_dataset_size``
or ``--debug``, and at each epoch's end the latest nets (``img_D``, or
``E``, ``DF``, ``DR``, ``DL``, ``GL``, ``GR``) as JAX-layout ``.npz``
files, without ``iter.txt`` or BatchNorm statistics. ``--wgan`` and
``--transfer`` reach their trainers through ``engines/factory.py::
create_model``, not through this CLI, as in JAX.

Data parallelism, the JAX CLI's batch sharding over the mesh: under
``torchrun --nproc_per_node N`` (one process a card, NCCL; gloo with
``--device cpu``) every process reads the same global batch (one shuffle,
one seed), pads it to a multiple of N as JAX does and steps on its slice
(:mod:`cistar_tpu_torch.parallel.sharding`); the step is the global
batch's (``Pix2PixHD``'s ``mesh``: BatchNorm statistics, gradients, the D
gate and the metrics reduced over ranks). Rank 0 logs and writes the
checkpoints.

``--spatial_shard``, and ``--uda`` at a world size above 1, raise:
ROADMAP queue 1, item 11.5. The JAX CLI's XLA executable cache and compile
watchdog have no counterpart: the eager step compiles nothing.
"""

from __future__ import annotations

import os


def save_networks(save_dir: str, engine, epoch_label) -> None:
    """G, D and (with BatchNorm) G_stats as ``{epoch_label}_net_*.npz``."""
    from cistar_tpu_torch.core import checkpoint as ckpt

    trees = engine.jax_params()
    for label in ("G", "D", "G_stats"):
        if trees[label] is not None:
            ckpt.save_network(save_dir, label, epoch_label, trees[label])


def load_networks(pre: str, which_epoch, engine) -> None:
    """G, D and G_stats of ``pre`` into ``engine``, tolerantly
    (``load_network``); without a G_stats file, BatchNorm statistics
    re-warm from their init (a warning says so)."""
    from cistar_tpu_torch.core import checkpoint as ckpt

    trees = engine.jax_params()
    g = ckpt.load_network(pre, "G", which_epoch, trees["G"])
    d = ckpt.load_network(pre, "D", which_epoch, trees["D"])
    g_stats = trees["G_stats"]
    if g_stats is not None:
        stats_path = os.path.join(pre, f"{which_epoch}_net_G_stats.npz")
        if os.path.exists(stats_path):
            g_stats = ckpt.load_network(pre, "G_stats", which_epoch, g_stats)
        else:
            print(f"warning: {stats_path} not found; BatchNorm running "
                  "stats re-warm from init", flush=True)
    engine.load_jax_params(g, g_stats, d)


def make_engine(opt, size: int, mesh=None):
    """The :class:`~cistar_tpu_torch.engines.p2phd.Pix2PixHD` the options
    describe: fp32 under ``--compute fp32`` unless ``--fp16`` or
    ``--data_type 16`` asks for bf16, bf16 otherwise; data-parallel over
    ``mesh`` when given."""
    import torch

    from cistar_tpu_torch.engines.factory import pix2pixhd_from_opt

    fp32 = opt.compute == "fp32" and not (opt.fp16 or opt.data_type == 16)
    return pix2pixhd_from_opt(opt, size,
                              torch.float32 if fp32 else torch.bfloat16,
                              mesh)


def main(argv=None):
    from cistar_tpu_torch.apps.p2phd_options import TrainOptions

    opt = TrainOptions().parse(argv)
    if opt.spatial_shard:
        raise NotImplementedError(
            "--spatial_shard (the generator sharded over devices) is not "
            "ported yet: ROADMAP queue 1, item 11.5")

    import torch.distributed as dist

    from cistar_tpu_torch.parallel import sharding

    if opt.uda and sharding.world_size() > 1:
        raise NotImplementedError(
            "--uda across processes (data parallelism of the UDA trainers) "
            "is not ported yet: ROADMAP queue 1, item 11.5")
    own_group = not dist.is_initialized()
    mesh = sharding.make_mesh(opt.device or None)
    try:
        return _main(opt, mesh)
    finally:
        if own_group:
            sharding.close_mesh(mesh)


def _main(opt, mesh):
    import torch

    from cistar_tpu_torch.apps.cyclegan_train import to_device
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import Loader, Radar2LidarDataset
    from cistar_tpu_torch.parallel.sharding import (pad_batch_to_multiple,
                                                    replicate, shard_batch)
    from cistar_tpu_torch.utils.metrics import MetricsLogger

    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(save_dir, exist_ok=True)

    start_epoch, epoch_iter = 1, 0
    if opt.continue_train:
        start_epoch, epoch_iter = ckpt.load_iter(save_dir)
        print(f"Resuming from epoch {start_epoch} at iteration {epoch_iter}")

    if opt.debug:
        opt.display_freq = opt.print_freq = opt.niter = opt.niter_decay = 1
        opt.max_dataset_size = 10

    if opt.uda:
        return train_uda(opt, save_dir, start_epoch)

    lead = mesh.rank == 0
    size = opt.r2l_res if opt.r2l else opt.fineSize
    engine = make_engine(opt, size, mesh)
    state = engine.init_state(0, image_size=size)
    if opt.continue_train or opt.load_pretrain:
        pre = opt.load_pretrain or save_dir
        load_networks(pre, opt.which_epoch, engine)
        print("loaded networks from", pre)
    replicate([state.g, state.d, state.e, state.g_stats], mesh)

    dataset = Radar2LidarDataset(opt.dataroot, size=size, mode="train")
    if opt.max_dataset_size != float("inf"):
        dataset.radar = dataset.radar[: int(opt.max_dataset_size)]
        dataset.lidar = dataset.lidar[: int(opt.max_dataset_size)]
    loader = Loader(dataset, opt.batchSize, shuffle=not opt.serial_batches)
    logger = MetricsLogger(save_dir, opt.niter + opt.niter_decay, len(loader),
                           start_epoch=start_epoch,
                           log_every=max(1, opt.print_freq)) if lead else None
    print(f"#training images = {len(dataset)}", flush=True)

    total_iter = (start_epoch - 1) * len(dataset) + epoch_iter
    for epoch in range(start_epoch, opt.niter + opt.niter_decay + 1):
        state = state._replace(epoch=torch.full(
            (), epoch - 1, dtype=torch.int32, device=engine.device))
        for batch in loader:
            arrs, _ = pad_batch_to_multiple(
                {"label": batch["label"], "image": batch["image"]}, mesh.size)
            local = shard_batch(arrs, mesh)
            label = to_device(local["label"], engine.device)
            image = to_device(local["image"], engine.device)
            state, metrics, _ = engine.train_step(state, label, None, image)
            total_iter += opt.batchSize
            if not lead:
                continue
            logger.log(metrics, n_images=arrs["label"].shape[0])
            if total_iter % opt.save_latest_freq < opt.batchSize:
                save_networks(save_dir, engine, "latest")
                ckpt.save_iter(save_dir, epoch, total_iter)
        if not lead:
            continue
        logger.end_epoch()
        save_networks(save_dir, engine, "latest")
        ckpt.save_iter(save_dir, epoch + 1, 0)
        if epoch % opt.save_epoch_freq == 0:
            save_networks(save_dir, engine, epoch)
            print(f"saved model at end of epoch {epoch}")
    return state


# the UDA autoencoder's nets by checkpoint label, as the JAX CLI saves them
UDA_LABELS = (("E", "e"), ("DF", "df"), ("DR", "dr"), ("DL", "dl"),
              ("GL", "g_lidar"), ("GR", "g_radar"))


def train_uda(opt, save_dir: str, start_epoch: int):
    """The UDA loop (``_train_uda``, parity with ``p2pHD/train.py --uda``):
    the trainer of ``--training_module`` (``create_uda_model``), its state
    from seed 0, ``UDADataset``'s train split at ``--r2l_res``; the critic
    steps on (lidar, radar), the autoencoder on (radar, lidar). Returns
    the state."""
    from cistar_tpu_torch.apps.cyclegan_train import to_device
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import Loader, UDADataset
    from cistar_tpu_torch.engines.factory import create_uda_model
    from cistar_tpu_torch.utils.metrics import MetricsLogger

    critic = opt.training_module == "discriminator"
    engine = create_uda_model(opt)
    state = engine.init_state(0)
    dataset = UDADataset(opt.dataroot, size=opt.r2l_res, mode="train")
    loader = Loader(dataset, opt.batchSize, shuffle=not opt.serial_batches)
    logger = MetricsLogger(save_dir, opt.niter + opt.niter_decay, len(loader),
                           start_epoch=start_epoch,
                           log_every=max(1, opt.print_freq))
    print(f"#training pairs = {len(dataset)}", flush=True)
    for epoch in range(start_epoch, opt.niter + opt.niter_decay + 1):
        for batch in loader:
            radar = to_device(batch["radar"], engine.device)
            lidar = to_device(batch["lidar"], engine.device)
            if critic:
                state, metrics = engine.train_step(state, lidar, radar)
            else:
                state, metrics, _ = engine.train_step(state, radar, lidar)
            logger.log(metrics, n_images=radar.shape[0])
        logger.end_epoch()
        trees = engine.jax_params()
        if critic:
            ckpt.save_network(save_dir, "img_D", "latest", trees["d"])
        else:
            for label, field in UDA_LABELS:
                ckpt.save_network(save_dir, label, "latest", trees[field])
        if epoch % opt.save_epoch_freq == 0:
            print(f"saved UDA model at end of epoch {epoch}")
    return state


if __name__ == "__main__":
    main()
