"""pix2pixHD inference CLI (counterpart of ``cistar_tpu/apps/p2phd_test.py``,
parity with ``p2pHD/test.py``).

    python -m cistar_tpu_torch.apps.p2phd_test --load_opt OPT --dataroot DIR

Loads G (and its BatchNorm statistics, ``G_stats``) of
``<checkpoints_dir>/<name>`` at ``--which_epoch``, runs the test split at
batch 1 (the r2l split of ``Radar2LidarDataset``, or ``AlignedDataset``
without ``--r2l``) and writes an HTML gallery of input / synthesized /
real images (``test.py:82-89``) under
``<results_dir>/<name>/<phase>_<which_epoch>``. ``--data_type 32`` (fp32)
and ``16`` (bf16) run :meth:`Pix2PixHDInference.infer_step`; ``8`` runs the
family's int8 engine (:meth:`Pix2PixHDInference.quantize_generator`, then
:meth:`Pix2PixHDInference.infer_step_int8`), which launches the port's
CUDA kernels on the card.

``--export_onnx PATH`` exports the generator as a program of the label
(``torch.export`` of :meth:`Pix2PixHDInference.program`: the forward in
the ``--data_type``'s dtype, or the int8 engine under ``--data_type 8``;
weights and quantized trunk in the file) to a ``.pt2`` and returns. ``--engine PATH`` (or
``--onnx PATH``) loads it, prints its steady-state time
(:func:`~cistar_tpu_torch.runtime.aot.profile_fn`) and its op table
(:mod:`cistar_tpu_torch.runtime.profiler`; the CUDA kernels on the card),
and serves the frames with it; frames with an instance map take the eager
path, as in JAX (the program takes the label alone).
``--spatial_shard`` runs G H-sharded over the processes of ``torchrun
--nproc_per_node N`` (one a card, NCCL; gloo with ``--device cpu``): every
process reads the same frames, runs its slab (halo-exchange convs,
instance norms summed over ranks) and gathers the whole image; rank 0
writes the gallery. As in JAX it refuses ``--data_type 8`` (the int8
kernels run whole-image); it also refuses ``--export_onnx`` / ``--engine``,
whose program is whole-image here.
``--compile_timeout`` does nothing.
"""

from __future__ import annotations

import os
import time


def build_engine(opt, spatial_mesh=None):
    """The :class:`~cistar_tpu_torch.engines.p2phd.Pix2PixHDInference` the
    options describe, its weights from the seed: bf16 under ``--fp16`` or
    ``--data_type`` 16 or 8 (the int8 engine's layers outside its trunk),
    fp32 otherwise; G H-sharded over ``spatial_mesh`` when given."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHDInference

    return Pix2PixHDInference(
        opt.netG, ngf=opt.ngf, n_downsample_global=opt.n_downsample_global,
        n_blocks_global=opt.n_blocks_global,
        n_local_enhancers=opt.n_local_enhancers,
        n_blocks_local=opt.n_blocks_local, input_nc=opt.input_nc,
        output_nc=opt.output_nc, label_nc=opt.label_nc, r2l=opt.r2l,
        no_instance=opt.no_instance, norm=opt.norm,
        compute_dtype=torch.bfloat16
        if (opt.fp16 or opt.data_type in (8, 16)) else torch.float32,
        device=opt.device or None if spatial_mesh is None
        else spatial_mesh.device, spatial_mesh=spatial_mesh)


def load_generator(engine, save_dir: str, which_epoch) -> None:
    """G (and G_stats) of ``which_epoch`` under ``save_dir`` into
    ``engine``, loaded tolerantly."""
    from cistar_tpu_torch.core import checkpoint as ckpt

    trees = engine.jax_params()
    g = ckpt.load_network(save_dir, "G", which_epoch, trees["G"])
    g_stats = None
    if trees["G_stats"] is not None:
        g_stats = ckpt.load_network(save_dir, "G_stats", which_epoch,
                                    trees["G_stats"])
    engine.load_jax_params(g, g_stats)


def load_engine(opt, spatial_mesh=None):
    """:func:`build_engine` with G (and G_stats) of
    ``<checkpoints_dir>/<name>`` at ``--which_epoch``."""
    engine = build_engine(opt, spatial_mesh)
    load_generator(engine, os.path.join(opt.checkpoints_dir, opt.name),
                   opt.which_epoch)
    return engine


def main(argv=None):
    from cistar_tpu_torch.apps.p2phd_options import TestOptions

    opt = TestOptions().parse(argv, save=False)
    opt.nThreads = 1
    opt.batchSize = 1
    opt.serial_batches = True
    opt.no_flip = True
    if not opt.spatial_shard:
        return _main(opt, None)
    if opt.data_type == 8:
        raise SystemExit("--spatial_shard and --data_type 8 are separate "
                         "tiers (the int8 kernels run whole-image)")
    if opt.export_onnx or opt.engine or opt.onnx:
        raise SystemExit("--spatial_shard and an exported program are "
                         "separate tiers (the program is whole-image)")
    import torch.distributed as dist

    from cistar_tpu_torch.parallel import sharding

    own_group = not dist.is_initialized()
    mesh = sharding.make_mesh(opt.device or None)
    print(f"spatial sharding: generator H axis split over {mesh.size} "
          "process(es) (halo-exchange convs, all-reduced IN)", flush=True)
    try:
        return _main(opt, mesh)
    finally:
        if own_group:
            sharding.close_mesh(mesh)


def _main(opt, mesh):
    import numpy as np
    import torch
    from PIL import Image

    from cistar_tpu_torch.apps.cyclegan_train import to_device
    from cistar_tpu_torch.data.datasets import Loader, Radar2LidarDataset
    from cistar_tpu_torch.data.transforms import array_to_pil, denormalize
    from cistar_tpu_torch.utils.label_viz import tensor2label
    from cistar_tpu_torch.utils.metrics import HTMLGallery

    size = opt.r2l_res if opt.r2l else opt.fineSize
    engine = load_engine(opt, mesh)
    lead = mesh is None or mesh.rank == 0
    qblocks = None
    if opt.data_type == 8:
        qblocks = engine.quantize_generator()
        print(f"int8 engine: quantized {len(qblocks)} trunk blocks "
              f"(netG={opt.netG})")

    # what the dataset yields: 1-channel label-id maps in semantic mode and
    # grayscale radar in r2l mode, full input_nc for image-conditional G
    label_ch = 1 if (opt.r2l or opt.label_nc > 0) else opt.input_nc
    example = torch.zeros((1, size, size, label_ch), device=engine.device)
    run = None
    with torch.no_grad():
        if opt.export_onnx:
            from cistar_tpu_torch.runtime.aot import save_compiled

            t0 = time.perf_counter()
            nbytes = save_compiled(engine.program(qblocks), (example,),
                                   opt.export_onnx)
            print(f"exported the generator program -> {opt.export_onnx} "
                  f"({nbytes} bytes, {time.perf_counter() - t0:.2f} s)")
            return opt.export_onnx
        if opt.engine or opt.onnx:
            from cistar_tpu_torch.runtime.aot import load_compiled, profile_fn
            from cistar_tpu_torch.runtime.profiler import (format_op_table,
                                                           profile_op_table)

            path = opt.engine or opt.onnx
            t0 = time.perf_counter()
            run = load_compiled(path)
            print(f"loaded {path} in {time.perf_counter() - t0:.2f} s")
            stats = profile_fn(run, example, iters=100)
            print(f"engine {path}: {stats['mean_ms']:.3f} ms/iter "
                  f"(p50 {stats['p50_ms']:.3f}, p95 {stats['p95_ms']:.3f})")
            # the per-op table, the TRT profiler's printout
            # (run_engine.py:35-59,112-117)
            print(format_op_table(*profile_op_table(run, example, iters=10)))

    web_dir = os.path.join(opt.results_dir, opt.name,
                           f"{opt.phase}_{opt.which_epoch}")
    gallery = HTMLGallery(web_dir, f"Experiment = {opt.name}, "
                          f"Phase = {opt.phase}, Epoch = {opt.which_epoch}")
    if opt.r2l:
        dataset = Radar2LidarDataset(opt.dataroot, size=size, mode="test")
    else:
        from cistar_tpu_torch.data.aligned import AlignedDataset

        dataset = AlignedDataset(opt)
    for i, batch in enumerate(Loader(dataset, 1)):
        if i >= opt.how_many:
            break
        label = to_device(batch["label"], engine.device)
        inst = (to_device(batch["inst"], engine.device)
                if batch["inst"].ndim == 4 else None)
        if run is not None and inst is None:
            with torch.no_grad():
                fake = run(label)
        else:
            fake = (engine.infer_step_int8(qblocks, label, inst)
                    if qblocks is not None else engine.infer_step(label, inst))
        fake = fake.cpu().numpy()
        if not lead:
            continue
        name = os.path.splitext(os.path.basename(batch["path"][0]))[0]
        ims, txts = [], []
        tiles = [("input_label", batch["label"][0]),
                 ("synthesized_image", fake[0])]
        if batch["image"].ndim == 4:  # real image present
            tiles.append(("real_image", batch["image"][0]))
        for tag, arr in tiles:
            fn = f"{name}_{tag}.png"
            if tag == "input_label" and opt.label_nc > 0:
                # semantic mode: the label map colorized, as the reference
                # gallery does (util/util.py:27-35 tensor2label)
                img = Image.fromarray(tensor2label(np.asarray(arr),
                                                   opt.label_nc))
            else:
                img = array_to_pil(np.clip(denormalize(np.asarray(arr)), 0, 1))
            img.save(os.path.join(gallery.img_dir, fn))
            ims.append(fn)
            txts.append(tag)
        gallery.add_header(f"process image... {name}")
        gallery.add_images(ims, txts, ims, width=opt.display_winsize)
        print(f"process image... {batch['path'][0]}")
    if lead:
        gallery.save()
    return web_dir


if __name__ == "__main__":
    main()
