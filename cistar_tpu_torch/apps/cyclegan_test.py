"""CycleGAN inference CLI (counterpart of ``cistar_tpu/apps/cyclegan_test.py``,
parity with ``CycleGAN/test.py``).

    python -m cistar_tpu_torch.apps.cyclegan_test --dataroot DIR --model_dir M

Loads the four nets of a run from ``--model_dir`` (the ``.npz`` files the
training CLI of either package writes), runs the test split through both
generators and writes, into ``<model_dir>/img_gen_test_rec``, the
recovered-lidar PNGs and the 5-panel strips (fake_lidar | real_radar |
real_lidar | fake_radar | recover_lidar, ``CycleGAN/test.py:132,147``).
``--engine int8`` serves through the family's int8 engine
(``CycleGAN.infer_step_int8``).

Same flags and defaults as the JAX CLI, except:

  * ``--platform`` becomes ``--device``: ``""`` (the default) runs on CUDA
    and raises without a GPU; ``cpu`` runs the plain ops on the CPU;
  * ``--compile_timeout`` is accepted and does nothing: the port compiles
    no program before its first call.

``--shard`` serves through :meth:`CycleGANInference.make_sharded_infer`:
the batch split over the processes of ``torchrun --nproc_per_node N`` (one
a card, NCCL; gloo with ``--device cpu``; one process alone is a world of
1), each rank running the per-rank program on its slice and gathering the
outputs; ``--batchSize`` must divide N, and the tail batch is padded with
copies of its last frame, as JAX pads it. ``--export_engine F`` exports
the per-rank program (``torch.export``, :func:`~cistar_tpu_torch.runtime.
aot.save_compiled`; the weights are its arguments, not in the file) at
``--batchSize / N`` frames and returns; ``--engine_file F`` loads it into
the same wrapper. ``--engine int8`` picks the int8 program, else the
compute-dtype one (JAX's ``bf16``). Rank 0 writes the images.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batchSize", type=int, default=1)
    p.add_argument("--dataroot", type=str, required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--input_nc", type=int, default=1)
    p.add_argument("--output_nc", type=int, default=1)
    p.add_argument("--gen_type", type=str, default="p2p-content")
    p.add_argument("--dense_decoder", type=lambda s: s != "False", default=True)
    p.add_argument("--model_dir", type=str, required=True,
                   help="dir containing netG_A2B.npz / netG_B2A.npz (and "
                        "the discriminators' files)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--engine", default="default", choices=["default", "int8"],
                   help="int8 = the generator family's int8 engine (int8 "
                        "residual trunk, and the atrous encoder stages where "
                        "they fit)")
    p.add_argument("--compile_timeout", type=float, default=None,
                   help="accepted for the JAX CLI's command line; it guards "
                        "an XLA compile there, and the port compiles nothing "
                        "before its first call, so it does nothing here")
    p.add_argument("--shard", action="store_true",
                   help="batch-sharded inference over the processes of "
                        "torchrun (--batchSize must divide their count)")
    p.add_argument("--export_engine", type=str, default="",
                   help="export the per-rank inference program (.pt2) to "
                        "this path and exit")
    p.add_argument("--engine_file", type=str, default="",
                   help="serve with a program exported by --export_engine")
    p.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="'' runs on CUDA (no GPU raises); cpu runs the plain "
                        "ops on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not (args.shard or args.export_engine or args.engine_file):
        return _serve(args, None)

    import torch.distributed as dist

    from cistar_tpu_torch.parallel import sharding

    own_group = not dist.is_initialized()
    mesh = sharding.make_mesh(args.device or None)
    try:
        return _serve(args, mesh)
    finally:
        if own_group:
            sharding.close_mesh(mesh)


def _sharded(args, engine, mesh):
    """The sharded inference the flags ask for, as ``infer(a, b)``; None
    after ``--export_engine``."""
    from cistar_tpu_torch.engines.cyclegan import InferProgram
    from cistar_tpu_torch.runtime.aot import load_compiled, save_compiled

    if args.batchSize % mesh.size:
        raise SystemExit(f"--batchSize {args.batchSize} must divide the "
                         f"process count {mesh.size} for --shard / "
                         "--export_engine / --engine_file")
    kind = "int8" if args.engine == "int8" else "bf16"
    extra = engine.program_args(kind)
    if kind == "int8":
        print("int8 engine: quantized both generators' residual trunks")
    if args.export_engine:
        local = args.batchSize // mesh.size
        za = torch.zeros((local, args.size, args.size, args.input_nc),
                         device=engine.device)
        zb = torch.zeros((local, args.size, args.size, args.output_nc),
                         device=engine.device)
        if mesh.rank == 0:
            nbytes = save_compiled(InferProgram(engine, kind == "int8"),
                                   extra + (za, zb), args.export_engine)
            print(f"exported the per-rank {kind} inference program (batch "
                  f"{local} of {args.batchSize} over {mesh.size} "
                  f"process(es), {args.size}^2) to {args.export_engine} "
                  f"({nbytes} bytes)")
        return None
    program = None
    if args.engine_file:
        program = load_compiled(args.engine_file)
        print(f"loaded the per-rank program of {args.engine_file}")
    infer = engine.make_sharded_infer(mesh, kind, program)
    print(f"sharded inference over {mesh.size} process(es): the batch "
          "split over the ranks, the weights on every rank")
    return lambda a, b: infer(*extra, a, b)


def _serve(args, mesh):
    from cistar_tpu_torch.apps.cyclegan_train import to_device
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import CycleGANImageDataset, Loader
    from cistar_tpu_torch.data.transforms import array_to_pil, denormalize
    from cistar_tpu_torch.engines.cyclegan import CycleGAN
    from cistar_tpu_torch.parallel.sharding import pad_batch_to_multiple
    from cistar_tpu_torch.utils.metrics import save_image_grid

    engine = CycleGAN(
        gen_type=args.gen_type, input_nc=args.input_nc,
        output_nc=args.output_nc, in_features=16, image_size=args.size,
        batch_size=args.batchSize, dense_decoder=args.dense_decoder,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        device=(args.device or None) if mesh is None else mesh.device)
    state = engine.init_state(0, image_size=args.size)
    ckpt.load_cyclegan_state(args.model_dir, engine, state)

    if mesh is not None:
        infer = _sharded(args, engine, mesh)
        if infer is None:
            return args.export_engine
    elif args.engine == "int8":
        q_a2b, q_b2a = engine.quantize_generators()
        print("int8 engine: quantized both generators' residual trunks")
        infer = lambda a, b: engine.infer_step_int8(q_a2b, q_b2a, (a, b))  # noqa: E731
    else:
        infer = engine.infer_step

    save_dir = os.path.join(args.model_dir, "img_gen_test_rec")
    os.makedirs(save_dir, exist_ok=True)

    dataset = CycleGANImageDataset(args.dataroot, size=args.size, mode="test")
    loader = Loader(dataset, args.batchSize)
    lead = mesh is None or mesh.rank == 0
    for i, batch in enumerate(loader):
        a, b = batch["A"], batch["B"]
        if mesh is not None and len(a) != args.batchSize:
            # the sharded program's batch is fixed: pad the tail batch,
            # drop the padded rows' outputs
            (a, b), _ = pad_batch_to_multiple((a, b), args.batchSize)
        outs = infer(to_device(a, engine.device), to_device(b, engine.device))
        fake_b, fake_a, rec_b = (o.cpu().numpy() for o in outs)
        if not lead:
            continue
        for j, name in enumerate(batch["name"]):
            arr = np.clip(denormalize(rec_b[j]), 0, 1)
            array_to_pil(arr).save(os.path.join(save_dir, name))
            save_image_grid(
                {"fake_lidar": fake_b[j], "real_radar": batch["A"][j],
                 "real_lidar": batch["B"][j], "fake_radar": fake_a[j],
                 "recover_lidar": rec_b[j]},
                os.path.join(save_dir, "panel_" + name))
        sys.stdout.write(f"\rGenerated images {i + 1:05d} of {len(loader):05d}")
    sys.stdout.write("\n")
    return save_dir


if __name__ == "__main__":
    main()
