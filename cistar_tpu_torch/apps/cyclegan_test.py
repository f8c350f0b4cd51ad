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
  * ``--shard``, ``--export_engine`` and ``--engine_file`` (batch sharding
    over devices, an exported program) raise ``NotImplementedError``: they
    come with ROADMAP queue 1, item 11;
  * ``--compile_timeout`` is accepted and does nothing: the port compiles
    no program before its first call.
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
                   help="not ported (ROADMAP queue 1, item 11): raises")
    p.add_argument("--export_engine", type=str, default="",
                   help="not ported (ROADMAP queue 1, item 11): raises")
    p.add_argument("--engine_file", type=str, default="",
                   help="not ported (ROADMAP queue 1, item 11): raises")
    p.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="'' runs on CUDA (no GPU raises); cpu runs the plain "
                        "ops on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag in ("shard", "export_engine", "engine_file"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} (sharded inference, exported programs) is not "
                "ported yet: ROADMAP queue 1, item 11")

    from cistar_tpu_torch.apps.cyclegan_train import to_device
    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.data.datasets import CycleGANImageDataset, Loader
    from cistar_tpu_torch.data.transforms import array_to_pil, denormalize
    from cistar_tpu_torch.engines.cyclegan import CycleGAN
    from cistar_tpu_torch.utils.metrics import save_image_grid

    engine = CycleGAN(
        gen_type=args.gen_type, input_nc=args.input_nc,
        output_nc=args.output_nc, in_features=16, image_size=args.size,
        batch_size=args.batchSize, dense_decoder=args.dense_decoder,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        device=args.device or None)
    state = engine.init_state(0, image_size=args.size)
    ckpt.load_cyclegan_state(args.model_dir, engine, state)

    if args.engine == "int8":
        q_a2b, q_b2a = engine.quantize_generators()
        print("int8 engine: quantized both generators' residual trunks")
        infer = lambda a, b: engine.infer_step_int8(q_a2b, q_b2a, (a, b))  # noqa: E731
    else:
        infer = engine.infer_step

    save_dir = os.path.join(args.model_dir, "img_gen_test_rec")
    os.makedirs(save_dir, exist_ok=True)

    dataset = CycleGANImageDataset(args.dataroot, size=args.size, mode="test")
    loader = Loader(dataset, args.batchSize)
    for i, batch in enumerate(loader):
        outs = infer(to_device(batch["A"], engine.device),
                     to_device(batch["B"], engine.device))
        fake_b, fake_a, rec_b = (o.cpu().numpy() for o in outs)
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
