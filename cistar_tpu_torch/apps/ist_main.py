"""Gatys IST batch CLI (counterpart of ``cistar_tpu/apps/ist_main.py``,
parity with ``IST/main.py``).

Sweeps a directory of radar PNGs against one fixed lidar style image, with
optional polar / inverse-polar warping and an optional coarse-to-fine
high-resolution second pass, and logs the time of each frame like the
reference (``IST/main.py:244-248``), into ``<save-dir>/log.txt`` too.

    python -m cistar_tpu_torch.apps.ist_main --content-dir DIR \\
        --style-image F --save-dir OUT [--config-file cfg.yaml] \\
        [--polar] [--hr] [--dtype bf16|fp32] [KEY VALUE ...]

Same flags and defaults as the JAX CLI, except:

  * ``--platform`` becomes ``--device``: ``""`` (the default) runs on CUDA
    and raises without a GPU; ``cpu`` runs on the CPU;
  * ``--vgg-weights`` reads a ``.npz`` as the JAX CLI does (``layer.weight``
    HWIO, ``layer.bias``) and any other file as a torch state dict in the
    bethgelab ``vgg_conv.pth`` layout (``torch.load(...,
    weights_only=True)``, then ``models/vgg.py::torch_vgg_conv_to_params``);
  * the JAX CLI's persistent compilation cache and compile watchdog are
    left out: they serve XLA compiles, and the port compiles no program.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch


def load_vgg_params(path: str):
    """VGG params from a ``.npz`` (HWIO ``layer.weight`` / ``layer.bias``
    keys, the JAX CLI's reading) or a torch ``vgg_conv.pth`` state dict."""
    from cistar_tpu_torch.models import vgg as vgg_lib

    if path.endswith(".npz"):
        params: dict = {}
        with np.load(path) as data:
            for key in data.files:
                layer, kind = key.rsplit(".", 1)
                params.setdefault(layer, {})[
                    "w" if kind == "weight" else "b"] = torch.from_numpy(
                        np.array(data[key], np.float32))
        return params
    return vgg_lib.torch_vgg_conv_to_params(
        torch.load(path, map_location="cpu", weights_only=True))


def main(argv=None):
    p = argparse.ArgumentParser(description="Gatys image style transfer")
    p.add_argument("--config-file", default="", help="YAML config overrides")
    p.add_argument("--content-dir", required=True,
                   help="directory of content PNGs")
    p.add_argument("--style-image", required=True, help="style image path")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--vgg-weights", default="",
                   help="vgg_conv .pth/.npz (else random init)")
    p.add_argument("--polar", action="store_true",
                   help="polar-warp before, inverse after")
    p.add_argument("--hr", action="store_true",
                   help="coarse-to-fine high-res pass")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="",
                   help="torch device; '' runs on CUDA")
    p.add_argument("--max-iters", type=int, default=0,
                   help="override LOSS.MAX_ITER")
    p.add_argument("--limit", type=int, default=0,
                   help="process at most N frames")
    p.add_argument("--frames_per_batch", type=int, default=1,
                   help="run N frames as one batched L-BFGS optimization "
                        "(the reference sweeps one frame at a time, "
                        "IST/main.py:186-238)")
    p.add_argument("--history", type=int, default=100,
                   help="L-BFGS history size (torch default 100)")
    p.add_argument("--history_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="store the L-BFGS S/Y history at reduced precision "
                        "(halves the optimizer's memory traffic)")
    p.add_argument("opts", nargs="*", default=[],
                   help="KEY VALUE config overrides")
    args = p.parse_args(argv)

    from cistar_tpu_torch.core.config import get_ist_cfg_defaults
    from cistar_tpu_torch.data.transforms import load_image, \
        pil_polar_transform
    from cistar_tpu_torch.engines.ist import GatysEngine
    from cistar_tpu_torch.models import vgg as vgg_lib
    from cistar_tpu_torch.utils.metrics import setup_logger

    cfg = get_ist_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    os.makedirs(args.save_dir, exist_ok=True)
    logger = setup_logger("style-transfer", args.save_dir, "log.txt")
    logger.info("config:\n%s", cfg.dump())

    if args.vgg_weights:
        params = load_vgg_params(args.vgg_weights)
        logger.info("loaded VGG weights from %s", args.vgg_weights)
    else:
        params = vgg_lib.init_vgg_params(seed=0)
        logger.warning("no --vgg-weights given: using RANDOM VGG init "
                       "(outputs will not match the pretrained reference)")

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    engine = GatysEngine(cfg, params, device=args.device or None,
                         compute_dtype=dtype, history_size=args.history,
                         history_dtype=getattr(torch, args.history_dtype))

    style_img = load_image(args.style_image, "RGB")
    content_list = sorted(glob.glob(os.path.join(args.content_dir, "*.png")))
    if args.limit:
        content_list = content_list[: args.limit]
    max_iters = args.max_iters or None

    fpb = max(1, args.frames_per_batch)
    style_in = pil_polar_transform(style_img) if args.polar else style_img
    sweep_start = time.time()
    for start in range(0, len(content_list), fpb):
        paths = content_list[start:start + fpb]
        t0 = time.time()
        content_imgs = []
        for path in paths:
            img = load_image(path, "RGB")
            if args.polar:
                img = pil_polar_transform(img)
            content_imgs.append(img)
        if fpb == 1:
            outs = [engine.transfer_style(content_imgs[0], style_in,
                                          max_iters=max_iters)]
        else:
            outs = engine.transfer_style_batch(content_imgs, style_in,
                                               max_iters=max_iters)
        for path, content_img, out in zip(paths, content_imgs, outs):
            if args.hr:
                out = engine.hr_transfer_style(content_img, style_in, out)
            if args.polar:
                out = pil_polar_transform(out, reverse=True)
            out.save(os.path.join(args.save_dir, os.path.basename(path)))
        dt = time.time() - t0
        logger.info("frames %d-%d/%d: %.3f s (%.3f s/frame)",
                    start + 1, start + len(paths), len(content_list),
                    dt, dt / max(1, len(paths)))
    n = max(1, len(content_list))
    logger.info("avg seconds per frame: %.3f", (time.time() - sweep_start) / n)


if __name__ == "__main__":
    main()
