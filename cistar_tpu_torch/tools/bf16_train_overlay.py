"""bf16 against fp32 loss curves of the shipped train recipes (counterpart
of ``tools/bf16_train_overlay.py``).

Switching a recipe's compute from fp32 to bf16 must not change how it
trains. This tool runs the same :class:`~cistar_tpu_torch.engines.p2phd.
Pix2PixHD` configuration on the same data stream under both compute
dtypes for N steps, records every per-step loss, and measures the bf16
run's distance from the fp32 one against the natural yardstick: the drift
of an fp32 run whose G starts from weights perturbed at 4e-3 relative, the
order of what bf16 rounding injects into a chaotic GAN trajectory. bf16
passes where its deviation is of the order of that noise band (a ratio
near 1).

    python -m cistar_tpu_torch.tools.bf16_train_overlay --config unet512 \
        --steps 40

Configurations (:data:`CONFIGS`): ``unet512``, the shipped
``r2l_MSRB_7``'s generator (UNet, ngf 64, 3 blocks, 2 discriminators,
512²), and ``p2phd1024`` (``local``, ngf 32, 3 discriminators, 1024²).
The data stream is the JAX tool's, draw for draw (:func:`data_stream`), so
both packages see the same batches bit for bit. The fp32 runs turn TF32
off. ``s_per_step`` is the mean host time of the steps after the first,
each read back to the host; the first step's time is printed. Writes (and
merges by config into) ``--out``. ``--device`` as in the apps: ``""`` runs
on CUDA and raises without a GPU, ``cpu`` on request.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

# config → (size, netG, num_D, ngf, extra Pix2PixHD arguments)
CONFIGS = {"unet512": (512, "UNet", 2, 64, {"n_blocks_global": 3}),
           "p2phd1024": (1024, "local", 3, 32, {})}
# the seeds of every curve's data stream and of the perturbation's draws
DATA_SEED, PERTURB_SEED = 0, 123


def data_stream(size: int, seed: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Sparse positive blobs on a -1 background (``Radar2LidarDataset``'s
    range): (label, image), each (1, size, size, 1) fp32, drawn from
    ``RandomState(seed)`` as the JAX tool draws them."""
    rng = np.random.RandomState(seed)
    while True:
        lab = rng.rand(1, size, size, 1).astype(np.float32)
        img = rng.rand(1, size, size, 1).astype(np.float32)
        yield (np.where(lab > 0.97, lab, 0.0) * 2 - 1,
               np.where(img > 0.95, img, 0.0) * 2 - 1)


def perturb_(params: Dict, rel: float) -> None:
    """Scale every non-scalar param by (1 + rel · N(0, 1)), in place; the
    draws from a CPU ``torch.Generator`` seeded ``PERTURB_SEED``, in the
    params' order, so the same on every device."""
    import torch

    gen = torch.Generator().manual_seed(PERTURB_SEED)
    with torch.no_grad():
        for p in params.values():
            if p.ndim > 0:
                noise = torch.randn(p.shape, generator=gen)
                p.mul_(1 + rel * noise.to(p.device, p.dtype))


def run_curve(config: str, dtype_name: str, steps: int,
              perturb: float = 0.0, device=None
              ) -> Tuple[Dict[str, List[float]], float]:
    """``steps`` train steps of ``config`` from seed 0 on
    ``data_stream(size, DATA_SEED)`` in ``dtype_name``
    ("fp32" or "bf16"), G perturbed by ``perturb`` relative when given:
    the per-step metrics by name, and the mean seconds a step after the
    first."""
    import torch

    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.ops.lbfgs import highest_precision

    fp32 = dtype_name == "fp32"
    size, net_g, num_d, ngf, kw = CONFIGS[config]
    eng = Pix2PixHD(net_g=net_g, ngf=ngf, num_d=num_d, image_size=size,
                    compute_dtype=torch.float32 if fp32 else torch.bfloat16,
                    device=device, **kw)
    state = eng.init_state(0, image_size=size)
    if perturb:
        perturb_(state.g, perturb)
    stream = data_stream(size, DATA_SEED)
    curves: Dict[str, List[float]] = {}
    times = []
    with highest_precision() if fp32 else contextlib.nullcontext():
        for i in range(steps):
            label, image = (torch.from_numpy(a).to(eng.device)
                            for a in next(stream))
            t0 = time.perf_counter()
            state, metrics, _ = eng.train_step(state, label, None, image)
            names = sorted(metrics)
            values = torch.stack([metrics[k] for k in names]).tolist()
            times.append(time.perf_counter() - t0)
            for k, v in zip(names, values):
                curves.setdefault(k, []).append(v)
            if i == 0:
                print(f"  [{dtype_name}] first step {times[0]:.2f} s",
                      flush=True)
    steady = times[1:] or times
    return curves, sum(steady) / len(steady)


def summarize(fp32, bf16, fp32b):
    """Per-loss mean |bf16-fp32| vs mean |fp32perturbed-fp32| (noise
    band from a bf16-epsilon-scale init perturbation run in fp32)."""
    out = {}
    for k in fp32:
        a = fp32[k]
        b = bf16[k]
        c = fp32b[k]
        n = min(len(a), len(b), len(c))
        dev = sum(abs(x - y) for x, y in zip(a[:n], b[:n])) / n
        noise = sum(abs(x - y) for x, y in zip(a[:n], c[:n])) / n
        out[k] = {"mean_abs_dev_bf16": round(dev, 5),
                  "fp32_run_noise": round(noise, 5),
                  "ratio": round(dev / noise, 3) if noise > 1e-9 else None}
    return out


def main(argv=None):
    """Runs the three curves of ``--config``; writes and returns its
    artifact."""
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="unet512", choices=sorted(CONFIGS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out",
                    default=os.path.join("chiprun_out",
                                         "bf16_train_overlay.json"))
    ap.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                    help="'' runs on CUDA (no GPU raises); cpu on request")
    args = ap.parse_args(argv)
    dev = args.device or None
    kind = (torch.cuda.get_device_name(0) if args.device != "cpu"
            and torch.cuda.is_available() else "cpu")

    print(f"{args.config}: fp32 curve ({args.steps} steps) on {kind}",
          flush=True)
    fp32, s_fp32 = run_curve(args.config, "fp32", args.steps, device=dev)
    print(f"{args.config}: bf16 curve", flush=True)
    bf16, s_bf16 = run_curve(args.config, "bf16", args.steps, device=dev)
    print(f"{args.config}: fp32 noise-band curve (G's init perturbed at "
          "4e-3 relative)", flush=True)
    fp32b, _ = run_curve(args.config, "fp32", args.steps, perturb=4e-3,
                         device=dev)

    summary = summarize(fp32, bf16, fp32b)
    artifact = {
        "config": args.config, "steps": args.steps, "device": kind,
        "s_per_step": {"fp32": round(s_fp32, 4), "bf16": round(s_bf16, 4),
                       "speedup": round(s_fp32 / s_bf16, 3)},
        "summary": summary,
        "curves": {"fp32": fp32, "bf16": bf16, "fp32_perturbed": fp32b},
    }
    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing[args.config] = artifact
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(json.dumps({"config": args.config, "device": kind,
                      "s_per_step": artifact["s_per_step"],
                      "summary": summary}, indent=1))
    print(f"wrote {args.out}", flush=True)
    return artifact


if __name__ == "__main__":
    main()
