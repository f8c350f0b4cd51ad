"""Fidelity curve of a trained r2l pix2pixHD experiment (counterpart of
``tools/eval_r2l_fidelity.py``).

For every saved epoch of G (the numbered ``{epoch}_net_G.npz`` in order,
then ``latest``) the generator runs over the test split of
``Radar2LidarDataset`` at batch 1 (at most ``--how_many`` frames) and the
fake lidar is scored against the real one: the mean over frames of the
per-frame correlation, the mean L1, and PSNR = 10·log10(4 / mean MSE) (the
range [-1, 1] has a peak of 2). The rows go to ``fidelity.csv`` in the
experiment directory, with the JAX tool's columns, so a user picks an
epoch by fidelity.

    python -m cistar_tpu_torch.tools.eval_r2l_fidelity --name r2l_MSRB_7 \
        --checkpoints_dir CK --dataroot D \
        --load_opt checkpoints/r2l_MSRB_7/opt.txt --data_type 16

The flags are ``apps/p2phd_options.py``'s ``TestOptions``. The compute
dtype is the JAX tool's: bf16 under ``--data_type 16`` or ``--fp16``, else
fp32 with TF32 off. ``--data_type 8`` serves each epoch's G through the
family's int8 engine instead, as ``p2phd_test --data_type 8`` does (the JAX
tool runs fp32 there), writes ``fidelity_int8.csv``, and holds the int8
output to the same G's fp32 forward (TF32 off) in the calibrated LPIPS
metric and the pixel L1 (``utils/fidelity.py``), printed beside
``BUDGET`` with the int8 kernels' launches a frame. ``--identity_row``
adds a row ``identity`` that scores the radar itself as the fake: a
baseline of the data alone. ``--device`` as in the apps: ``""`` runs on
CUDA and raises without a GPU, ``cpu`` on request.
"""

from __future__ import annotations

import contextlib
import csv
import glob
import itertools
import os
import re
from typing import Dict, List, Sequence

import numpy as np

from cistar_tpu_torch.apps.p2phd_options import TestOptions

FIELDS = ["epoch", "corr", "l1", "psnr"]


class EvalOptions(TestOptions):
    """``TestOptions`` and ``--identity_row``."""

    def initialize(self):
        super().initialize()
        self.parser.add_argument(
            "--identity_row", action="store_true",
            help="add a row 'identity' that scores the radar as the fake")


def checkpoint_epochs(save_dir: str) -> list:
    """The numbered epochs of ``*_net_G.npz`` under ``save_dir`` in order,
    then ``"latest"`` where that file exists."""
    epochs = []
    for path in glob.glob(os.path.join(save_dir, "*_net_G.npz")):
        m = re.match(r"(\d+)_net_G\.npz", os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    epochs.sort()
    if os.path.exists(os.path.join(save_dir, "latest_net_G.npz")):
        epochs.append("latest")
    return epochs


def frame_metrics(fake: np.ndarray, real: np.ndarray) -> tuple:
    """(corr, L1, MSE) of one frame's fake against its real, fp32 arrays."""
    return (np.corrcoef(fake.ravel(), real.ravel())[0, 1],
            np.abs(fake - real).mean(), ((fake - real) ** 2).mean())


def fidelity_row(epoch, frames: Sequence[tuple]) -> Dict:
    """The CSV row of one epoch from its frames' :func:`frame_metrics`."""
    corrs, l1s, mses = zip(*frames)
    return {"epoch": epoch, "corr": float(np.mean(corrs)),
            "l1": float(np.mean(l1s)),
            "psnr": float(10 * np.log10(4.0 / np.mean(mses)))}


def _int8_launches() -> int:
    from cistar_tpu_torch.kernels import (int8_atrous, int8_msrb,
                                          int8_resblock, int8_tiled)

    return sum(n for m in (int8_atrous, int8_msrb, int8_resblock, int8_tiled)
               for n in m.launches.values())


def score_epoch(engine, batches, int8: bool) -> tuple:
    """Each frame's :func:`frame_metrics` under the engine's G; with
    ``int8`` through the int8 engine, with the LPIPS metric and pixel L1 of
    its output against G's fp32 forward (means over the frames) and the
    int8 kernels' launches a frame."""
    import torch

    from cistar_tpu_torch.ops.lbfgs import highest_precision
    from cistar_tpu_torch.utils.fidelity import fidelity_metric

    dev = engine.device
    qblocks = engine.quantize_generator() if int8 else None
    frames, held, launches = [], [], 0
    for b in batches:
        label = torch.from_numpy(b["label"]).to(dev)
        if int8:
            before = _int8_launches()
            fake = engine.infer_step_int8(qblocks, label)
            launches += _int8_launches() - before
            with highest_precision(), torch.inference_mode():
                ref = engine.G(engine.encode_input(label))
                held.append(fidelity_metric(ref, fake))
        else:
            fake = engine.infer_step(label)
        frames.append(frame_metrics(fake.cpu().numpy()[0],
                                    np.asarray(b["image"], np.float32)[0]))
    hold = None
    if int8:
        hold = {k: float(np.mean([h[k] for h in held])) for k in held[0]}
        hold["launches_per_frame"] = launches / len(batches)
    return frames, hold


def main(argv=None):
    """Scores every saved epoch; writes and returns the rows, with each
    epoch's per-frame (corr, L1, MSE) and, under ``--data_type 8``, its
    hold against fp32."""
    import torch

    from cistar_tpu_torch.apps import p2phd_test
    from cistar_tpu_torch.data.datasets import Loader, Radar2LidarDataset
    from cistar_tpu_torch.ops.lbfgs import highest_precision
    from cistar_tpu_torch.utils.fidelity import BUDGET

    opt = EvalOptions().parse(argv, save=False)
    size = opt.r2l_res if opt.r2l else opt.fineSize
    int8 = opt.data_type == 8
    engine = p2phd_test.build_engine(opt)
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)

    dataset = Radar2LidarDataset(opt.dataroot, size=size, mode="test")
    batches = list(itertools.islice(Loader(dataset, 1), opt.how_many))
    print(f"eval split: {len(batches)} images @ {size}²", flush=True)

    epochs = checkpoint_epochs(save_dir)
    if not epochs:
        raise SystemExit(f"no *_net_G.npz checkpoints under {save_dir}")

    rows: List[Dict] = []
    frames: Dict = {}
    holds: Dict = {}
    if opt.identity_row:
        frames["identity"] = [
            frame_metrics(np.asarray(b["label"], np.float32)[0],
                          np.asarray(b["image"], np.float32)[0])
            for b in batches]
        rows.append(fidelity_row("identity", frames["identity"]))
    exact = (highest_precision if engine.cdt == torch.float32
             else contextlib.nullcontext)
    for ep in epochs:
        p2phd_test.load_generator(engine, save_dir, ep)
        with exact():
            frames[ep], hold = score_epoch(engine, batches, int8)
        rows.append(fidelity_row(ep, frames[ep]))
        r = rows[-1]
        print(f"epoch {ep:>6}: corr {r['corr']:.4f} l1 {r['l1']:.4f} "
              f"psnr {r['psnr']:.2f} dB", flush=True)
        if hold is not None:
            holds[ep] = hold
            print(f"epoch {ep:>6}: int8 vs fp32 lpips_metric "
                  f"{hold['lpips_metric']!r} pixel_l1 {hold['pixel_l1']!r} "
                  f"(budget {BUDGET}); int8 launches a frame "
                  f"{hold['launches_per_frame']!r}", flush=True)

    out_csv = os.path.join(save_dir, "fidelity_int8.csv" if int8
                           else "fidelity.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    print("wrote", out_csv, flush=True)
    return {"rows": rows, "frames": frames, "int8": holds}


if __name__ == "__main__":
    main()
