"""Quality runs of the extended / UDA trainers (counterpart of
``tools/quality_run_uda.py``).

Trains each on a prepared radar / lidar set (``UDADataset``'s split) for a
short budget and writes the evidence under ``--out``:

  * ``ae/``: ``R2LAE`` (``n_downsample`` 3, ngf 16, bf16): ``loss_log.csv``
    (per-epoch means) and ``cross_decode.png`` (the shared encoder's
    features of the first test pair through both decoders: reconstructions
    and cross decodes);
  * ``critic/``: ``R2LImageCritic`` (fp32): ``w_distance.csv``, a row a
    step;
  * ``transfer/``: the ``make_transfer_p2p`` pretraining pair of each
    domain (radar → radar, lidar → lidar; ngf 32, 4 downsamplings, 3
    scales, 3 blocks, bf16) for ``--pre_epochs``, then ``R2LTransfer``
    with those nets frozen and its lidar encoder warm-started from the
    lidar pair's: ``pretrain_{radar,lidar}.csv``, ``loss_log.csv`` and
    ``cross_decode.png`` (radar → radar E → lidar G, lidar → lidar E →
    radar G).

The CSV columns and ``summary.json``'s keys are the JAX tool's.

    python -m cistar_tpu_torch.tools.quality_run_uda --dataroot D \
        [--size 256] [--epochs 10] [--pre_epochs 4] [--batch 2]

``--out`` defaults to ``chiprun_out/quality_run_uda``. ``--device`` as in
the apps: ``""`` runs on CUDA and raises without a GPU, ``cpu`` on request.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Dict, List

import numpy as np


def _save_strip(path, panels):
    """Stitch [(name, (H, W) or (H, W, 1) array in [-1, 1])] horizontally."""
    from PIL import Image, ImageDraw

    tiles = []
    for name, arr in panels:
        a = np.asarray(arr, np.float32)
        if a.ndim == 3:
            a = a[..., 0]
        a = np.clip((a + 1.0) / 2.0, 0, 1)
        img = Image.fromarray((a * 255).astype("uint8")).convert("RGB")
        ImageDraw.Draw(img).text((4, 4), name, fill=(255, 64, 64))
        tiles.append(img)
    out = Image.new("RGB", (sum(t.width for t in tiles),
                            max(t.height for t in tiles)))
    x = 0
    for t in tiles:
        out.paste(t, (x, 0))
        x += t.width
    out.save(path)


def _write_csv(path, rows):
    if not rows:
        return
    keys = sorted(rows[0])
    with open(path, "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=keys)
        wtr.writeheader()
        wtr.writerows(rows)


def _epoch_row(epoch: int, metrics: List[Dict]) -> Dict:
    """An epoch's row: each metric's mean over its steps (read back once),
    rounded as the JAX tool rounds it."""
    import torch

    names = sorted(metrics[0])
    vals = torch.stack([torch.stack([m[k] for k in names])
                        for m in metrics]).double().cpu().numpy()
    return {"epoch": epoch, **{k: round(float(np.mean(vals[:, i])), 5)
                               for i, k in enumerate(names)}}


def _np(t):
    return t.float().cpu().numpy()


def main(argv=None):
    """Runs the three phases; writes and returns ``summary.json``'s
    contents."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--pre_epochs", type=int, default=4,
                    help="transfer pair pretraining epochs per domain")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out",
                    default=os.path.join("chiprun_out", "quality_run_uda"))
    ap.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                    help="'' runs on CUDA (no GPU raises); cpu on request")
    args = ap.parse_args(argv)

    import torch

    from cistar_tpu_torch.data.datasets import Loader, UDADataset
    from cistar_tpu_torch.device import resolve_device
    from cistar_tpu_torch.engines.extended import R2LAE, R2LImageCritic

    dev = resolve_device(args.device or None)
    bf16 = torch.bfloat16
    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    summary = {"dataroot": args.dataroot, "size": args.size,
               "epochs": args.epochs, "batch": args.batch,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else str(dev))}

    dataset = UDADataset(args.dataroot, size=args.size, mode="train")
    test_set = UDADataset(args.dataroot, size=args.size, mode="test")
    loader = Loader(dataset, args.batch, shuffle=False)
    print(f"UDA train/test split: {len(dataset)}/{len(test_set)} pairs",
          flush=True)
    tb = test_set[0]
    test_radar = torch.from_numpy(tb["radar"][None]).to(dev)
    test_lidar = torch.from_numpy(tb["lidar"][None]).to(dev)

    def batches():
        for b in loader:
            yield (torch.from_numpy(b["radar"]).to(dev),
                   torch.from_numpy(b["lidar"]).to(dev))

    # ---- 1. R2LAE (shared encoder, two decoders, domain classifier) -------
    d = os.path.join(args.out, "ae")
    os.makedirs(d, exist_ok=True)
    eng = R2LAE(size=args.size, n_downsample=3, ngf=16,
                compute_dtype=bf16, device=dev)
    state = eng.init_state(0)
    rows = []
    t0 = time.time()
    for epoch in range(args.epochs):
        ep = []
        for radar, lidar in batches():
            state, m, _ = eng.train_step(state, radar, lidar)
            ep.append(m)
        rows.append(_epoch_row(epoch, ep))
        print(f"[ae] epoch {epoch}: " + ", ".join(
            f"{k}={rows[-1][k]:.4f}" for k in sorted(ep[0])), flush=True)
    _write_csv(os.path.join(d, "loss_log.csv"), rows)
    # R2LAE.infer gives the same-domain reconstructions; the cross
    # decodes swap decoders on the shared encoder's features
    outs = eng.infer(state, test_radar, test_lidar)
    with torch.inference_mode():
        feat = eng.E(torch.cat([test_radar, test_lidar]).to(bf16)).float()
        r2l = eng.G_lidar(feat[:1].to(bf16))
        l2r = eng.G_radar(feat[1:].to(bf16))
    _save_strip(os.path.join(d, "cross_decode.png"),
                [("real_radar", _np(test_radar[0])),
                 ("recon radar->radarG", _np(outs["radar_gen"][0])),
                 ("cross radar->lidarG", _np(r2l[0])),
                 ("real_lidar", _np(test_lidar[0])),
                 ("recon lidar->lidarG", _np(outs["lidar_gen"][0])),
                 ("cross lidar->radarG", _np(l2r[0]))])
    summary["ae"] = {"epochs": args.epochs, "final": rows[-1],
                     "wall_s": round(time.time() - t0, 1)}

    # ---- 2. R2LImageCritic (Wasserstein distance meter) -------------------
    d = os.path.join(args.out, "critic")
    os.makedirs(d, exist_ok=True)
    critic = R2LImageCritic(compute_dtype=torch.float32, device=dev)
    cstate = critic.init_state(1)
    crows = []
    t0 = time.time()
    step = 0
    for epoch in range(args.epochs):
        ep = []
        for radar, lidar in batches():
            cstate, m = critic.train_step(cstate, lidar, radar)
            ep.append(m)
        names = sorted(ep[0])
        vals = torch.stack([torch.stack([m[k] for k in names])
                            for m in ep]).cpu().tolist()
        for v in vals:
            crows.append({"step": step, **{k: round(x, 5) for k, x in
                                           zip(names, v)}})
            step += 1
        print(f"[critic] epoch {epoch}: w_distance="
              f"{crows[-1]['w_distance']:.4f} (lidar_F-radar_F="
              f"{crows[-1]['lidar_F'] - crows[-1]['radar_F']:.4f})",
              flush=True)
    _write_csv(os.path.join(d, "w_distance.csv"), crows)
    summary["critic"] = {"steps": step, "final": crows[-1],
                         "wall_s": round(time.time() - t0, 1)}

    # ---- 3. the transfer pairs, then R2LTransfer ---------------------------
    summary["transfer"] = transfer_phase(args, dev, batches, test_radar,
                                         test_lidar)

    summary["total_wall_s"] = round(time.time() - t_all, 1)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


def transfer_phase(args, dev, batches, test_radar, test_lidar) -> Dict:
    """The transfer pairs' pretraining, then ``R2LTransfer``'s alignment;
    writes ``transfer/`` and returns its summary entry."""
    import torch

    from cistar_tpu_torch.engines.extended import (R2LTransfer,
                                                   make_transfer_p2p)

    bf16 = torch.bfloat16
    d = os.path.join(args.out, "transfer")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()

    def pretrain_pair(domain, seed):
        """A short run of the transfer pair (FeatureEncoder +
        TransferGenerator under the whole pix2pixHD objective) from
        ``domain`` to itself: the nets R2LTransfer freezes."""
        peng = make_transfer_p2p(
            output_nc=1, ngf=32, n_downsampling=4, n_scale=3, n_blocks=3,
            input_nc=1, label_nc=0, no_instance=True, r2l=True,
            image_size=args.size, compute_dtype=bf16, device=dev)
        pstate = peng.init_state(seed, image_size=args.size)
        col = 0 if domain == "radar" else 1
        prow = []
        for epoch in range(args.pre_epochs):
            ep = []
            for pair in batches():
                pstate, m, _ = peng.train_step(pstate, pair[col], None,
                                               pair[col])
                ep.append(m)
            prow.append(_epoch_row(epoch, ep))
            print(f"[pretrain {domain}] epoch {epoch}: "
                  f"loss_G={prow[-1]['loss_G']:.4f} "
                  f"loss_D={prow[-1]['loss_D']:.4f}", flush=True)
        return peng, prow

    rpair, rrows = pretrain_pair("radar", 2)
    lpair, lrows = pretrain_pair("lidar", 3)
    _write_csv(os.path.join(d, "pretrain_radar.csv"), rrows)
    _write_csv(os.path.join(d, "pretrain_lidar.csv"), lrows)

    # the feature map is size / 2^4; the critic needs 2^df_layers at most
    # that (the reference's 5 layers assume 512² → 32² features)
    df_layers = min(5, int(np.log2(max(2, args.size // 16))))
    teng = R2LTransfer(ngf=32, n_downsampling=4, n_scale=3, n_blocks=3,
                       df_layers=df_layers, image_size=args.size,
                       compute_dtype=bf16, device=dev)
    rt, lt = rpair.jax_params(), lpair.jax_params()
    frozen = teng.frozen_from_checkpoints(
        4, radar_e=rt["G"]["E"], radar_g=rt["G"]["G"], lidar_g=lt["G"]["G"],
        net_dr=rt["D"], net_dl=lt["D"])
    tstate = teng.init_state(5)
    # warm-start the trainable lidar encoder from the lidar pair's encoder
    teng.E.load_state_dict(lpair.G.E.state_dict())
    trows = []
    for epoch in range(args.epochs):
        ep = []
        for radar, lidar in batches():
            tstate, m, _ = teng.train_step(tstate, frozen, radar, lidar)
            ep.append(m)
        trows.append(_epoch_row(epoch, ep))
        print(f"[r2ltransfer] epoch {epoch}: " + ", ".join(
            f"{k}={trows[-1][k]:.4f}" for k in sorted(ep[0])), flush=True)
    _write_csv(os.path.join(d, "loss_log.csv"), trows)
    # the cross decodes: radar → radar E → lidar G (the aligned
    # translation), lidar → lidar E → radar G
    with torch.inference_mode():
        rf = frozen["radar_e"](test_radar.to(bf16))
        lf = teng.E(test_lidar.to(bf16))
        radar_trans = frozen["lidar_g"](rf)
        lidar_trans = frozen["radar_g"](lf)
    _save_strip(os.path.join(d, "cross_decode.png"),
                [("real_radar", _np(test_radar[0])),
                 ("radar->lidarG", _np(radar_trans[0])),
                 ("real_lidar", _np(test_lidar[0])),
                 ("lidar->radarG", _np(lidar_trans[0]))])
    return {"pre_epochs": args.pre_epochs, "epochs": args.epochs,
            "pretrain_radar_final": rrows[-1],
            "pretrain_lidar_final": lrows[-1], "final": trows[-1],
            "wall_s": round(time.time() - t0, 1)}


if __name__ == "__main__":
    main()
