"""Feature encoding and clustering (counterpart of
``cistar_tpu/apps/encode_features.py``, parity with
``p2pHD/encode_features.py`` and ``p2pHD/precompute_feature_maps.py``).

    python -m cistar_tpu_torch.apps.encode_features --mode maps|cluster \
        --dataroot DIR [--checkpoints_dir C --name N] [--device cpu]

The instance encoder (``Encoder``; its ``{which_epoch}_net_E.npz`` when the
run has one, else random weights from seed 0) runs over the train split of
``Radar2LidarDataset`` (no rotation), one frame at a time, with every pixel
in instance 0. ``--mode maps`` saves each frame's pooled feature map as
``DIR/feat/<name>.npy``. ``--mode cluster`` builds the feature table of
label 0 (the pooled feature at the centre and an area share per frame),
clusters it with :func:`kmeans` into ``--n_clusters`` centres and saves
``{label: (n_clusters, feat_num)}`` as ``features_clustered_NNN.npy`` under
the run, the format ``engines/p2phd.py::sample_features`` reads.

The JAX CLI clusters with scikit-learn's ``KMeans(n_init=10,
random_state=0)``; the port carries its own k-means (k-means++ seeding,
Lloyd iterations, the best of ``n_init``), since the card's machine has no
scikit-learn. ``--platform`` becomes ``--device`` (empty: CUDA).
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.RandomState
               ) -> np.ndarray:
    """k-means++ seeding with ``2 + ln k`` candidates a centre, the
    greedy variant scikit-learn uses."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = [x[rng.randint(n)]]
    closest = ((x - centers[0]) ** 2).sum(1)
    pot = closest.sum()
    for _ in range(1, k):
        ids = np.minimum(np.searchsorted(np.cumsum(closest),
                                         rng.uniform(size=trials) * pot),
                         n - 1)
        d = np.minimum(closest, ((x[None] - x[ids][:, None]) ** 2).sum(-1))
        best = int(d.sum(1).argmin())
        closest, pot = d[best], d[best].sum()
        centers.append(x[ids[best]])
    return np.array(centers)


# scikit-learn's KMeans(n_init=10, random_state=0) and its defaults
N_INIT, SEED, MAX_ITER, TOL = 10, 0, 300, 1e-4


def kmeans(x: np.ndarray, k: int) -> Tuple[np.ndarray, float]:
    """The (k, D) centres of the lowest-inertia of ``N_INIT`` k-means runs
    over the rows of ``x`` (float64) and that inertia (the sum of squared
    distances to the nearest centre). Each run seeds by k-means++ from
    ``RandomState(SEED)``, drawn on in turn, then iterates Lloyd's steps (at
    most ``MAX_ITER``) until the centres move by at most ``TOL`` times the
    mean per-feature variance (squared, summed), as scikit-learn's
    ``KMeans`` does; an empty cluster takes the point farthest from its
    centre."""
    x = np.asarray(x, np.float64)
    rng = np.random.RandomState(SEED)
    tol_abs = float(np.mean(np.var(x, axis=0))) * TOL
    best_c, best_inertia = None, np.inf
    for _ in range(N_INIT):
        c = _kmeans_pp(x, k, rng)
        for _ in range(MAX_ITER):
            d = ((x[:, None] - c[None]) ** 2).sum(-1)
            lab = d.argmin(1)
            far = x[d.min(1).argmax()]
            new = np.array([x[lab == j].mean(0) if (lab == j).any() else far
                            for j in range(k)])
            shift = float(((new - c) ** 2).sum())
            c = new
            if shift <= tol_abs:
                break
        inertia = float(((x[:, None] - c[None]) ** 2).sum(-1).min(1).sum())
        if inertia < best_inertia:
            best_c, best_inertia = c, inertia
    return best_c, best_inertia


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["cluster", "maps"], default="cluster")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--name", default="label2city")
    p.add_argument("--which_epoch", default="latest")
    p.add_argument("--label_nc", type=int, default=35)
    p.add_argument("--feat_num", type=int, default=3)
    p.add_argument("--nef", type=int, default=16)
    p.add_argument("--n_downsample_E", type=int, default=4)
    p.add_argument("--n_clusters", type=int, default=10)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--max_instances", type=int, default=64)
    p.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                   help="'' runs on CUDA (no GPU raises); cpu runs the "
                        "plain ops on the CPU")
    args = p.parse_args(argv)

    import torch

    from cistar_tpu_torch.core import checkpoint as ckpt
    from cistar_tpu_torch.core.convert import (encoder_from_jax,
                                               generator_to_jax)
    from cistar_tpu_torch.data.datasets import Loader, Radar2LidarDataset
    from cistar_tpu_torch.device import resolve_device
    from cistar_tpu_torch.models.pix2pixhd import Encoder

    dev = resolve_device(args.device or None)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        encoder = Encoder(1, args.feat_num, args.nef, args.n_downsample_E)
    save_dir = os.path.join(args.checkpoints_dir, args.name)
    e_path = os.path.join(save_dir, f"{args.which_epoch}_net_E.npz")
    if os.path.exists(e_path):
        params = ckpt.load_network(save_dir, "E", args.which_epoch,
                                   generator_to_jax(encoder.state_dict()))
        encoder.load_state_dict(encoder_from_jax(params))
        print("loaded encoder from", e_path)
    else:
        print("WARNING: no trained encoder found at", e_path, "- random init")
    encoder.to(dev).eval()

    @torch.inference_mode()
    def encode(image: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(image).to(dev)
        inst = torch.zeros(x.shape[:3], dtype=torch.int32, device=dev)
        return encoder(x, inst, args.max_instances).cpu().numpy()

    dataset = Radar2LidarDataset(args.dataroot, size=args.size, mode="train",
                                 rotate=False)
    loader = Loader(dataset, 1)

    if args.mode == "maps":
        out_dir = os.path.join(args.dataroot, "feat")
        os.makedirs(out_dir, exist_ok=True)
        for batch in loader:
            feat = encode(batch["image"])
            name = os.path.splitext(os.path.basename(batch["path"][0]))[0]
            np.save(os.path.join(out_dir, name + ".npy"), feat[0])
            print("saved feature map for", name)
        return out_dir

    # cluster mode: the per-label feature table, then k-means centres
    # (radar datasets have one implicit label 0)
    block_num = 32
    features = {i: np.zeros((0, args.feat_num + 1))
                for i in range(max(1, args.label_nc))}
    for batch in loader:
        feat = encode(batch["image"])[0]
        h, w = feat.shape[:2]
        # one instance: the (constant) pooled feature and an area share
        val = np.zeros((1, args.feat_num + 1))
        val[0, : args.feat_num] = feat[h // 2, w // 2, :]
        val[0, args.feat_num] = float(h * w) / (h * w // block_num)
        features[0] = np.append(features[0], val, axis=0)

    clustered = {}
    for label, table in features.items():
        if table.shape[0] < args.n_clusters:
            continue
        centers, _ = kmeans(table[:, : args.feat_num], args.n_clusters)
        clustered[label] = centers.astype(np.float32)
        print(f"label {label}: clustered {table.shape[0]} samples "
              f"-> {args.n_clusters} centers")
    out = os.path.join(save_dir,
                       f"features_clustered_{args.n_clusters:03d}.npy")
    os.makedirs(save_dir, exist_ok=True)
    np.save(out, clustered, allow_pickle=True)
    print("saved", out)
    return clustered


if __name__ == "__main__":
    main()
