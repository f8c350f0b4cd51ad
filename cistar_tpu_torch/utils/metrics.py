"""Loss logging for the trainers, and the test CLIs' image panels and HTML
gallery (counterpart of ``setup_logger``, ``MetricsLogger``,
``HTMLGallery`` and ``save_image_grid`` in ``cistar_tpu/utils/metrics.py``):
running means,
console lines, CSV / JSONL / ``loss_log.npy`` persistence and throughput,
as the reference's visdom ``Logger`` (``CycleGAN/utils.py:13-91``) and the
p2pHD ``Visualizer`` (``p2pHD/util/visualizer.py:14-152``) keep them.

Metrics arrive as device tensors and stay there until a print interval
(``log_every``) or the end of an epoch, when they come to the host in one
copy: a per-step read would make every step wait for the device.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def setup_logger(name: str, save_dir: Optional[str] = None,
                 filename: str = "log.txt") -> logging.Logger:
    """stdout + optional file logger (parity: ``IST/util/logger.py:6-21``)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _to_host(records: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Every tensor of ``records`` to Python floats in one device copy."""
    tensors = [v for rec in records for v in rec.values()
               if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([t.detach().float().reshape(())
                             for t in tensors]).cpu().tolist()
                if tensors else [])
    return [{k: next(host) if isinstance(v, torch.Tensor) else float(v)
             for k, v in rec.items()} for rec in records]


class MetricsLogger:
    """Running-mean loss meter + CSV/JSONL persistence + throughput."""

    def __init__(self, out_dir: str, n_epochs: int, batches_per_epoch: int,
                 start_epoch: int = 0, log_every: int = 50):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.n_epochs = n_epochs
        self.bpe = batches_per_epoch
        self.epoch = start_epoch
        self.batch = 0
        self.log_every = log_every
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._pending: List[Dict[str, Any]] = []
        self.history: List[Dict[str, float]] = []
        self._csv_path = os.path.join(out_dir, "loss_log.csv")
        self._jsonl_path = os.path.join(out_dir, "loss_log.jsonl")
        self._t0 = time.time()
        self._images_seen = 0

    def log(self, losses: Dict[str, Any], n_images: int = 0) -> None:
        """Record one step's losses; device tensors are buffered as they
        are and read at the next print or epoch end."""
        self.batch += 1
        self._images_seen += n_images
        self._pending.append(dict(losses))
        if self.batch % self.log_every == 0:
            self._drain()
            self._print()

    def _drain(self) -> None:
        if not self._pending:
            return
        for rec in _to_host(self._pending):
            for k, v in rec.items():
                self.sums[k] = self.sums.get(k, 0.0) + v
                self.counts[k] = self.counts.get(k, 0) + 1
        self._pending = []

    def means(self) -> Dict[str, float]:
        self._drain()
        return {k: self.sums[k] / max(1, self.counts[k]) for k in self.sums}

    def _print(self) -> None:
        means = self.means()
        elapsed = time.time() - self._t0
        ips = self._images_seen / max(elapsed, 1e-9)
        parts = " ".join(f"{k}: {v:.4f}" for k, v in sorted(means.items()))
        print(f"epoch {self.epoch:03d}/{self.n_epochs:03d} "
              f"batch {self.batch:05d}/{self.bpe:05d} | {parts} | "
              f"{ips:.1f} img/s", flush=True)
        with open(os.path.join(self.out_dir, "live_log.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": self.epoch, "batch": self.batch,
                                "img_per_s": round(ips, 2), **means}) + "\n")

    def end_epoch(self) -> Dict[str, float]:
        means = self.means()
        record = {"epoch": self.epoch, **means}
        self.history.append(record)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        keys = sorted(means.keys())
        header = "epoch," + ",".join(keys)
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                lines = f.read().splitlines()
            if lines and lines[0] != header:
                # metric key set changed (new phase / resumed run): rewrite
                # with the union header so columns never silently misalign
                old_keys = lines[0].split(",")[1:]
                union = sorted(set(old_keys) | set(keys))
                rows = []
                for ln in lines[1:]:
                    vals = dict(zip(old_keys, ln.split(",")[1:]))
                    rows.append(ln.split(",")[0] + ","
                                + ",".join(vals.get(k, "") for k in union))
                keys, header = union, "epoch," + ",".join(union)
                with open(self._csv_path, "w") as f:
                    f.write(header + "\n")
                    for r in rows:
                        f.write(r + "\n")
        else:
            with open(self._csv_path, "w") as f:
                f.write(header + "\n")
        with open(self._csv_path, "a") as f:
            f.write(f"{self.epoch},"
                    + ",".join(f"{means[k]:.6f}" if k in means else ""
                               for k in keys) + "\n")
        np.save(os.path.join(self.out_dir, "loss_log.npy"),
                np.asarray([[r.get(k, np.nan) for k in sorted(means.keys())]
                            for r in self.history]))
        self.sums, self.counts, self.batch = {}, {}, 0
        self.epoch += 1
        return means


class HTMLGallery:
    """HTML image gallery (parity: ``p2pHD/util/html.py:6-63``):
    ``index.html`` in ``web_dir`` over the images in ``web_dir/images``."""

    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows: List[List[tuple]] = []
        self.width = 512

    def add_header(self, text: str) -> None:
        self.rows.append([("__header__", text, "")])

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 512) -> None:
        self.rows.append(list(zip(ims, txts, links)))
        self.width = width

    def save(self) -> None:
        parts = ["<!doctype html><html><head>",
                 f"<title>{self.title}</title>", "</head><body><table>"]
        for row in self.rows:
            if row and row[0][0] == "__header__":
                parts.append(f"<tr><td><h3>{row[0][1]}</h3></td></tr>")
                continue
            parts.append("<tr>" + "".join(
                f'<td style="text-align:center"><p>{txt}</p>'
                f'<a href="images/{link}"><img src="images/{im}" '
                f'width="{self.width}"></a></td>'
                for im, txt, link in row) + "</tr>")
        parts.append("</table></body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write("\n".join(parts))


def save_image_grid(images: Dict[str, np.ndarray], out_path: str,
                    sep_width: int = 5) -> None:
    """Horizontal panel stitch (parity: ``CycleGAN/test.py:20-47``) — images
    are HWC float arrays in [-1, 1] or [0, 1]."""
    from cistar_tpu_torch.data.transforms import array_to_pil, denormalize

    panels = []
    for arr in images.values():
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.min() < -0.01:
            arr = denormalize(arr)
        panels.append(np.clip(arr, 0, 1))
    h, c = panels[0].shape[0], panels[0].shape[2]
    sep = np.ones((h, sep_width, c), np.float32)
    strips = []
    for i, p in enumerate(panels):
        strips.append(p)
        if i != len(panels) - 1:
            strips.append(sep)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    array_to_pil(np.concatenate(strips, axis=1)).save(out_path)
