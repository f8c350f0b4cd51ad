"""The trainers' datasets and the batching loader (counterpart of
``cistar_tpu/data/datasets.py::CycleGANImageDataset``,
``Radar2LidarDataset`` and ``Loader``). They yield NHWC float32 numpy
arrays.

  * :class:`CycleGANImageDataset` ↔ ``CycleGAN/datasets.py:10-63``: paired
    ``{root}/radar/*.png`` + ``{root}/lidar/*.png`` dirs; train = first
    50%, test = last 10%; unaligned random B sampling; shared random
    rotation ±45° in train; Grayscale → ToTensor → Normalize(0.5, 0.5).
  * :class:`Radar2LidarDataset` ↔ ``p2pHD/data/aligned_dataset.py`` (r2l
    branch): paired radar / lidar PNG or NPY, resized to ``size``², a
    shared random rotation 0–360° in train, Normalize(0.5, 0.5), a 70/30
    train / test split.
  * :class:`UDADataset` ↔ the aligned dataset's UDA branch: pairs named by
    ``timestamp.txt``, the first 30% for train.

:class:`Loader` batches, in order or shuffled anew each epoch, with
a background prefetch thread; the caller moves each batch to the device
(the training CLIs copy it from pinned memory without blocking). The
native C++ PNG loader of the JAX package, and with it the loader's
``get_batch`` path, ``NativeCycleGANDataset`` and ``make_cyclegan_dataset``
are not ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cistar_tpu_torch.data import transforms as T


def _list_pngs(d: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, "*.png")))


class CycleGANImageDataset:
    """Unpaired radar/lidar dataset with the reference's exact split policy."""

    def __init__(self, root: str, size: Optional[int] = None, unaligned: bool = False,
                 mode: str = "train", seed: int = 0):
        self.files_a = _list_pngs(os.path.join(root, "radar"))
        self.files_b = _list_pngs(os.path.join(root, "lidar"))
        split = int(len(self.files_a) * 0.5)
        test = int(len(self.files_a) * 0.9)
        if mode == "train":
            self.files_a = self.files_a[:split]
            self.files_b = self.files_b[:split]
        else:
            self.files_a = self.files_a[test:]
            self.files_b = self.files_b[test:]
        self.unaligned = unaligned
        self.mode = mode
        self.size = size
        self.rng = np.random.RandomState(seed)
        # Decoded-image memo: rotate/normalize always allocate fresh
        # arrays, so sharing is safe.
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_budget = 1 << 30  # 1 GiB across both streams

    def __len__(self) -> int:
        return max(len(self.files_a), len(self.files_b))

    def _load(self, path: str) -> np.ndarray:
        hit = self._cache.get(path)
        if hit is None:
            hit = self._load_uncached(path)
            if self._cache_bytes + hit.nbytes <= self._cache_budget:
                self._cache[path] = hit
                self._cache_bytes += hit.nbytes
        return hit

    def _load_uncached(self, path: str) -> np.ndarray:
        img = T.load_image(path, mode="L")
        if self.size is not None and img.size != (self.size, self.size):
            img = img.resize((self.size, self.size))
        return T.pil_to_array(img)  # HWC [0,1]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item_a = self._load(self.files_a[index % len(self.files_a)])
        name_a = os.path.basename(self.files_a[index % len(self.files_a)])
        if self.unaligned:
            j = self.rng.randint(0, len(self.files_b))
        else:
            j = index % len(self.files_b)
        item_b = self._load(self.files_b[j])
        if self.mode == "train":
            angle = self.rng.randint(-45, 46)  # shared rotation, both frames
            item_a = T.rotate_image(item_a, angle)
            item_b = T.rotate_image(item_b, angle)
        item_a = T.normalize(item_a)
        item_b = T.normalize(item_b)
        return {"A": item_a.astype(np.float32), "B": item_b.astype(np.float32),
                "name": name_a}


class Radar2LidarDataset:
    """p2pHD ``Radar2LidarDataset``: paired radar (label) → lidar (image).

    PNG or NPY inputs, resized to ``size``²; a shared random rotation
    0–360° in train (unless ``rotate`` is false), drawn from
    ``RandomState(0)``; Normalize(0.5, 0.5); 70/30 train/test split
    (``p2pHD/data/aligned_dataset.py`` r2l path). Decoded frames are kept,
    up to 1 GiB, so later epochs only augment.
    """

    def __init__(self, root: str, size: int = 512, mode: str = "train",
                 rotate: bool = True):
        self.radar = _list_pngs(os.path.join(root, "radar")) or sorted(
            glob.glob(os.path.join(root, "radar", "*.npy")))
        self.lidar = _list_pngs(os.path.join(root, "lidar")) or sorted(
            glob.glob(os.path.join(root, "lidar", "*.npy")))
        split = int(len(self.radar) * 0.7)
        if mode == "train":
            self.radar, self.lidar = self.radar[:split], self.lidar[:split]
        else:
            self.radar, self.lidar = self.radar[split:], self.lidar[split:]
        self.size, self.mode, self.rotate = size, mode, rotate
        self.rng = np.random.RandomState(0)
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_budget = 1 << 30  # 1 GiB across both streams

    def __len__(self) -> int:
        return len(self.radar)

    def _load(self, path: str) -> np.ndarray:
        hit = self._cache.get(path)
        if hit is None:
            hit = self._load_uncached(path)
            if self._cache_bytes + hit.nbytes <= self._cache_budget:
                self._cache[path] = hit
                self._cache_bytes += hit.nbytes
        return hit

    def _load_uncached(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            arr = np.load(path).astype(np.float32)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.max() > 1.5:
                arr = arr / 255.0
        else:
            arr = T.pil_to_array(T.load_image(path, mode="L"))
        if arr.shape[0] != self.size or arr.shape[1] != self.size:
            img = T.array_to_pil(arr)
            arr = T.pil_to_array(img.resize((self.size, self.size)))
        return arr

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        radar = self._load(self.radar[index])
        lidar = self._load(self.lidar[index])
        if self.mode == "train" and self.rotate:
            angle = self.rng.randint(0, 360)
            radar = T.rotate_image(radar, angle)
            lidar = T.rotate_image(lidar, angle)
        return {
            "label": T.normalize(radar).astype(np.float32),
            "image": T.normalize(lidar).astype(np.float32),
            "inst": np.zeros((1,), np.float32),
            "feat": np.zeros((1,), np.float32),
            "path": self.radar[index],
        }


class UDADataset:
    """p2pHD ``UDADataset``: radar / lidar pairs named by the lines of
    ``{root}/timestamp.txt`` (``radar/<stamp>.png``), else the sorted PNGs
    of ``radar/`` and ``lidar/``; the first 30% for train, the rest for
    test; grayscale, resized to ``size``² by PIL's default filter where
    they differ, Normalize(0.5, 0.5)."""

    TRAIN_FRAC = 0.3

    def __init__(self, root: str, size: int = 512, mode: str = "train"):
        ts_file = os.path.join(root, "timestamp.txt")
        if os.path.exists(ts_file):
            with open(ts_file) as f:
                stamps = [line.strip() for line in f if line.strip()]
            self.radar = [os.path.join(root, "radar", s + ".png")
                          for s in stamps]
            self.lidar = [os.path.join(root, "lidar", s + ".png")
                          for s in stamps]
        else:
            self.radar = _list_pngs(os.path.join(root, "radar"))
            self.lidar = _list_pngs(os.path.join(root, "lidar"))
        split = int(len(self.radar) * self.TRAIN_FRAC)
        if mode == "train":
            self.radar, self.lidar = self.radar[:split], self.lidar[:split]
        else:
            self.radar, self.lidar = self.radar[split:], self.lidar[split:]
        self.size = size

    def __len__(self) -> int:
        return len(self.radar)

    def _load(self, path: str) -> np.ndarray:
        arr = T.pil_to_array(T.load_image(path, mode="L"))
        if arr.shape[0] != self.size:
            arr = T.pil_to_array(T.array_to_pil(arr).resize(
                (self.size, self.size)))
        return T.normalize(arr).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {"radar": self._load(self.radar[index]),
                "lidar": self._load(self.lidar[index]),
                "path": self.radar[index]}


class Loader:
    """Batching iterator with deterministic shuffling and background
    prefetch.

    The replacement for torch ``DataLoader(num_workers=N)``
    (``CycleGAN/train.py:160-161``,
    ``p2pHD/data/custom_dataset_data_loader.py``): a host thread assembles
    NHWC batches ahead of the step, so the step never waits on PNG decode.
    With ``shuffle`` each epoch (each iteration over the loader) takes the
    order of ``RandomState(epoch)``, as the JAX loader's at its default
    seed. The last batch may be short.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 prefetch: int = 2):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle, self.epoch = shuffle, 0
        self.prefetch = prefetch

    def __len__(self) -> int:
        return (len(self.ds) + self.bs - 1) // self.bs

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(idx)
        return idx

    def _collate(self, items: Sequence[Dict]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            if isinstance(vals[0], str):
                out[key] = vals  # type: ignore[assignment]
            else:
                out[key] = np.stack(vals, axis=0)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [idx[i:i + self.bs] for i in range(0, len(idx), self.bs)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            # An exception in __getitem__/decode must reach the consumer —
            # swallowing it would silently truncate the epoch.
            try:
                for b in batches:
                    q.put(self._collate([self.ds[int(i)] for i in b]))
            except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
                q.put(("error", exc))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "error":
                raise item[1]
            yield item
        self.epoch += 1
