"""Semantic-label AlignedDataset + shared transform parameters (counterpart
of ``cistar_tpu/data/aligned.py``, a numpy / PIL copy).

Parity with ``p2pHD/data/base_dataset.py:17-91`` and
``p2pHD/data/aligned_dataset.py:13-86``:

  * :func:`get_params` — random crop position + flip coin, decided once per
    sample and shared across label/instance/image (pixel alignment).
  * :func:`get_transform` — resize / scale_width / crop / make-power-of-2 /
    flip / normalize composition; NEAREST resampling for label maps.
  * :class:`AlignedDataset` — ``{phase}_A|_label``, ``{phase}_B|_img``,
    ``{phase}_inst``, ``{phase}_feat`` directory layout; label maps scaled
    ×255 when ``label_nc > 0``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from cistar_tpu_torch.data import transforms as T

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tiff", ".npy")


def make_dataset(directory: str):
    files = []
    for root, _, names in os.walk(directory):
        for n in sorted(names):
            if n.lower().endswith(IMG_EXTS):
                files.append(os.path.join(root, n))
    return sorted(files)


def get_params(opt, size: Tuple[int, int], rng: np.random.RandomState) -> Dict:
    w, h = size
    new_w, new_h = w, h
    if opt.resize_or_crop == "resize_and_crop":
        new_h = new_w = opt.loadSize
    elif opt.resize_or_crop == "scale_width_and_crop":
        new_w = opt.loadSize
        new_h = opt.loadSize * h // w
    x = rng.randint(0, max(0, new_w - opt.fineSize) + 1)
    y = rng.randint(0, max(0, new_h - opt.fineSize) + 1)
    flip = rng.rand() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def apply_transform(opt, img: "Image.Image", params: Dict,
                    method=None, normalize: bool = True) -> np.ndarray:
    """The ``get_transform`` composition applied to one PIL image → HWC array."""
    method = method if method is not None else Image.BICUBIC
    if "resize" in opt.resize_or_crop:
        img = img.resize((opt.loadSize, opt.loadSize), method)
    elif "scale_width" in opt.resize_or_crop:
        if img.size[0] != opt.loadSize:
            w = opt.loadSize
            h = int(opt.loadSize * img.size[1] / img.size[0])
            img = img.resize((w, h), method)
    if "crop" in opt.resize_or_crop:
        x1, y1 = params["crop_pos"]
        tw = th = opt.fineSize
        if img.size[0] > tw or img.size[1] > th:
            img = img.crop((x1, y1, x1 + tw, y1 + th))
    if opt.resize_or_crop == "none":
        base = float(2 ** opt.n_downsample_global)
        if getattr(opt, "netG", "") == "local":
            base *= 2 ** opt.n_local_enhancers
        ow, oh = img.size
        h2 = int(round(oh / base) * base)
        w2 = int(round(ow / base) * base)
        if (h2, w2) != (oh, ow):
            img = img.resize((w2, h2), method)
    if getattr(opt, "isTrain", False) and not getattr(opt, "no_flip", False):
        if params["flip"]:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = T.pil_to_array(img)
    if normalize:
        arr = T.normalize(arr)
    return arr.astype(np.float32)


class AlignedDataset:
    """Label/image/instance/feature tuples with shared crop+flip params."""

    def __init__(self, opt, seed: int = 0):
        self.opt = opt
        self.rng = np.random.RandomState(seed)
        root, phase = opt.dataroot, opt.phase
        dir_a = "_A" if opt.label_nc == 0 else "_label"
        self.a_paths = make_dataset(os.path.join(root, phase + dir_a))
        self.b_paths = []
        if getattr(opt, "isTrain", False) or getattr(opt, "use_encoded_image", False):
            dir_b = "_B" if opt.label_nc == 0 else "_img"
            self.b_paths = make_dataset(os.path.join(root, phase + dir_b))
        self.inst_paths = []
        if not opt.no_instance:
            self.inst_paths = make_dataset(os.path.join(root, phase + "_inst"))
        self.feat_paths = []
        if getattr(opt, "load_features", False):
            self.feat_paths = make_dataset(os.path.join(root, phase + "_feat"))

    def __len__(self):
        n = len(self.a_paths)
        bs = getattr(self.opt, "batchSize", 1)
        return max(bs, n // bs * bs) if n else 0

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        opt = self.opt
        a_path = self.a_paths[index]
        a_img = Image.open(a_path)
        params = get_params(opt, a_img.size, self.rng)
        if opt.label_nc == 0:
            label = apply_transform(opt, a_img.convert("RGB"), params)
        else:
            label = apply_transform(opt, a_img, params, method=Image.NEAREST,
                                    normalize=False) * 255.0

        out: Dict[str, np.ndarray] = {"label": label, "path": a_path}
        out["image"] = np.zeros((1,), np.float32)
        out["inst"] = np.zeros((1,), np.float32)
        out["feat"] = np.zeros((1,), np.float32)

        if self.b_paths:
            b_img = Image.open(self.b_paths[index]).convert("RGB")
            out["image"] = apply_transform(opt, b_img, params)
        if self.inst_paths:
            inst_img = Image.open(self.inst_paths[index])
            out["inst"] = apply_transform(opt, inst_img, params,
                                          method=Image.NEAREST, normalize=False)
        if self.feat_paths:
            feat_img = Image.open(self.feat_paths[index]).convert("RGB")
            out["feat"] = apply_transform(opt, feat_img, params)
        return out
