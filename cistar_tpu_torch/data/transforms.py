"""Host-side image transforms for the CycleGAN dataset (counterpart of the
part of ``cistar_tpu/data/transforms.py`` that it needs), PIL / numpy in,
HWC float arrays out:

  * :func:`load_image`, :func:`pil_to_array` — decode, torchvision
    ``ToTensor`` semantics in HWC;
  * :func:`normalize` / :func:`denormalize` — CycleGAN's
    Normalize(0.5, 0.5) (``CycleGAN/datasets.py:24-57``);
  * :func:`rotate_image` — the shared random rotation of the paired
    datasets (``CycleGAN/datasets.py:50-54``);
  * :func:`array_to_pil` — the way back, for the written images.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_image(path: str, mode: str = "RGB") -> "Image.Image":
    img = Image.open(path)
    if mode:
        img = img.convert(mode)
    return img


def pil_to_array(img: "Image.Image") -> np.ndarray:
    """PIL → float32 HWC in [0, 1] (torchvision ``ToTensor`` semantics, HWC)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def array_to_pil(arr: np.ndarray) -> "Image.Image":
    """float HWC in [0,1] → PIL (uint8). Single-channel arrays become mode L."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), 0.0, 1.0)
    arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    return Image.fromarray(arr)


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """torch ``Normalize(mean, std)`` on a [0,1] array → roughly [-1, 1]."""
    return (arr - mean) / std


def denormalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    return arr * std + mean


_ROTATE_GRID_CACHE: dict = {}


def rotate_image(arr: np.ndarray, degrees: float, bilinear: bool = False) -> np.ndarray:
    """Rotate an HWC array about its center, zero-filled corners.

    Matches torchvision ``functional.rotate`` defaults (nearest interpolation,
    expand=False) used for the shared radar/lidar augmentation
    (``CycleGAN/datasets.py:50-54``). Counter-clockwise for positive angles.
    """
    h, w = arr.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = np.deg2rad(degrees)
    cos, sin = np.cos(theta), np.sin(theta)
    grid = _ROTATE_GRID_CACHE.get((h, w))
    if grid is None:
        grid = np.mgrid[0:h, 0:w].astype(np.float32)
        _ROTATE_GRID_CACHE[(h, w)] = grid
    yy, xx = grid
    # inverse map: output (y,x) -> input coords (rotate by -theta about center)
    xs = cos * (xx - cx) + sin * (yy - cy) + cx
    ys = -sin * (xx - cx) + cos * (yy - cy) + cy
    if bilinear:
        return _bilinear_sample(arr, ys, xs)
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros_like(arr)
    out[valid] = arr[yi[valid], xi[valid]]
    return out


def _bilinear_sample(arr: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    h, w = arr.shape[:2]
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]

    def _at(yi, xi):
        yi_c = np.clip(yi, 0, h - 1)
        xi_c = np.clip(xi, 0, w - 1)
        vals = arr[yi_c, xi_c].astype(np.float32)
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        return vals * inside

    out = (
        _at(y0, x0) * (1 - wx) * (1 - wy)
        + _at(y0, x1) * wx * (1 - wy)
        + _at(y1, x0) * (1 - wx) * wy
        + _at(y1, x1) * wx * wy
    )
    return out.astype(arr.dtype) if arr.dtype != np.uint8 else np.clip(out, 0, 255).astype(np.uint8)
