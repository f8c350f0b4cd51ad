"""Host-side image transforms (counterpart of ``cistar_tpu/data/
transforms.py``), PIL / numpy in, HWC float arrays out:

  * :func:`load_image`, :func:`pil_to_array` — decode, torchvision
    ``ToTensor`` semantics in HWC;
  * :func:`normalize` / :func:`denormalize` — CycleGAN's
    Normalize(0.5, 0.5) (``CycleGAN/datasets.py:24-57``);
  * :func:`rotate_image` — the shared random rotation of the paired
    datasets (``CycleGAN/datasets.py:50-54``);
  * :func:`array_to_pil` — the way back, for the written images;
  * :class:`GatysImageTransform` — the Caffe-VGG pipeline of
    ``IST/data/image_transform.py:5-31`` and its inverse;
  * :func:`linear_polar` / :func:`pil_polar_transform` — the
    ``cv2.linearPolar`` warps of the IST batch CLI (``IST/main.py:77-98``),
    by numpy bilinear remapping.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def scale_shorter_side(img: "Image.Image", size: int,
                       resample=None) -> "Image.Image":
    """torchvision ``Scale(size)``: resize so the shorter side == size (bilinear)."""
    if resample is None:
        resample = Image.BILINEAR
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(round(size * h / w)))
    else:
        nh, nw = size, max(1, int(round(size * w / h)))
    return img.resize((nw, nh), resample)


def resize_exact(img: "Image.Image", size: Tuple[int, int], resample=None) -> "Image.Image":
    if resample is None:
        resample = Image.BICUBIC
    return img.resize((size[1], size[0]), resample)  # size given (H, W)


def to_gray(img: "Image.Image") -> "Image.Image":
    return img.convert("L")


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


# --------------------------------------------------------------------------- #
# Gatys / Caffe-VGG preprocessing (IST)
# --------------------------------------------------------------------------- #
class GatysImageTransform:
    """Pre/post pipelines for Gatys style transfer.

    ``preparation``: shorter-side resize to ``image_size`` → [0,1] HWC →
    RGB→BGR → subtract ``imagenet_mean`` (BGR order) → ×255.
    ``post_preparation``: inverse, with [0,1] clamping, → PIL image.
    Parity with ``IST/data/image_transform.py:5-31``.
    """

    def __init__(self, image_size: int, imagenet_mean: Sequence[float]):
        self.image_size = image_size
        self.mean = np.asarray(imagenet_mean, np.float32)  # BGR order

    def preparation(self, img: "Image.Image") -> np.ndarray:
        """PIL RGB → (1, H, W, 3) float32, BGR, mean-subtracted, 0..255 scale."""
        img = scale_shorter_side(img, self.image_size)
        arr = pil_to_array(img)             # HWC RGB [0,1]
        arr = arr[:, :, ::-1]               # → BGR
        arr = (arr - self.mean) * 255.0
        return arr[None].astype(np.float32)  # NHWC

    def post_preparation(self, arr: np.ndarray) -> "Image.Image":
        """(1, H, W, 3) or (H, W, 3) BGR 0..255-scale → clamped PIL RGB."""
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        arr = arr / 255.0 + self.mean
        arr = arr[:, :, ::-1]               # BGR → RGB
        arr = np.clip(arr, 0.0, 1.0)
        return array_to_pil(arr)


# --------------------------------------------------------------------------- #
# polar warps (cv2.linearPolar equivalents)
# --------------------------------------------------------------------------- #
def linear_polar(arr: np.ndarray, center: Optional[Tuple[float, float]] = None,
                 max_radius: Optional[float] = None, inverse: bool = False) -> np.ndarray:
    """``cv2.linearPolar`` (WARP_FILL_OUTLIERS) on an HWC/HW uint8 or float array.

    Forward: output (phi_row, rho_col) samples input at
    ``(cx + rho·cos(phi), cy + rho·sin(phi))`` with rho scaled so the full
    width spans ``max_radius`` and phi spanning 2π over the height.
    ``inverse=True`` applies WARP_INVERSE_MAP. Matches the IST batch CLI usage
    where center=(255,255) and max_radius=√((h/2)²+(w/2)²) (``IST/main.py:83-90``).
    """
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    cx, cy = center
    if max_radius is None:
        max_radius = np.sqrt((h / 2.0) ** 2 + (w / 2.0) ** 2)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    if not inverse:
        # dst(phi, rho): sample src at cartesian point
        rho = xx * (max_radius / w)
        phi = yy * (2.0 * np.pi / h)
        xs = cx + rho * np.cos(phi)
        ys = cy + rho * np.sin(phi)
    else:
        # dst(y, x): sample polar src at (phi_row, rho_col)
        dx = xx - cx
        dy = yy - cy
        rho = np.sqrt(dx * dx + dy * dy)
        phi = np.arctan2(dy, dx)
        phi = np.where(phi < 0, phi + 2.0 * np.pi, phi)
        xs = rho * (w / max_radius)
        ys = phi * (h / (2.0 * np.pi))
    out = _bilinear_sample(arr, ys, xs)
    return out[:, :, 0] if squeeze else out


def pil_polar_transform(img: "Image.Image", reverse: bool = False) -> "Image.Image":
    """Drop-in for the reference's ``pil_polar_transform`` (``IST/main.py:77-98``)."""
    arr = np.array(img)
    value = np.sqrt((arr.shape[0] / 2.0) ** 2 + (arr.shape[1] / 2.0) ** 2)
    out = linear_polar(arr, center=(255.0, 255.0), max_radius=value, inverse=reverse)
    return Image.fromarray(np.ascontiguousarray(out))
