"""Semantic-label visualization (counterpart of ``cistar_tpu/utils/label_viz.py``,
a numpy copy; ``p2pHD/util/util.py:26-100`` parity).

``labelcolormap``/``colorize``/``tensor2label`` turn integer or one-hot label
maps into the cityscapes-style color images the reference shows in its HTML
galleries (``util/visualizer.py`` via ``tensor2label``). NHWC/numpy-native;
the 35-class table is the cityscapes palette, other N use the bit-reversal
procedural map — both byte-identical to the reference's tables.
"""

from __future__ import annotations

import numpy as np

_CITYSCAPES_35 = np.array(
    [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (111, 74, 0),
     (81, 0, 81), (128, 64, 128), (244, 35, 232), (250, 170, 160),
     (230, 150, 140), (70, 70, 70), (102, 102, 156), (190, 153, 153),
     (180, 165, 180), (150, 100, 100), (150, 120, 90), (153, 153, 153),
     (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35),
     (152, 251, 152), (70, 130, 180), (220, 20, 60), (255, 0, 0),
     (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
     (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142)], dtype=np.uint8)


def labelcolormap(n: int) -> np.ndarray:
    """(N, 3) uint8 palette; N=35 is the cityscapes table, otherwise the
    bit-interleaved procedural map (``util/util.py:52-76``)."""
    if n == 35:
        return _CITYSCAPES_35.copy()
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(7):
            r ^= ((idx >> 0) & 1) << (7 - j)
            g ^= ((idx >> 1) & 1) << (7 - j)
            b ^= ((idx >> 2) & 1) << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    return cmap


def colorize(label: np.ndarray, n: int = 35) -> np.ndarray:
    """Integer label map (H, W) or (H, W, 1) → (H, W, 3) uint8 color image
    (``util/util.py:78-92`` ``Colorize``). Ids ≥ n render black."""
    label = np.asarray(label)
    if label.ndim == 3:
        label = label[..., 0]
    ids = label.astype(np.int64)
    cmap = labelcolormap(n)
    out = np.zeros((*ids.shape, 3), np.uint8)
    valid = (ids >= 0) & (ids < n)
    out[valid] = cmap[ids[valid]]
    return out


def tensor2label(label: np.ndarray, n_label: int) -> np.ndarray:
    """NHWC-less single-image variant of ``util/util.py:27-35``: a one-hot
    (H, W, C>1) map is argmaxed over channels first; ``n_label == 0`` falls
    back to grayscale scaling (r2l mode has no semantic labels)."""
    label = np.asarray(label)
    if n_label == 0:
        img = np.clip(label * 255.0, 0, 255).astype(np.uint8)
        return img[..., 0] if img.ndim == 3 else img
    if label.ndim == 3 and label.shape[-1] > 1:
        label = np.argmax(label, axis=-1)
    return colorize(label, n_label)
