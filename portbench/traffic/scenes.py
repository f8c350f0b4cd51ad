"""Radar / lidar scene pairs drawn from a seed: a frozen copy of the
arithmetic of the repo's `tools/make_synthetic_r2l.py` (walls, arcs and
blobs drawn crisp for the lidar, widened, blurred, faded with range,
speckled, floored and cut by dropout sectors for the radar).

`ring` turns them into the frames a run serves: NHWC float32 in [-1, 1],
one scene seed per frame from the run's seed."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFilter


def _scene_strokes(rng: np.random.RandomState, size: int):
    strokes = []
    for _ in range(rng.randint(4, 9)):  # walls
        p0 = rng.uniform(0.1, 0.9, 2) * size
        ang = rng.uniform(0, 2 * np.pi)
        ln = rng.uniform(0.15, 0.6) * size
        p1 = p0 + ln * np.array([np.cos(ang), np.sin(ang)])
        strokes.append(("line", (*p0, *p1)))
    for _ in range(rng.randint(1, 4)):  # arcs
        c = rng.uniform(0.2, 0.8, 2) * size
        r = rng.uniform(0.08, 0.3) * size
        a0 = rng.uniform(0, 360)
        strokes.append(("arc", (c[0] - r, c[1] - r, c[0] + r, c[1] + r,
                                a0, a0 + rng.uniform(40, 200))))
    for _ in range(rng.randint(2, 6)):  # point-like obstacles
        c = rng.uniform(0.1, 0.9, 2) * size
        r = rng.uniform(1.5, 4.0) * size / 512
        strokes.append(("blob", (c[0] - r, c[1] - r, c[0] + r, c[1] + r)))
    return strokes


def _render(strokes, size: int, width: int) -> np.ndarray:
    img = Image.new("L", (size, size), 0)
    d = ImageDraw.Draw(img)
    for kind, xy in strokes:
        if kind == "line":
            d.line(xy, fill=255, width=width)
        elif kind == "arc":
            d.arc(xy[:4], xy[4], xy[5], fill=255, width=width)
        else:
            d.ellipse(xy, fill=255)
    return np.asarray(img, np.float32) / 255.0


def make_pair(seed: int, size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """(radar, lidar) float32 arrays in [0, 1] for scene ``seed``."""
    rng = np.random.RandomState(seed)
    strokes = _scene_strokes(rng, size)
    w = max(1, size // 512)
    lidar = _render(strokes, size, width=w)
    radar = _render(strokes, size, width=4 * w)
    radar = np.asarray(
        Image.fromarray((radar * 255).astype(np.uint8)).filter(
            ImageFilter.GaussianBlur(1.5 * w)), np.float32) / 255.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    rr = np.hypot(yy - size / 2, xx - size / 2) / (size / 2)
    radar *= np.clip(1.25 - 0.8 * rr, 0.15, 1.0)          # radial falloff
    radar *= rng.gamma(4.0, 0.25, radar.shape).astype(np.float32)  # speckle
    radar += rng.uniform(0.02, 0.06) * rng.rand(*radar.shape)      # floor
    theta = np.arctan2(yy - size / 2, xx - size / 2)
    for _ in range(rng.randint(0, 3)):                     # dropout sectors
        a = rng.uniform(-np.pi, np.pi)
        radar *= np.where(np.abs(np.angle(np.exp(1j * (theta - a))))
                          < rng.uniform(0.05, 0.2), 0.2, 1.0).astype(np.float32)
    return np.clip(radar, 0, 1), lidar


def ring(seed: int, frames: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """``frames`` distinct scenes for run seed ``seed``: radar and lidar,
    each (frames, size, size, 1) float32 in [-1, 1]."""
    seeds = np.random.SeedSequence(seed).generate_state(frames)
    pairs = [make_pair(int(s), size) for s in seeds]
    radar = np.stack([p[0] for p in pairs])[..., None] * 2.0 - 1.0
    lidar = np.stack([p[1] for p in pairs])[..., None] * 2.0 - 1.0
    return radar.astype(np.float32), lidar.astype(np.float32)
