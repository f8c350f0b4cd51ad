"""Interactive editing session (counterpart of ``cistar_tpu/engines/ui.py``,
the ``UIModel`` role of ``p2pHD/models/ui_model.py``).

The edits are numpy functions over the (label, instance) maps: change the
clicked object's label, paint label strokes, paste a copied object, and
switch an object's style by painting a cluster centre over its feature-map
region. :class:`EditSession` keeps the current maps and re-synthesizes
through a pix2pixHD engine of the port; a "partial" re-synthesis runs the
whole forward and composites the edited box, dilated by a 64-pixel margin,
as JAX does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def change_label(label: np.ndarray, inst: np.ndarray, click_yx: Tuple[int, int],
                 new_label: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reassign the clicked object's label id, and its instance id under
    the ``label·1000 + k`` convention (ids ≥ 1000 keep their k)."""
    y, x = click_yx
    obj_id = int(inst[y, x])
    mask = inst == obj_id
    label = label.copy()
    inst = inst.copy()
    label[mask] = new_label
    k = obj_id % 1000 if obj_id >= 1000 else 0
    inst[mask] = new_label * 1000 + k if obj_id >= 1000 else new_label
    return label, inst


def add_strokes(label: np.ndarray, inst: np.ndarray, ys: np.ndarray,
                xs: np.ndarray, brush: int, paint_label: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Paint square brush strokes of ``paint_label`` along a point path."""
    label = label.copy()
    inst = inst.copy()
    h, w = label.shape[:2]
    r = brush // 2
    for y, x in zip(np.asarray(ys), np.asarray(xs)):
        y0, y1 = max(0, y - r), min(h, y + r + 1)
        x0, x1 = max(0, x - r), min(w, x + r + 1)
        label[y0:y1, x0:x1] = paint_label
        inst[y0:y1, x0:x1] = paint_label
    return label, inst


def add_object(label: np.ndarray, inst: np.ndarray, obj_label: np.ndarray,
               obj_inst: np.ndarray, top_left: Tuple[int, int], obj_id: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Paste a copied object (its label / instance patch, where the patch's
    instance id is ``obj_id``) with its top-left corner at ``top_left``,
    clipped at the frame's edge."""
    y, x = top_left
    mask = obj_inst == obj_id
    ph, pw = obj_label.shape[:2]
    h, w = label.shape[:2]
    ph = min(ph, h - y)
    pw = min(pw, w - x)
    label = label.copy()
    inst = inst.copy()
    sub_mask = mask[:ph, :pw]
    label[y:y + ph, x:x + pw][sub_mask] = obj_label[:ph, :pw][sub_mask]
    inst[y:y + ph, x:x + pw][sub_mask] = obj_inst[:ph, :pw][sub_mask]
    return label, inst


def set_object_style(feat_map: np.ndarray, inst: np.ndarray, obj_id: int,
                     cluster_centers: np.ndarray, cluster_idx: int
                     ) -> np.ndarray:
    """The feature map with the object's region filled by a cluster centre
    (per-object style switching)."""
    feat = feat_map.copy()
    feat[inst == obj_id] = cluster_centers[cluster_idx]
    return feat


class EditSession:
    """The current (label, inst, feat) maps of one frame and its synthesis
    through ``engine``: a :class:`~cistar_tpu_torch.engines.p2phd.
    Pix2PixHDInference` (``infer_step``), or, with a feature map ``feat``,
    an engine with ``infer_with_features`` (a ``Pix2PixHD`` whose G takes
    features). The engine holds the weights; frames are (H, W[, 1]) numpy
    arrays, outputs (H, W, C) fp32 numpy."""

    def __init__(self, engine, label: np.ndarray,
                 inst: Optional[np.ndarray] = None,
                 feat: Optional[np.ndarray] = None):
        self.engine = engine
        self.label = np.asarray(label)
        self.inst = (np.asarray(inst) if inst is not None
                     else np.zeros(self.label.shape[:2], np.int32))
        self.feat = feat
        self.current = self.synthesize()

    def synthesize(self) -> np.ndarray:
        label = torch.from_numpy(np.ascontiguousarray(self.label))[None]
        if label.dim() == 3:
            label = label[..., None]
        inst = torch.from_numpy(np.ascontiguousarray(self.inst))[None, ...,
                                                                 None]
        if self.feat is not None:
            # style-conditioned synthesis: set_object_style edits reach the
            # output through the feature channels (ui_model.py:230-298)
            feat = torch.from_numpy(np.ascontiguousarray(self.feat))[None]
            out = self.engine.infer_with_features(label, inst, feat)
        else:
            out = self.engine.infer_step(label, inst)
        return out[0].cpu().numpy()

    def set_style(self, obj_id: int, cluster_centers: np.ndarray,
                  cluster_idx: int) -> np.ndarray:
        """Paint the cluster centre over the object's feature-map region and
        re-synthesize; the session needs a feature map."""
        if self.feat is None:
            raise ValueError("EditSession has no feature map; construct with "
                             "feat= to enable style edits")
        self.feat = set_object_style(self.feat, self.inst, obj_id,
                                     cluster_centers, cluster_idx)
        self.current = self.synthesize()
        return self.current

    def apply(self, fn, *args,
              region: Optional[Tuple[int, int, int, int]] = None,
              **kw) -> np.ndarray:
        """Run an edit ``fn(label, inst, *args, **kw)``, re-synthesize, and
        composite only ``region`` (y0, x0, y1, x1), dilated by a 64-pixel
        receptive-field margin, into the current image (all of it without
        a region)."""
        result = fn(self.label, self.inst, *args, **kw)
        if isinstance(result, tuple):
            self.label, self.inst = result
        else:
            self.label = result
        new = self.synthesize()
        if region is None:
            self.current = new
        else:
            y0, x0, y1, x1 = region
            margin = 64
            h, w = new.shape[:2]
            y0, x0 = max(0, y0 - margin), max(0, x0 - margin)
            y1, x1 = min(h, y1 + margin), min(w, x1 + margin)
            self.current = self.current.copy()
            self.current[y0:y1, x0:x1] = new[y0:y1, x0:x1]
        return self.current
