"""The fidelity budget and metric of the accelerated engines (the port's copy
of ``tools/fidelity_table.py``'s ``BUDGET``, ``make_radar`` and
``_metric``).

Every accelerated engine (bf16, int8) is held to its fp32 forward in the
calibrated LPIPS-style metric of :mod:`.lpips` (uniform heads, the seeded
VGG16; ``benchmarks/lpips_calibration.json`` ties its units to the budget),
with the pixel L1 beside it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cistar_tpu_torch.utils.lpips import lpips_distance

# every accelerated engine within 1e-2 of fp32 (BASELINE.md's north star)
BUDGET = 1e-2


def make_radar(batch: int, size: int, seed: int = 0) -> np.ndarray:
    """Sparse-dot radar-like frames in [-1, 1], (N, H, W, 1) fp32."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, size, size, 1).astype(np.float32)
    return np.where(x > 0.97, x, 0.0) * 2 - 1


def fidelity_metric(ref: torch.Tensor, out: torch.Tensor
                    ) -> Dict[str, float]:
    """The mean LPIPS metric and the pixel L1 of ``out`` against the fp32
    ``ref``, both NHWC in the tanh range, mapped to [0, 1]; computed in fp32
    on their device (the caller turns TF32 off on a GPU)."""
    ref01 = (ref.float() + 1) / 2
    out01 = (out.float() + 1) / 2
    d = lpips_distance(out01, ref01)
    return {"lpips_metric": d.mean().item(),
            "pixel_l1": (out01 - ref01).abs().mean().item()}
