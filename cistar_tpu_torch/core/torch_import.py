"""Read the reference's PyTorch ``.pth`` checkpoints (counterpart of
``cistar_tpu/core/torch_import.py``).

The reference saves one ``state_dict`` a network (``{epoch}_net_{label}.pth``
under ``checkpoints/<name>/``, ``p2pHD/models/base_model.py:42-47``;
``netG_A2B.pth`` …, ``CycleGAN/train.py:281-290``). :func:`load_state_dict`
reads one into numpy, and the weight helpers give the JAX package's
NHWC / HWIO layouts, which the converters of :mod:`.convert_models` build
their trees in:

  * Conv2d weight          OIHW → HWIO
  * ConvTranspose2d weight (in, out, kh, kw) → HWIO (I = in, O = out,
    unflipped)
  * Linear weight          (out, in) → (in, out)

The tolerant partial load of ``base_model.py:50-88`` is
:func:`cistar_tpu_torch.core.checkpoint.merge_partial`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint as a flat ``{key: np.ndarray}`` dict, read on the
    CPU with ``weights_only=True`` (no pickled code runs). A pickled module
    gives its ``state_dict()``; non-tensor values become numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def conv_w(arr: np.ndarray) -> np.ndarray:
    """OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))


def conv_transpose_w(arr: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) → HWIO with I=in, O=out."""
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 0, 1)))


def linear_w(arr: np.ndarray) -> np.ndarray:
    """(out, in) → (in, out)."""
    return np.ascontiguousarray(arr.T)
