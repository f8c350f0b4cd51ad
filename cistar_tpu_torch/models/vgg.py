"""The VGG-16 feature extractor of CycleGAN's content loss (counterpart of
the VGG-16 part of ``cistar_tpu/models/vgg.py``; the reference's ``Vgg16``
relu4_3 slice, ``CycleGAN/models.py:184-217``).

As in JAX, a VGG is ``(params, topology)`` and :func:`extract_features` is
a plain function: no module state. Params are a flat dict ``{layer_name:
{"w": HWIO, "b": (C,)}}`` of fp32 tensors, the JAX package's layout, so
:func:`init_vgg_params` gives its weights bit for bit. The weights are not
trained: they are plain tensors, autograd differentiates the image only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cistar_tpu_torch.ops import nn as tnn

Params = Dict[str, Dict[str, torch.Tensor]]

# VGG-16 conv topology: (name, in_channels, out_channels); 3×3 convs, pad 1
VGG16_CONVS: List[Tuple[str, int, int]] = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]

VGG16_FORWARD_SEQ: List[str] = [
    "conv1_1", "conv1_2", "pool_1",
    "conv2_1", "conv2_2", "pool_2",
    "conv3_1", "conv3_2", "conv3_3", "pool_3",
    "conv4_1", "conv4_2", "conv4_3", "pool_4",
    "conv5_1", "conv5_2", "conv5_3", "pool_5",
]

# CycleGAN's content loss compares these features
VGG16_CONTENT_KEY = "relu4_3"


def extract_features(params: Params, x: torch.Tensor,
                     out_keys: Sequence[str], forward_seq: Sequence[str],
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> List[torch.Tensor]:
    """Run the VGG conv stack on NHWC ``x`` (in ``compute_dtype`` when
    given), returning the requested named activations (``convX_Y``,
    ``reluX_Y``, ``pool_N``): ReLU after every conv, 2×2 max pools, and a
    stop as soon as every requested key is produced
    (``extract_features``, with ``frozen=False``)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    wanted = set(out_keys)
    acts: Dict[str, torch.Tensor] = {}
    for name in forward_seq:
        if name.startswith("pool"):
            x = tnn.max_pool2d(x, 2, 2)
            acts[name] = x
        else:
            p = params[name]
            x = tnn.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
            acts[name] = x
            x = tnn.relu(x)
            acts["relu" + name[len("conv"):]] = x
        if wanted.issubset(acts):
            break
    return [acts[k] for k in out_keys]


def init_vgg_params(convs: Sequence[Tuple[str, int, int]], seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> Params:
    """Random (He) weights from ``np.random.RandomState(seed)``, zero
    biases, drawn in the JAX package's order (``init_vgg_params``): the
    same values bit for bit. On the CPU."""
    rng = np.random.RandomState(seed)
    params: Params = {}
    for name, cin, cout in convs:
        std = float(np.sqrt(2.0 / (cin * 9)))
        w = rng.normal(0, std, (3, 3, cin, cout)).astype(np.float32)
        params[name] = {"w": torch.from_numpy(w).to(dtype),
                        "b": torch.zeros(cout, dtype=dtype)}
    return params
