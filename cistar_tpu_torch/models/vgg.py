"""VGG feature extractors (counterpart of ``cistar_tpu/models/vgg.py``):

  * the Gatys IST backbone, VGG-19's conv stack walked to the requested
    ReLU / pool activations (``IST/model/meta_arch/vgg.py:5-58``), with the
    bethgelab ``vgg_conv.pth`` layout (:func:`torch_vgg_conv_to_params`);
  * the torchvision ``vgg*.features`` layout
    (:func:`torchvision_vgg_features_to_params`) and the slice ends of
    pix2pixHD's ``VGGLoss`` (``VGG19_LOSS_KEYS``);
  * CycleGAN's content loss, the ``Vgg16`` relu4_3 slice
    (``CycleGAN/models.py:184-217``).

As in JAX, a VGG is ``(params, topology)`` and :func:`extract_features` is
a plain function: no module state. Params are a flat dict ``{layer_name:
{"w": HWIO, "b": (C,)}}`` of fp32 tensors, the JAX package's layout, so
:func:`init_vgg_params` gives its weights bit for bit. The weights are not
trained: they are plain tensors, autograd differentiates the image only,
through cuDNN's backward-data conv. That is the role of JAX's
``conv2d_frozen`` and its custom VJP, which the port needs no counterpart
of. A caller that runs the stack many times prepares its weights once
(:func:`prepare_params`: OIHW, in the compute dtype, on the device) and
walks it with :func:`features`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cistar_tpu_torch.ops import nn as tnn

Params = Dict[str, Dict[str, torch.Tensor]]

# VGG-19 conv topology: (name, in_channels, out_channels); 3×3 convs, pad 1
VGG19_CONVS: List[Tuple[str, int, int]] = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256),
    ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512),
    ("conv4_3", 512, 512), ("conv4_4", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512),
    ("conv5_3", 512, 512), ("conv5_4", 512, 512),
]

VGG19_FORWARD_SEQ: List[str] = [
    "conv1_1", "conv1_2", "pool_1",
    "conv2_1", "conv2_2", "pool_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4", "pool_3",
    "conv4_1", "conv4_2", "conv4_3", "conv4_4", "pool_4",
    "conv5_1", "conv5_2", "conv5_3", "conv5_4", "pool_5",
]

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


def prepare_params(params: Params, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> Params:
    """The weights as :func:`features` takes them: ``w`` OIHW and ``b``,
    both in ``dtype`` (the compute dtype) on ``device``; ``w`` in
    channels_last memory (O, H, W, I), the layout cuDNN's NHWC convs read,
    so a conv copies no weight."""
    return {name: {"w": p["w"].permute(3, 2, 0, 1).to(
                       device, dtype, memory_format=torch.channels_last),
                   "b": p["b"].to(device, dtype)}
            for name, p in params.items()}


def features(prepared: Params, x: torch.Tensor, out_keys: Sequence[str],
             forward_seq: Sequence[str] = VGG19_FORWARD_SEQ
             ) -> List[torch.Tensor]:
    """Walk the conv stack on NHWC ``x`` with weights from
    :func:`prepare_params` (in ``x``'s dtype), returning the requested named
    activations (``convX_Y``, ``reluX_Y``, ``pool_N``): ReLU after every
    conv, 2×2 max pools, and a stop as soon as every requested key is
    produced, so layers past the last one asked for never run."""
    wanted = set(out_keys)
    acts: Dict[str, torch.Tensor] = {}
    for name in forward_seq:
        if name.startswith("pool"):
            x = tnn.max_pool2d(x, 2, 2)
            acts[name] = x
        else:
            p = prepared[name]
            x = tnn.conv2d(x, p["w"], p["b"], padding=1)
            acts[name] = x
            x = tnn.relu(x)
            acts["relu" + name[len("conv"):]] = x
        if wanted.issubset(acts):
            break
    return [acts[k] for k in out_keys]


def extract_features(params: Params, x: torch.Tensor,
                     out_keys: Sequence[str],
                     forward_seq: Sequence[str] = VGG19_FORWARD_SEQ,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> List[torch.Tensor]:
    """``extract_features``: :func:`features` of ``x`` cast to
    ``compute_dtype`` (when given), from HWIO params, which it permutes
    and casts on every call: bf16 convs give bf16 activations, fp32 give
    fp32."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    last = max(list(forward_seq).index(k.replace("relu", "conv"))
               for k in out_keys)
    used = {n: params[n] for n in forward_seq[:last + 1] if n in params}
    return features(prepare_params(used, x.dtype, x.device), x, out_keys,
                    forward_seq)


def init_vgg_params(convs: Sequence[Tuple[str, int, int]] = VGG19_CONVS,
                    seed: int = 0,
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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def torch_vgg_conv_to_params(state_dict: Mapping[str, object]) -> Params:
    """The bethgelab ``vgg_conv.pth`` state dict (``conv1_1.weight`` OIHW,
    ``conv1_1.bias``, as ``IST/main.py:30-32`` loads it) in the params
    layout: OIHW → HWIO (``torch_vgg_conv_to_params``). Other keys are
    skipped."""
    params: Params = {}
    for key, val in state_dict.items():
        if not key.endswith(".weight") and not key.endswith(".bias"):
            continue
        layer, kind = key.rsplit(".", 1)
        t = _f32(val)
        params.setdefault(layer, {})["w" if kind == "weight" else "b"] = (
            t.permute(2, 3, 1, 0).contiguous() if kind == "weight" else t)
    return params


def torchvision_vgg_features_to_params(
        state_dict: Mapping[str, object],
        convs: Sequence[Tuple[str, int, int]]) -> Params:
    """A torchvision ``vgg*.features`` state dict (``features.0.weight`` …
    or ``0.weight`` …) in the params layout: conv indices recovered by
    walking the conv / pool topology, one index for a pool, two for a conv
    and its ReLU (``torchvision_vgg_features_to_params``)."""
    seq = VGG19_FORWARD_SEQ if len(convs) == 16 else VGG16_FORWARD_SEQ
    conv_indices, idx = [], 0
    for name in seq:
        if name.startswith("pool"):
            idx += 1
        else:
            conv_indices.append((idx, name))
            idx += 2
    params: Params = {}
    for i, name in conv_indices:
        for prefix in (f"features.{i}", str(i)):
            wkey, bkey = f"{prefix}.weight", f"{prefix}.bias"
            if wkey in state_dict:
                params[name] = {
                    "w": _f32(state_dict[wkey]).permute(2, 3, 1, 0)
                    .contiguous(),
                    "b": _f32(state_dict[bkey])}
                break
    return params


# Slice ends of pix2pixHD's VGGLoss (torchvision vgg19 feature slices
# [0:2), [2:7), [7:12), [12:21), [21:30); p2pHD/models/networks.py:518-539)
VGG19_LOSS_KEYS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]
VGG19_LOSS_WEIGHTS = [1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]

# CycleGAN's content loss compares these features
VGG16_CONTENT_KEY = "relu4_3"
