"""Perceptual distance (LPIPS-style) for output-fidelity checks (counterpart
of ``cistar_tpu/utils/lpips.py``).

The standard LPIPS computation: unit-normalized VGG16 feature differences,
spatially averaged, summed over five layers. Uniform head weights by
default, since the released linear heads are not in the tree;
:func:`load_lpips_heads` reads them from a file when one is given, and
``lpips_distance(..., head_weights=...)`` is then true LPIPS. Without
trained VGG16 weights the backbone is the seeded random one
(``init_vgg_params(VGG16_CONVS, seed=7)``, the JAX package's values bit for
bit), a relative A/B indicator: ``benchmarks/lpips_calibration.json`` ties
its units to the 1e-2 fidelity budget (metric ≈ c·L1² locally).

fp32 throughout, on the inputs' device. Inputs are NHWC in [0, 1], one or
three channels (one is broadcast to three).
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Sequence

import torch

from cistar_tpu_torch.models import vgg as vgg_lib

_LPIPS_KEYS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
# ImageNet normalization (RGB). On [0, 1] inputs it equals the official
# lpips package's ScalingLayer on [-1, 1] inputs (scale / 2 == std,
# (-1 - shift) / scale == -mean / std), so released heads drop straight in.
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _norm_feat(f: torch.Tensor) -> torch.Tensor:
    f = f.float()
    return f * torch.rsqrt(f.square().sum(-1, keepdim=True) + 1e-10)


@functools.lru_cache(maxsize=1)
def _seeded_vgg16() -> vgg_lib.Params:
    return vgg_lib.init_vgg_params(vgg_lib.VGG16_CONVS, seed=7)


def load_lpips_heads(path: str, keys: Sequence[str] = _LPIPS_KEYS
                     ) -> Dict[str, torch.Tensor]:
    """The official ``lpips`` package's linear heads
    (``lpips/weights/v0.1/vgg.pth``: ``lin{i}.model.1.weight`` of shape
    (1, C_i, 1, 1), or the spellings ``lin{i}.1.weight`` /
    ``lins.{i}.model.1.weight``) as ``{relu_key: (C,) fp32}`` for
    :func:`lpips_distance`. Read with ``weights_only=True``; a layer
    without a head raises ``KeyError``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    heads: Dict[str, torch.Tensor] = {}
    for i, k in enumerate(keys):
        for cand in (f"lin{i}.model.1.weight", f"lin{i}.1.weight",
                     f"lins.{i}.model.1.weight"):
            if cand in sd:
                heads[k] = torch.as_tensor(sd[cand]).float().reshape(-1)
                break
        else:
            raise KeyError(f"no linear-head weight for layer {i} ({k}) in "
                           f"{path}; keys: {sorted(sd)[:6]}…")
    return heads


def lpips_distance(a: torch.Tensor, b: torch.Tensor,
                   vgg16_params: Optional[vgg_lib.Params] = None,
                   head_weights: Optional[Dict[str, torch.Tensor]] = None,
                   keys: Sequence[str] = _LPIPS_KEYS) -> torch.Tensor:
    """Perceptual distance between two NHWC images in [0, 1]: (N,) fp32 on
    their device. Without ``vgg16_params`` (HWIO params of
    :mod:`~cistar_tpu_torch.models.vgg`) it warns and takes the seeded
    backbone."""
    if not vgg16_params:
        warnings.warn(
            "lpips_distance: no VGG16 weights supplied — falling back to the "
            "seeded random backbone; distances are relative A/B indicators "
            "only, not comparable to published LPIPS values",
            RuntimeWarning, stacklevel=2)
        vgg16_params = _seeded_vgg16()
    mean = torch.tensor(_MEAN, device=a.device)
    std = torch.tensor(_STD, device=a.device)

    def prep(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        return (x - mean) / std

    # one walk of the stack for both images
    feats = vgg_lib.extract_features(
        vgg16_params, torch.cat([prep(a), prep(b)]), keys,
        forward_seq=vgg_lib.VGG16_FORWARD_SEQ)
    n = a.shape[0]
    total = torch.zeros(n, device=a.device)
    for k, f in zip(keys, feats):
        d = (_norm_feat(f[:n]) - _norm_feat(f[n:])).square()
        if head_weights is not None and k in head_weights:
            d = d * head_weights[k].to(d.device, torch.float32)
            total = total + d.sum(-1).mean((1, 2))
        else:
            total = total + d.mean((1, 2, 3))
    return total
