"""Perceptual (VGG-feature) losses (counterpart of
``cistar_tpu/losses/perceptual.py``); so far the one the CycleGAN trainer
takes:

  * :func:`make_content_criterion` — CycleGAN ``contentLoss``
    (``CycleGAN/models.py:204-217``): MSE between VGG-16 relu4_3 features
    of prediction and target, with a 1→3 channel broadcast. The reference
    feeds [-1, 1] images straight into torchvision's VGG with **no**
    ImageNet re-normalization; so does this.

Pretrained torchvision weights are not in the tree: the criterion takes a
params dict in the JAX package's layout, or draws the JAX package's own
fixed random weights (seed 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cistar_tpu_torch.losses.gan import mse_loss
from cistar_tpu_torch.models import vgg as vgg_lib


def _to_rgb(x: torch.Tensor) -> torch.Tensor:
    """1-channel → 3-channel broadcast (torch ``expand([-1,3,-1,-1])``)."""
    if x.shape[-1] == 1:
        return x.expand(*x.shape[:-1], 3)
    return x


def make_content_criterion(vgg16_params: Optional[vgg_lib.Params] = None,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> Callable:
    """CycleGAN content loss: MSE of VGG-16 relu4_3 features, computed in
    ``compute_dtype``; an fp32 scalar. The weights follow the images to
    their device (one copy a device)."""
    params = vgg16_params or vgg_lib.init_vgg_params(vgg_lib.VGG16_CONVS,
                                                     seed=7)
    on: Dict[torch.device, vgg_lib.Params] = {}

    def features(x: torch.Tensor) -> torch.Tensor:
        if x.device not in on:
            on[x.device] = {k: {n: t.to(x.device) for n, t in v.items()}
                            for k, v in params.items()}
        return vgg_lib.extract_features(
            on[x.device], _to_rgb(x), (vgg_lib.VGG16_CONTENT_KEY,),
            vgg_lib.VGG16_FORWARD_SEQ, compute_dtype)[0]

    def criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return mse_loss(features(pred), features(target))

    return criterion
