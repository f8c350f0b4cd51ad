"""Perceptual (VGG-feature) losses (counterpart of
``cistar_tpu/losses/perceptual.py``); the two that the trainers take:

  * :func:`make_content_criterion` — CycleGAN ``contentLoss``
    (``CycleGAN/models.py:204-217``): MSE between VGG-16 relu4_3 features
    of prediction and target, with a 1→3 channel broadcast. The reference
    feeds [-1, 1] images straight into torchvision's VGG with **no**
    ImageNet re-normalization; so does this.
  * :func:`make_vgg_loss` — pix2pixHD ``VGGLoss``
    (``p2pHD/models/networks.py:124-136``): weighted L1 over the five
    VGG-19 relu{1..5}_1 slice outputs, weights [1/32, 1/16, 1/8, 1/4, 1].

Pretrained torchvision weights are not in the tree: the criterion takes a
params dict in the JAX package's layout, or draws the JAX package's own
fixed random weights (seed 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cistar_tpu_torch.losses.gan import l1_loss, mse_loss
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


def make_vgg_loss(vgg19_params: Optional[vgg_lib.Params] = None,
                  compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """pix2pixHD VGGLoss: Σᵢ wᵢ · L1(vgg_i(pred), vgg_i(target)) over the
    slices ``VGG19_LOSS_KEYS``, the features in ``compute_dtype``; an fp32
    scalar. The weights (``init_vgg_params(VGG19_CONVS, seed=7)`` unless
    given) are frozen: they are prepared once a device
    (:func:`~cistar_tpu_torch.models.vgg.prepare_params`), and autograd
    differentiates the images only."""
    params = vgg19_params or vgg_lib.init_vgg_params(vgg_lib.VGG19_CONVS,
                                                     seed=7)
    keys = vgg_lib.VGG19_LOSS_KEYS
    on: Dict[torch.device, vgg_lib.Params] = {}

    def features(x: torch.Tensor):
        if x.device not in on:
            on[x.device] = vgg_lib.prepare_params(params, compute_dtype,
                                                  x.device)
        return vgg_lib.features(on[x.device], _to_rgb(x).to(compute_dtype),
                                keys)

    def criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        total = None
        for w, a, b in zip(vgg_lib.VGG19_LOSS_WEIGHTS, features(pred),
                           features(target)):
            term = w * l1_loss(a, b)
            total = term if total is None else total + term
        return total

    return criterion
