"""GAN objectives: LSGAN / BCE / WGAN-GP (counterpart of
``cistar_tpu/losses/gan.py``).

Parity targets:
  * CycleGAN: plain ``nn.MSELoss`` against 1/0 targets (``CycleGAN/train.py:115``),
    GAN term weighted ×10 (``train.py:202,208``).
  * p2pHD ``GANLoss``: LSGAN (MSE) or BCE-with-sigmoid, handling multiscale
    list-of-list predictions (``p2pHD/models/networks.py:80-122``).
  * WGAN gradient penalty (``networks.py:718-739``).

All losses are pure functions on tensors returning fp32 scalars.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def bce_with_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = pred.float(), target.float()
    return torch.mean(torch.clamp(p, min=0) - p * t
                      + torch.log1p(torch.exp(-torch.abs(p))))


def lsgan_loss(pred: torch.Tensor, is_real: bool) -> torch.Tensor:
    """MSE against a constant 1.0 (real) / 0.0 (fake) target."""
    target = torch.ones_like(pred) if is_real else torch.zeros_like(pred)
    return mse_loss(pred, target)


Preds = Union[torch.Tensor, Sequence[Any]]


def gan_loss(preds: Preds, is_real: bool, use_lsgan: bool = True
             ) -> torch.Tensor:
    """p2pHD ``GANLoss``: accepts a tensor, a list of tensors, or a list of
    per-scale lists (taking the last element of each inner list — the final
    discriminator output; intermediate entries are feature-matching taps)."""
    def fn(p, r):
        if use_lsgan:
            return lsgan_loss(p, r)
        return bce_with_logits(p, torch.ones_like(p) if r
                               else torch.zeros_like(p))

    if isinstance(preds, (list, tuple)):
        total = None
        for p in preds:
            if isinstance(p, (list, tuple)):
                p = p[-1]
            total = fn(p, is_real) if total is None else total + fn(p, is_real)
        return total
    return fn(preds, is_real)


def energy_reg(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Energy regularizer (``CycleGAN/train.py:45-50``): L1 between the total
    "point energy" of fake and real frames mapped back to [0, 1]."""
    e_fake = torch.sum((fake.float() + 1) / 2)
    e_real = torch.sum(real.float() * 0.5 + 0.5)
    return torch.abs(e_fake - e_real)


def count_points(images: torch.Tensor, mesh=None) -> torch.Tensor:
    """Radar point count per frame (``CycleGAN/train.py:52-59``): threshold
    the [-1, 1] NHWC batch at 0.5 after mapping it to [0, 1], count, and
    divide by batch · channels. A device scalar: the train step compares it
    with ``min_points`` without a host sync. With ``mesh`` (data
    parallelism) ``images`` is this rank's slice and the count is the
    global batch's: the ranks' sums added, over the global batch size."""
    from cistar_tpu_torch.parallel import sharding

    img = images.float() * 0.5 + 0.5
    binary = (img > 0.5).float()
    n, _, _, c = images.shape
    size = mesh.size if mesh is not None and mesh.grouped else 1
    return sharding.all_reduce_sum(torch.sum(binary), mesh) / (n * size * c)


def gradient_penalty_at(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                        real: torch.Tensor, fake: torch.Tensor,
                        eps: torch.Tensor, lam: float = 10.0) -> torch.Tensor:
    """WGAN-GP at the interpolates ``eps · real + (1 − eps) · fake`` for
    given ``eps`` of shape (N, 1, 1, 1): (‖∇D(x̂)‖₂ − 1)² · λ, batch mean.
    The gradient keeps its graph, so the penalty trains the critic."""
    inter = eps * real.float() + (1 - eps) * fake.float()
    if not inter.requires_grad:
        inter.requires_grad_(True)
    grads, = torch.autograd.grad(critic_fn(inter).float().sum(), inter,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=(1, 2, 3)) + 1e-12)
    return torch.mean(torch.square(norms - 1.0)) * lam


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     generator: torch.Generator, lam: float = 10.0
                     ) -> torch.Tensor:
    """WGAN-GP (``p2pHD/models/networks.py:718-739``) at random interpolates,
    ``eps`` ~ U[0, 1) per image drawn from ``generator`` (on ``real``'s
    device); see :func:`gradient_penalty_at`."""
    eps = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                     device=real.device)
    return gradient_penalty_at(critic_fn, real, fake, eps, lam)
