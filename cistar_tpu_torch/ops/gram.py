"""Gram matrices of feature maps, the style statistics of Gatys style
transfer (counterpart of ``cistar_tpu/ops/gram.py``).

``G = F · Fᵀ / (h·w)`` with F the (c, h·w) feature map of one image
(``IST/model/meta_arch/gram_matrix.py:5-11``); in NHWC an (HW, C)ᵀ·(HW, C)
batched matmul. JAX computes it with ``preferred_element_type=float32``,
so bf16 features give an fp32 Gram. A bf16 ``torch.matmul`` would round
its result to bf16, so the features are upcast first: products of bf16
values are exact in fp32, and the two agree to the order of the sums. The
matmul is fp32 and must run with TF32 off (``Precision.HIGHEST`` in JAX):
the Gatys engine sets that around its work.
"""

from __future__ import annotations

import torch


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) features → (N, C, C) Gram matrices over H·W, fp32."""
    n, h, w, c = feat.shape
    f = feat.reshape(n, h * w, c).float()
    # One matmul an image: cuBLAS runs the batched form of this long-K GEMM
    # with a small C×C output in one pass of small tiles, ~20× slower an
    # image (an H100 profile at 4 × 512², relu1_1)
    return torch.stack([fi.t() @ fi for fi in f]) / (h * w)


def gram_mse_losses(feat: torch.Tensor, target_gram: torch.Tensor
                    ) -> torch.Tensor:
    """(N,): each image's mean of ``(Gram(feat) − target)²`` over (C, C)."""
    return (gram_matrix(feat) - target_gram.float()).square().mean(dim=(1, 2))


def gram_mse_loss(feat: torch.Tensor, target_gram: torch.Tensor
                  ) -> torch.Tensor:
    """``GramMSELoss`` (``IST/model/meta_arch/gram_mse_loss.py:5-8``): the
    mean of ``(Gram(feat) − target)²`` over all (N, C, C) elements, as
    ``nn.MSELoss`` takes it; an fp32 scalar."""
    return (gram_matrix(feat) - target_gram.float()).square().mean()
