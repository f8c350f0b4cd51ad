"""Int8-trunk inference forward of the ResNet generator (counterpart of
``cistar_tpu/models/fast_infer.py::resnet_generator_int8_trunk_apply``).

The stem, the three down convs and the three transpose convs run in the
input's dtype (bf16 on the main path) as plain PyTorch ops; the residual
blocks run through K1 (``int8_carrier="bf16"``, the default) or K2
(``"int8"``) of :mod:`cistar_tpu_torch.ops.quant_int8`; the last stage's
IN+ReLU rides inside the head conv (:mod:`cistar_tpu_torch.ops.head_conv`).

There is no ``expect_kernel`` flag: the kernel path is structural. A CUDA
tensor always goes through the CUDA kernels (or raises), a CPU tensor
through their plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.head_conv import head_conv_tanh_prenorm
from cistar_tpu_torch.ops.quant_int8 import (QBlock, resblock_chain_int8,
                                             resblock_chain_int8_bf16io)


def _stage_in_relu(h: torch.Tensor) -> torch.Tensor:
    """Stage IN+ReLU between the plain segments (``_stage_in_relu``)."""
    return tnn.relu(tnn.instance_norm(h))


def resnet_encode(gen, x: torch.Tensor) -> torch.Tensor:
    """Stem and three down convs, each with IN+ReLU: the trunk's input."""
    h = _stage_in_relu(gen.init_conv(x))
    for m in gen.down:
        h = _stage_in_relu(m(h))
    return h


def resnet_decode(gen, h: torch.Tensor) -> torch.Tensor:
    """Three transpose convs and the head; the last stage's IN+ReLU rides
    inside the head conv."""
    for i, m in enumerate(gen.up):
        h = m(h)
        if i < len(gen.up) - 1:
            h = _stage_in_relu(h)
    mean, rsigma = tnn.instance_norm_stats(h)
    out = gen.out_conv
    return head_conv_tanh_prenorm(h, mean, rsigma, out.weight, out.bias)


def resnet_generator_int8_trunk_apply(gen, qblocks: Sequence[QBlock],
                                      x: torch.Tensor,
                                      int8_carrier: str = "bf16"
                                      ) -> torch.Tensor:
    """Forward of a port :class:`~cistar_tpu_torch.models.cyclegan.
    ResnetGenerator` with its residual trunk in int8. ``qblocks`` comes
    from :func:`~cistar_tpu_torch.ops.quant_int8.quantize_resnet_trunk` of
    the same generator. NHWC in and out, compute dtype of ``x``."""
    if int8_carrier not in ("bf16", "int8"):
        raise ValueError(f"int8_carrier must be 'bf16' or 'int8', "
                         f"got {int8_carrier!r}")
    chain = resblock_chain_int8_bf16io if int8_carrier == "bf16" \
        else resblock_chain_int8
    return resnet_decode(gen, chain(resnet_encode(gen, x), qblocks))
