"""Int8-trunk inference forwards of the CycleGAN generators (counterpart of
``cistar_tpu/models/fast_infer.py``).

  * :func:`resnet_generator_int8_trunk_apply` (ResNet, 'p2p*'): the stem,
    the three down convs and the three transpose convs run in the input's
    dtype (bf16 on the main path) as plain PyTorch ops; the residual blocks
    run through K1 (``int8_carrier="bf16"``, the default) or K2 (``"int8"``).
  * :func:`bilinear_generator_int8_trunk_apply` (``MultiscaleBilinear``,
    'bilinear*'): the encoder stages that the JAX engine's routing rule
    sends to its stage kernel run through K6, the others in the input's
    dtype; the atrous residual blocks run through K5; the decoder's
    upsample + conv is one low-resolution conv per stage.

Both end in the head conv with the last stage's IN+ReLU inside it
(:mod:`cistar_tpu_torch.ops.head_conv`). The kernels are those of
:mod:`cistar_tpu_torch.ops.quant_int8`.

There is no ``expect_kernel`` flag: the kernel path is structural. A CUDA
tensor always goes through the CUDA kernels (or raises), a CPU tensor
through their plain versions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.head_conv import head_conv_tanh_prenorm
from cistar_tpu_torch.ops.quant_int8 import (QBlock,
                                             atrous_resblock_chain_int8,
                                             atrous_stage_fits,
                                             multi_atrous_stage_int8,
                                             quantize_atrous_resblock,
                                             quantize_multi_atrous_stage,
                                             resblock_chain_int8,
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


def _head(gen, h: torch.Tensor) -> torch.Tensor:
    """The head conv on the last stage's raw output, its IN+ReLU inside."""
    mean, rsigma = tnn.instance_norm_stats(h)
    out = gen.out_conv
    return head_conv_tanh_prenorm(h, mean, rsigma, out.weight, out.bias)


def resnet_decode(gen, h: torch.Tensor) -> torch.Tensor:
    """Three transpose convs and the head; the last stage's IN+ReLU rides
    inside the head conv."""
    for i, m in enumerate(gen.up):
        h = m(h)
        if i < len(gen.up) - 1:
            h = _stage_in_relu(h)
    return _head(gen, h)


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


# --------------------------------------------------------------------------- #
# MultiscaleBilinearGenerator ('bilinear*')
# --------------------------------------------------------------------------- #
QTrunk = Dict[str, List[QBlock]]


def stage_kernel_fits(h: torch.Tensor, qstage: QBlock) -> bool:
    """The JAX engine's rule (``fast_infer.py::_stage_kernel_fits``): an
    encoder stage runs in int8 (K6) when ``atrous_stage_fits`` says its
    post-stride shape fits the TPU kernel's VMEM, else in the input's
    dtype. At 512² that is stage 2 only; at 256², stages 1 and 2."""
    _, hh, ww, c = h.shape
    return atrous_stage_fits(hh // 2, ww // 2, c, qstage["wbq"].shape[-1])


def _q_parts(qtrunk: Union[QTrunk, Sequence[QBlock]]
             ) -> Tuple[Sequence[QBlock], Optional[Sequence[QBlock]]]:
    """(res blocks, encoder stages or None) of a quantized trunk: the dict
    of :func:`quantize_bilinear_trunk`, or a bare list of res blocks, which
    keeps every encoder stage in the input's dtype (``_q_parts``)."""
    if isinstance(qtrunk, dict):
        return qtrunk["res"], qtrunk.get("enc")
    return qtrunk, None


def quantize_bilinear_trunk(gen) -> QTrunk:
    """Quantize a port ``MultiscaleBilinearGenerator``: its atrous res
    blocks (``res``) and its encoder stages (``enc``)
    (``quantize_bilinear_trunk``)."""
    return {"res": [quantize_atrous_resblock(b) for b in gen.res],
            "enc": [quantize_multi_atrous_stage(s) for s in gen.down]}


def bilinear_generator_int8_trunk_apply(gen, qtrunk: Union[QTrunk,
                                                           Sequence[QBlock]],
                                        x: torch.Tensor) -> torch.Tensor:
    """Forward of a port ``MultiscaleBilinearGenerator`` with its atrous
    trunk in int8 (K5) and its encoder stages in int8 (K6) where the JAX
    engine's routing rule puts them; the decoder runs in ``x``'s dtype
    (``bilinear_generator_int8_trunk_apply``). NHWC in and out."""
    qres, qenc = _q_parts(qtrunk)
    h = _stage_in_relu(gen.init_conv(x))
    skips = []
    for i, stage in enumerate(gen.down):
        if qenc is not None and stage_kernel_fits(h, qenc[i]):
            h = multi_atrous_stage_int8(h, qenc[i], stage.rates, stage.stride)
        else:
            h = stage(h)
        skips.append(h)
    return bilinear_decode(gen, atrous_resblock_chain_int8(h, qres), skips)


def bilinear_decode(gen, h: torch.Tensor, skips: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """The decoder of a ``MultiscaleBilinearGenerator`` from the trunk's
    output ``h`` and the encoder outputs ``skips``: each stage's upsample +
    conv as one low-resolution conv (``upconv2x_bilinear``), then the head,
    with the last stage's IN+ReLU inside it."""
    for i, (up, skip) in enumerate(zip(gen.up, reversed(skips))):
        conv = up.conv
        h = tnn.upconv2x_bilinear(torch.cat([h, skip], dim=-1), conv.weight,
                                  conv.bias)
        if i < len(gen.up) - 1:
            h = _stage_in_relu(h)
    return _head(gen, h)
