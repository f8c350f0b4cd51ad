"""Fused-kernel and int8-trunk inference forwards of the CycleGAN and
pix2pixHD generators (counterpart of ``cistar_tpu/models/fast_infer.py``).

  * :func:`resnet_generator_fast_apply` / :func:`global_generator_fast_apply`:
    the bf16 fast forwards, each residual block as two K3 calls
    (:func:`~cistar_tpu_torch.ops.fused.fused_conv3x3_in_act`), where the
    JAX rule puts K3 (it reads the weights' dtype: at ResNet-9 width only a
    module with bf16 weights runs K3).
  * :func:`resnet_generator_int8_trunk_apply` (ResNet, 'p2p*'): the stem,
    the three down convs and the three transpose convs run in the input's
    dtype (bf16 on the main path) as plain PyTorch ops; the residual blocks
    run through K1 (``int8_carrier="bf16"``, the default) or K2 (``"int8"``).
  * :func:`bilinear_generator_int8_trunk_apply` (``MultiscaleBilinear``,
    'bilinear*'): the encoder stages that the JAX engine's routing rule
    sends to its stage kernel run through K6, the others in the input's
    dtype; the atrous residual blocks run through K5; the decoder's
    upsample + conv is one low-resolution conv per stage.
  * :func:`multiscale_generator_int8_trunk_apply` (``MultiscaleGenerator``
    / ``MultiscaleDenseDecoderGenerator``, 'atrous*'): the bilinear
    engine's encoder (K6 where the rule puts it), the residual trunk
    through K1, the transpose-conv decoder (dense, or the four dilated
    branches) in the input's dtype.
  * :func:`unet_generator_int8_trunk_apply` (``UnetGenerator``, 'unet*'):
    the strided-conv encoder and the decoder in the input's dtype, the
    residual trunk through K1.

All end in :func:`_head_conv_tanh`: by default the head conv with the
last stage's IN+ReLU inside it (:mod:`cistar_tpu_torch.ops.head_conv`),
or, after the non-dense 'atrous' decoder, whose last stage ends in its
own ReLU, the head conv alone.

  * :func:`global_generator_int8_trunk_apply` (pix2pixHD
    ``GlobalGenerator``): the resnet trunk runs through K1 where the JAX
    engine's rule (``whole_image_resblock_fits``) takes the whole-image
    chain, else through K7 (the 1024-channel trunk of the default width);
  * :func:`unet_msrb_int8_apply` (``UNetGeneratorHD``): the MSRB blocks
    run through K8, the three 7×7 stride-2 downs through K10
    (:func:`unet_down`);
  * :func:`local_enhancer_int8_apply` (``LocalEnhancer``): the global
    trunk's resnet blocks dispatch as ``global``'s (K7 at the suite's
    1024² config), the enhancer's blocks run as plain ops.

These take their 7×7 stem and head through ``conv2d_reflect_thin``, and
the rest in the input's dtype. They record their segments as the spans
``g.encode``, ``g.trunk`` and ``g.decode``
(:mod:`cistar_tpu_torch.runtime.spans`), as their plain forwards do;
``local`` records its fine stream (the enhancers and the head) as
``g.enhance`` after them.

  * :func:`multiscale_global_int8_apply` (``MultiscaleGlobalGenerator``,
    BatchNorm): the resnet trunk runs through the ``bn=True`` form of K1
    or K7, its BatchNorm folded into the int8 scales; the stems, fuse convs
    and ups apply the running-stats affine (:func:`_bn_affine`), with
    ``conv2d_reflect`` for the stems and the head.

The kernels are those of :mod:`cistar_tpu_torch.ops.quant_int8`.

Two switches, read once at import from the environment as in JAX
(``fast_infer.py:38-39``); tests and ``chip_smoke.py`` set the module
attributes and restore them:

  * ``CISTAR_FUSED_STAGE_IN=1`` (``_FUSED_STAGE_IN``): the ResNet engine's
    stage IN+ReLU (:func:`_stage_in_relu`) goes through K4 where the JAX
    rule puts it: at 256² in bf16, down_1, down_2 and up_0. The other
    engines call the plain IN, as in JAX.
  * ``CISTAR_HEAD_KERNEL`` (``_HEAD_KERNEL``, one of ``_HEAD_VARIANTS``):
    ``tap_matmul`` / ``loop`` / ``maskedloop`` / ``masked`` run the head of
    the CycleGAN engines through K9 (after a separate stage IN+ReLU where
    the head takes a raw stage output); ``shift`` and ``xla`` are the JAX
    package's plain heads.

There is no ``expect_kernel`` flag: the kernel path is structural. A CUDA
tensor always goes through the CUDA kernels (or raises), a CPU tensor
through their plain versions.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.fused import (conv2d_reflect_cout1_loop,
                                        conv2d_reflect_cout1_masked,
                                        fused_conv3x3_in_act,
                                        fused_instance_norm_act)
from cistar_tpu_torch.ops.head_conv import (head_conv_tanh_pallas,
                                            head_conv_tanh_prenorm,
                                            head_conv_tanh_shift)
from cistar_tpu_torch.ops.quant_int8 import (QBlock,
                                             atrous_resblock_chain_int8,
                                             atrous_stage_fits,
                                             msrb_block_int8,
                                             multi_atrous_stage_int8,
                                             quantize_atrous_resblock,
                                             quantize_msrb,
                                             quantize_multi_atrous_stage,
                                             quantize_resblock,
                                             quantize_resblock_bn,
                                             resblock_chain_int8,
                                             resblock_chain_int8_bf16io,
                                             resblock_chain_int8_tiled,
                                             whole_image_resblock_fits)
from cistar_tpu_torch.runtime import spans


_FUSED_STAGE_IN = os.environ.get("CISTAR_FUSED_STAGE_IN", "")
_HEAD_KERNEL = os.environ.get("CISTAR_HEAD_KERNEL", "")

#: The head variants of ``_head_conv_tanh`` (``fast_infer.py:63-64``).
_HEAD_VARIANTS = ("", "shift", "xla", "tap_matmul", "loop", "maskedloop",
                  "masked")


def _in_relu(h: torch.Tensor) -> torch.Tensor:
    """relu(IN(h)) in ``h``'s dtype, where JAX calls
    ``tnn.relu(tnn.instance_norm(h))``."""
    return tnn.relu(tnn.instance_norm(h))


def _stage_in_relu(h: torch.Tensor) -> torch.Tensor:
    """Stage IN+ReLU of the ResNet engine and of the head's non-default
    variants (``_stage_in_relu``): through K4 (where it fits) under
    ``_FUSED_STAGE_IN == "1"``, else :func:`_in_relu`."""
    if _FUSED_STAGE_IN == "1":
        return fused_instance_norm_act(h, act="relu")
    return _in_relu(h)


def _head_conv_tanh(h: torch.Tensor, conv, raw_in: bool = False
                    ) -> torch.Tensor:
    """Final 7×7 reflect conv → 1 channel + tanh, by ``_HEAD_KERNEL``
    (``_head_conv_tanh``). ``raw_in``: ``h`` is the last stage's raw conv
    output, its IN+ReLU still pending; the default variant takes it inside
    the head conv, the others apply :func:`_stage_in_relu` first."""
    variant = _HEAD_KERNEL
    if variant not in _HEAD_VARIANTS:
        raise ValueError(
            f"CISTAR_HEAD_KERNEL={variant!r} is not a known head-conv "
            f"variant; valid values: {', '.join(v for v in _HEAD_VARIANTS if v)}")
    w, b = conv.weight, conv.bias
    is7 = w.shape[2] == 7 and w.shape[0] == 1
    div8 = h.shape[1] % 8 == 0 and h.shape[2] % 8 == 0
    if raw_in:
        if variant == "" and is7 and div8 and h.shape[1] > 16 \
                and h.shape[2] > 16:
            mean, rsigma = tnn.instance_norm_stats(h)
            return head_conv_tanh_prenorm(h, mean, rsigma, w, b)
        h = _stage_in_relu(h)
    if variant in ("loop", "maskedloop", "masked") and is7:
        fn = conv2d_reflect_cout1_masked if variant == "masked" \
            else conv2d_reflect_cout1_loop
        return fn(h, w, b, act="tanh")
    if variant == "tap_matmul" and is7:
        return head_conv_tanh_pallas(h, w, b, act="tanh")
    if variant in ("", "shift") and is7 and div8:
        return head_conv_tanh_shift(h, w, b, act="tanh")
    return tnn.tanh(tnn.conv2d_reflect(h, w, b))


def _fused_res_trunk(blocks, h: torch.Tensor) -> torch.Tensor:
    """Residual blocks as two K3 calls each: conv 1 + IN + ReLU, then
    conv 2 + IN + the skip."""
    for blk in blocks:
        c1, c2 = blk.conv1, blk.conv2
        r = fused_conv3x3_in_act(h, c1.weight, c1.bias, act="relu",
                                 pad_mode="reflect")
        h = fused_conv3x3_in_act(r, c2.weight, c2.bias, act="none",
                                 residual=h, pad_mode="reflect")
    return h


def resnet_generator_fast_apply(gen, x: torch.Tensor) -> torch.Tensor:
    """Fast forward of a port ``ResnetGenerator`` with its residual blocks
    in K3 (``resnet_generator_fast_apply``). NHWC in and out, ``x.dtype``;
    K3 runs where the JAX rule puts it, which at ResNet-9 width needs bf16
    weights (``gen.bfloat16()``)."""
    h = _in_relu(gen.init_conv(x))
    for m in gen.down:
        h = _in_relu(m(h))
    h = _fused_res_trunk(gen.res, h)
    for m in gen.up:
        h = _in_relu(m(h))
    return tnn.tanh(gen.out_conv(h))


def global_generator_fast_apply(gen, x: torch.Tensor) -> torch.Tensor:
    """Fast forward of a port ``GlobalGenerator`` with its resnet blocks in
    K3 (``global_generator_fast_apply``). At the CLI defaults (a 1024-
    channel trunk) the weights alone exceed the JAX rule, so every block
    runs the composition, on a TPU as on the card."""
    tr = gen.trunk
    h = _in_relu(tr.stem.conv(x))
    for m in tr.down:
        h = _in_relu(m.conv(h))
    h = _fused_res_trunk(tr.res, h)
    for m in tr.up:
        h = _in_relu(m.convt(h))
    return tnn.tanh(gen.head.conv(h))


def resnet_encode(gen, x: torch.Tensor) -> torch.Tensor:
    """Stem and three down convs, each with the stage IN+ReLU: the trunk's
    input."""
    h = _stage_in_relu(gen.init_conv(x))
    for m in gen.down:
        h = _stage_in_relu(m(h))
    return h


def resnet_decode(gen, h: torch.Tensor) -> torch.Tensor:
    """Three transpose convs and the head; the last stage's IN+ReLU is left
    to the head (``raw_in``)."""
    for i, m in enumerate(gen.up):
        h = m(h)
        if i < len(gen.up) - 1:
            h = _stage_in_relu(h)
    return _head_conv_tanh(h, gen.out_conv, raw_in=True)


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


def atrous_encode(gen, qenc: Optional[Sequence[QBlock]], x: torch.Tensor
                  ) -> List[torch.Tensor]:
    """Stem and ``MultiAtrousConv`` encoder of a ``MultiscaleBilinear`` /
    ``Multiscale*`` generator as their int8 engines run it: each stage
    through K6 where :func:`stage_kernel_fits` (``qenc`` not None), else in
    ``x``'s dtype. The stage outputs: the skips, the last of which is the
    trunk's input."""
    h = _in_relu(gen.init_conv(x))
    skips = []
    for i, stage in enumerate(gen.down):
        if qenc is not None and stage_kernel_fits(h, qenc[i]):
            h = multi_atrous_stage_int8(h, qenc[i], stage.rates, stage.stride)
        else:
            h = stage(h)
        skips.append(h)
    return skips


def bilinear_generator_int8_trunk_apply(gen, qtrunk: Union[QTrunk,
                                                           Sequence[QBlock]],
                                        x: torch.Tensor) -> torch.Tensor:
    """Forward of a port ``MultiscaleBilinearGenerator`` with its atrous
    trunk in int8 (K5) and its encoder stages in int8 (K6) where the JAX
    engine's routing rule puts them; the decoder runs in ``x``'s dtype
    (``bilinear_generator_int8_trunk_apply``). NHWC in and out."""
    qres, qenc = _q_parts(qtrunk)
    skips = atrous_encode(gen, qenc, x)
    return bilinear_decode(gen, atrous_resblock_chain_int8(skips[-1], qres),
                           skips)


def bilinear_decode(gen, h: torch.Tensor, skips: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """The decoder of a ``MultiscaleBilinearGenerator`` from the trunk's
    output ``h`` and the encoder outputs ``skips``: each stage's upsample +
    conv as one low-resolution conv (``upconv2x_bilinear``), then the head
    on the last stage's raw output (``raw_in``)."""
    for i, (up, skip) in enumerate(zip(gen.up, reversed(skips))):
        conv = up.conv
        h = tnn.upconv2x_bilinear(torch.cat([h, skip], dim=-1), conv.weight,
                                  conv.bias)
        if i < len(gen.up) - 1:
            h = _in_relu(h)
    return _head_conv_tanh(h, gen.out_conv, raw_in=True)


# --------------------------------------------------------------------------- #
# MultiscaleGenerator / MultiscaleDenseDecoderGenerator ('atrous*') and
# UnetGenerator ('unet*')
# --------------------------------------------------------------------------- #
def quantize_multiscale_trunk(gen) -> QTrunk:
    """Quantize a port ``MultiscaleGenerator`` /
    ``MultiscaleDenseDecoderGenerator``: its residual blocks (``res``, K1)
    and its encoder stages (``enc``, K6) (``quantize_multiscale_trunk``)."""
    return {"res": [quantize_resblock(b) for b in gen.res],
            "enc": [quantize_multi_atrous_stage(s) for s in gen.down]}


def quantize_unet_trunk(gen) -> List[QBlock]:
    """Quantize the residual blocks of a port ``UnetGenerator``
    (``quantize_unet_trunk``): its strided-conv encoder has no stage
    kernel."""
    return [quantize_resblock(b) for b in gen.res]


def _dense(gen) -> bool:
    """True for a decoder of ``_UpBlock`` stages (the dense 'atrous'
    decoder and 'unet'), False for ``MultiAtrousTransposeConv`` stages."""
    return hasattr(gen.up[0], "convt")


def strided_encode(gen, x: torch.Tensor) -> List[torch.Tensor]:
    """Stem and strided-conv encoder of a ``UnetGenerator``, each stage with
    its IN+ReLU, in ``x``'s dtype: the skips, the last of which is the
    trunk's input."""
    h = _in_relu(gen.init_conv(x))
    skips = []
    for m in gen.down:
        h = m(h)
        skips.append(h)
    return skips


def convt_up(gen, h: torch.Tensor, skips: Sequence[torch.Tensor]
             ) -> torch.Tensor:
    """The transpose-conv decoder of a ``Multiscale*`` or ``UnetGenerator``
    from the trunk's output ``h`` and the encoder outputs ``skips``, each
    stage on ``cat([h, skip])``. Dense: ConvT with IN+ReLU on every stage
    but the last, whose raw output the head normalizes. Not dense: each
    ``MultiAtrousTransposeConv`` whole (branch IN, concat, ReLU)."""
    dense = _dense(gen)
    for i, (up, skip) in enumerate(zip(gen.up, reversed(skips))):
        h = torch.cat([h, skip], dim=-1)
        if not dense:
            h = up(h)
            continue
        h = up.convt(h)
        if i < len(gen.up) - 1:
            h = _in_relu(h)
    return h


def convt_head(gen, h: torch.Tensor) -> torch.Tensor:
    """The head on :func:`convt_up`'s output: ``raw_in`` after a dense
    decoder, not after the ``MultiAtrousTransposeConv`` one."""
    return _head_conv_tanh(h, gen.out_conv, raw_in=_dense(gen))


def convt_decode(gen, h: torch.Tensor, skips: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """:func:`convt_up` then :func:`convt_head`."""
    return convt_head(gen, convt_up(gen, h, skips))


def multiscale_generator_int8_trunk_apply(gen, qtrunk: Union[
        QTrunk, Sequence[QBlock]], x: torch.Tensor) -> torch.Tensor:
    """Forward of a port ``MultiscaleDenseDecoderGenerator`` or
    ``MultiscaleGenerator`` with its encoder stages in int8 (K6) where the
    JAX engine's routing rule puts them and its residual trunk in int8
    (K1); the decoder runs in ``x``'s dtype
    (``multiscale_generator_int8_trunk_apply``). JAX's ``dense_decoder``
    argument is the generator's class here (:func:`convt_decode`).
    ``qtrunk`` comes from :func:`quantize_multiscale_trunk` (a bare list of
    res blocks keeps the encoder in ``x``'s dtype). NHWC in and out.

    JAX's chain takes its kernel where ``whole_image_resblock_fits``, else
    its emulation of the same math; K1 runs that math at every shape it
    takes (C and H·W multiples of 128), so the port calls it at each."""
    qres, qenc = _q_parts(qtrunk)
    skips = atrous_encode(gen, qenc, x)
    return convt_decode(gen, resblock_chain_int8_bf16io(skips[-1], qres),
                        skips)


def unet_generator_int8_trunk_apply(gen, qtrunk: Union[QTrunk,
                                                       Sequence[QBlock]],
                                    x: torch.Tensor) -> torch.Tensor:
    """Forward of a port ``UnetGenerator`` with its residual trunk in int8
    (K1); the encoder and the decoder run in ``x``'s dtype, and so do the
    skips (``unet_generator_int8_trunk_apply``). ``qtrunk`` comes from
    :func:`quantize_unet_trunk`. NHWC in and out."""
    qres, _ = _q_parts(qtrunk)
    skips = strided_encode(gen, x)
    return convt_decode(gen, resblock_chain_int8_bf16io(skips[-1], qres),
                        skips)


# --------------------------------------------------------------------------- #
# pix2pixHD: GlobalGenerator ('global') and UNetGeneratorHD ('UNet')
# --------------------------------------------------------------------------- #
def _thin(conv, x: torch.Tensor) -> torch.Tensor:
    return tnn.conv2d_reflect_thin(x, conv.weight, conv.bias)


def trunk_encode(trunk, x: torch.Tensor) -> torch.Tensor:
    """A ``GlobalGeneratorTrunk``'s stem (``conv2d_reflect_thin``) and
    downs, each with IN+ReLU: its resnet blocks' input."""
    h = _in_relu(_thin(trunk.stem.conv, x))
    for m in trunk.down:
        h = m(h)
    return h


def global_encode(gen, x: torch.Tensor) -> torch.Tensor:
    """:func:`trunk_encode` of a ``GlobalGenerator``: the trunk's input."""
    return trunk_encode(gen.trunk, x)


def global_trunk_int8(h: torch.Tensor, qblocks: Sequence[QBlock],
                      cout_tile: Optional[int] = None, bn: bool = False
                      ) -> torch.Tensor:
    """The resnet trunk in int8: the whole-image chain (K1) where
    ``whole_image_resblock_fits``, else the cout-tiled chain (K7); ``bn``:
    their BatchNorm forms."""
    if whole_image_resblock_fits(h.shape[1], h.shape[2], h.shape[3]):
        return resblock_chain_int8_bf16io(h, qblocks, bn)
    return resblock_chain_int8_tiled(h, qblocks, cout_tile, bn)


def global_decode(gen, h: torch.Tensor) -> torch.Tensor:
    """The ups with IN+ReLU, then the head (``conv2d_reflect_thin``) and
    tanh."""
    for m in gen.trunk.up:
        h = m(h)
    return tnn.tanh(_thin(gen.head.conv, h))


def global_generator_int8_trunk_apply(gen, qblocks: Sequence[QBlock],
                                      x: torch.Tensor,
                                      cout_tile: Optional[int] = None
                                      ) -> torch.Tensor:
    """Forward of a port ``GlobalGenerator`` with its resnet trunk in int8
    (``global_generator_int8_trunk_apply``). ``qblocks`` comes from
    :func:`~cistar_tpu_torch.ops.quant_int8.quantize_global_trunk`;
    ``cout_tile=None`` takes K7's tile as the JAX kernel path does. NHWC
    in and out, compute dtype of ``x``."""
    with spans.span("g.encode"):
        h = global_encode(gen, x)
    with spans.span("g.trunk"):
        h = global_trunk_int8(h, qblocks, cout_tile)
    with spans.span("g.decode"):
        return global_decode(gen, h)


def quantize_unet_msrb(gen) -> List[QBlock]:
    """Quantize the MSRB trunk of a port ``UNetGeneratorHD``
    (``quantize_unet_msrb``)."""
    return [quantize_msrb(m) for m in gen.msrb]


def unet_down(conv, h: torch.Tensor) -> torch.Tensor:
    """One 7×7 stride-2 pad-3 down of the UNet (``conv``, a ``Conv2d``)
    through ``cistar::conv7x7s2_bf16``: on the CPU its plain version, the
    module's own conv; on the card K10, which raises on a dtype or shape
    it does not take (:func:`~cistar_tpu_torch.kernels.conv_s2.shape_ok`).
    The bf16 (Cout, 49·Cin) weight is packed anew each call."""
    cout = conv.weight.shape[0]
    # (Cout, 7, 7, Cin) in memory: the kernel's (Cout, 49·Cin) operand
    w = conv.weight.to(h.dtype, memory_format=torch.channels_last)
    wk = w.permute(0, 2, 3, 1).reshape(cout, -1)
    return torch.ops.cistar.conv7x7s2_bf16(h.contiguous(), wk, conv.bias)


def unet_encode(gen, x: torch.Tensor) -> List[torch.Tensor]:
    """The stem (``conv2d_reflect_thin``) and the three downs
    (:func:`unet_down`), each with IN+ReLU: the skips, the last of which is
    the trunk's input."""
    h = _in_relu(_thin(gen.init_block.conv, x))
    skips = []
    for conv in gen.down_conv:
        h = _in_relu(unet_down(conv, h))
        skips.append(h)
    return skips


def unet_decode(gen, h: torch.Tensor, skips: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """The ups on the skip concats, with IN+ReLU, then the head
    (``conv2d_reflect_thin``) and tanh."""
    for convt, skip in zip(gen.up_convt, reversed(skips)):
        h = _in_relu(convt(torch.cat([h, skip], dim=-1)))
    return tnn.tanh(_thin(gen.output_layer.conv, h))


def unet_msrb_int8_apply(gen, qblocks: Sequence[QBlock], x: torch.Tensor,
                         cout_tile: int = 128) -> torch.Tensor:
    """Forward of a port ``UNetGeneratorHD`` with its MSRB blocks in int8
    (K8; ``unet_msrb_int8_apply``), its downs through K10. ``qblocks``
    comes from :func:`quantize_unet_msrb`. NHWC in and out, compute dtype of
    ``x``."""
    with spans.span("g.encode"):
        skips = unet_encode(gen, x)
    with spans.span("g.trunk"):
        h = skips[-1]
        for q in qblocks:
            h = msrb_block_int8(h, q, cout_tile)
    with spans.span("g.decode"):
        return unet_decode(gen, h, skips)


# --------------------------------------------------------------------------- #
# pix2pixHD: LocalEnhancer ('local') and MultiscaleGlobalGenerator
# ('multiscale', BatchNorm)
# --------------------------------------------------------------------------- #
def quantize_local_enhancer(gen) -> List[QBlock]:
    """Quantize the global trunk's resnet blocks of a port
    ``LocalEnhancer`` (``quantize_local_enhancer``)."""
    return [quantize_resblock(b) for b in gen.global_trunk.res]


def local_decode(gen, h: torch.Tensor, pyr: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """The global trunk's ups (span ``g.decode``), then the fine stream
    (span ``g.enhance``): each enhancer on its level of the input pyramid
    ``pyr`` (its stem through ``conv2d_reflect_thin``, its down, the sum
    with the coarser output, its resnet blocks as plain ops, its up), the
    head (``conv2d_reflect_thin``) and tanh."""
    with spans.span("g.decode"):
        for m in gen.global_trunk.up:
            h = m(h)
    with spans.span("g.enhance"):
        ne = gen.n_local_enhancers
        for n in range(1, ne + 1):
            d = _in_relu(_thin(gen.enhancer(n, "stem").conv, pyr[ne - n]))
            h = gen.enhancer(n, "down")(d) + h
            for i in range(gen.n_blocks_local):
                h = gen.enhancer(n, f"res_{i}")(h)
            h = gen.enhancer(n, "up")(h)
        return tnn.tanh(_thin(gen.head.conv, h))


def local_enhancer_int8_apply(gen, qblocks: Sequence[QBlock],
                              x: torch.Tensor,
                              cout_tile: Optional[int] = None
                              ) -> torch.Tensor:
    """Forward of a port ``LocalEnhancer`` with its global trunk's resnet
    blocks in int8 (``local_enhancer_int8_apply``), dispatched as
    :func:`global_trunk_int8`; ``qblocks`` from
    :func:`quantize_local_enhancer`. NHWC in and out, compute dtype of
    ``x``. The pyramid's pools lie outside the spans."""
    pyr = gen.pyramid(x)
    with spans.span("g.encode"):
        h = trunk_encode(gen.global_trunk, pyr[-1])
    with spans.span("g.trunk"):
        h = global_trunk_int8(h, qblocks, cout_tile)
    return local_decode(gen, h, pyr)


def quantize_multiscale_global(gen) -> List[QBlock]:
    """Quantize the resnet trunk of a port ``MultiscaleGlobalGenerator``
    with each BatchNorm's running statistics folded into the int8 scales
    (``quantize_multiscale_global``)."""
    return [quantize_resblock_bn(b) for b in gen.res]


def _bn_affine(norm, v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm as the int8 engine applies it (``_bn_affine``):
    ``g = γ·rsqrt(σ² + eps)``, ``b = β − μ·g``, then ``v·g + b`` in fp32,
    cast back."""
    g = norm.weight.float() * torch.rsqrt(norm.running_var.float() + eps)
    b = norm.bias.float() - norm.running_mean.float() * g
    return (v.float() * g + b).to(v.dtype)


def _bn_stage(m, v: torch.Tensor) -> torch.Tensor:
    """A ``_C7S1`` / ``_Down`` / ``_Up`` stage with :func:`_bn_affine`:
    conv, affine, ReLU."""
    conv = m.convt if hasattr(m, "convt") else m.conv
    return tnn.relu(_bn_affine(m.norm, conv(v)))


def multiscale_encode(gen, x: torch.Tensor) -> torch.Tensor:
    """The three branches and the two fuse convs as the int8 engine runs
    them: the trunk's input."""
    b1 = _bn_stage(gen.b1_down, _bn_stage(gen.b1_stem, x))
    b2_in = tnn.max_pool2d(x, 3, 2, padding=1)
    b3_in = tnn.max_pool2d(b2_in, 3, 2, padding=1)
    b12 = _bn_stage(gen.connect_b12,
                    torch.cat([b1, _bn_stage(gen.feat_stem, b2_in)], -1))
    return _bn_stage(gen.connect_b23,
                     torch.cat([b12, _bn_stage(gen.feat_stem, b3_in)], -1))


def multiscale_decode(gen, h: torch.Tensor) -> torch.Tensor:
    """The three ups with :func:`_bn_affine`, the head (``conv2d_reflect``)
    and tanh."""
    for m in gen.up:
        h = _bn_stage(m, h)
    return tnn.tanh(gen.head.conv(h))


def multiscale_global_int8_apply(gen, qblocks: Sequence[QBlock],
                                 x: torch.Tensor,
                                 cout_tile: Optional[int] = None
                                 ) -> torch.Tensor:
    """Forward of a port ``MultiscaleGlobalGenerator`` with its resnet trunk
    in int8 (``multiscale_global_int8_apply``): the ``bn=True`` chains, K1
    where ``whole_image_resblock_fits``, else K7 at ``cout_tile`` (None:
    ``pick_cout_tile``). ``qblocks`` from :func:`quantize_multiscale_global`
    of the same generator. NHWC in and out, compute dtype of ``x``."""
    h = global_trunk_int8(multiscale_encode(gen, x), qblocks, cout_tile,
                          bn=True)
    return multiscale_decode(gen, h)
