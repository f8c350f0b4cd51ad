"""The pix2pixHD generators on H-slabs (counterpart of
``cistar_tpu/parallel/spatial_models.py``).

Each forward reads the weights of the port's own modules
(``models/pix2pixhd.py``: :class:`GlobalGenerator`, :class:`LocalEnhancer`,
:class:`UNetGeneratorHD`), so one set of weights serves the whole-image
path and the sharded one, as in JAX. The ``*_slab_forward`` functions run
on this rank's slab (the role of a ``shard_map`` body); the
``*_sharded_apply`` ones take the whole batch on every rank, check JAX's
divisibility rule, and return the whole output on every rank
(:func:`~cistar_tpu_torch.parallel.spatial.sharded_apply`). Convs exchange
halo rows, instance norms sum their statistics over ``group``; instance
norm only, as the JAX engine allows.
"""

from __future__ import annotations

import torch
from torch import nn

from cistar_tpu_torch.models.pix2pixhd import (BatchNorm, GlobalGenerator,
                                               GlobalGeneratorTrunk,
                                               LocalEnhancer,
                                               UNetGeneratorHD)
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, ReflectConv2d
from cistar_tpu_torch.parallel import spatial as sp


def _conv(x: torch.Tensor, conv: nn.Module, group) -> torch.Tensor:
    """A ``ReflectConv2d`` (stride 1, reflect) or a ``Conv2d`` (its stride
    and zero padding) on the slab."""
    if isinstance(conv, ReflectConv2d):
        k = conv.weight.shape[-1]
        return sp.spatial_conv2d(x, conv.weight, conv.bias, 1, (k - 1) // 2,
                                 "reflect", group)
    assert isinstance(conv, Conv2d) and conv.dilation == 1
    return sp.spatial_conv2d(x, conv.weight, conv.bias, conv.stride,
                             conv.padding, "zero", group)


def _convt(x: torch.Tensor, convt: ConvTranspose2d, group) -> torch.Tensor:
    return sp.spatial_conv_transpose2d(x, convt.weight, convt.bias, group)


def _in(x: torch.Tensor, group) -> torch.Tensor:
    return sp.spatial_instance_norm(x, group=group)


def _in_relu(x: torch.Tensor, group) -> torch.Tensor:
    return tnn.relu(_in(x, group))


def _instance_only(model: nn.Module) -> None:
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        raise NotImplementedError("spatial sharding runs instance norm only")


def _resnet_block(h: torch.Tensor, blk: nn.Module, group) -> torch.Tensor:
    r = _in_relu(_conv(h, blk.conv1, group), group)
    return h + _in(_conv(r, blk.conv2, group), group)


def _trunk(trunk: GlobalGeneratorTrunk, x: torch.Tensor, group
           ) -> torch.Tensor:
    h = _in_relu(_conv(x, trunk.stem.conv, group), group)
    for m in trunk.down:
        h = _in_relu(_conv(h, m.conv, group), group)
    for blk in trunk.res:
        h = _resnet_block(h, blk, group)
    for m in trunk.up:
        h = _in_relu(_convt(h, m.convt, group), group)
    return h


def _head(h: torch.Tensor, head: nn.Module, group) -> torch.Tensor:
    return tnn.tanh(_conv(h, head.conv, group))


def _divides(x: torch.Tensor, group, downs: int) -> None:
    n = sp.rank_and_size(group)[1]
    need = n * 2 ** downs
    if x.shape[1] % need:
        raise ValueError(f"H = {x.shape[1]} must divide {need} ({n} shards "
                         f"through {downs} stride-2 stages)")


def global_generator_slab_forward(model: GlobalGenerator, x: torch.Tensor,
                                  group=None) -> torch.Tensor:
    """``GlobalGenerator`` on one H-slab."""
    _instance_only(model)
    return _head(_trunk(model.trunk, x, group), model.head, group)


def global_generator_sharded_apply(model: GlobalGenerator, x: torch.Tensor,
                                   group=None) -> torch.Tensor:
    """``GlobalGenerator`` with H sharded over ``group``: H must divide
    shards · 2^n_downsampling."""
    _divides(x, group, len(model.trunk.down))
    return sp.sharded_apply(
        lambda s: global_generator_slab_forward(model, s, group), x, group)


def local_enhancer_slab_forward(model: LocalEnhancer, x: torch.Tensor,
                                group=None) -> torch.Tensor:
    """``LocalEnhancer`` on one H-slab: the input pyramid by halo average
    pools, the global trunk at the coarsest scale, the enhancer streams,
    the head."""
    _instance_only(model)
    n_le = model.n_local_enhancers
    pyramid = [x]
    for _ in range(n_le):
        pyramid.append(sp.spatial_avg_pool_3s2(pyramid[-1], group))
    h = _trunk(model.global_trunk, pyramid[-1], group)
    for n in range(1, n_le + 1):
        d = _in_relu(_conv(pyramid[n_le - n], model.enhancer(n, "stem").conv,
                           group), group)
        d = _in_relu(_conv(d, model.enhancer(n, "down").conv, group), group)
        h = d + h
        for i in range(model.n_blocks_local):
            h = _resnet_block(h, model.enhancer(n, f"res_{i}"), group)
        h = _in_relu(_convt(h, model.enhancer(n, "up").convt, group), group)
    return _head(h, model.head, group)


def local_enhancer_sharded_apply(model: LocalEnhancer, x: torch.Tensor,
                                 group=None) -> torch.Tensor:
    """``LocalEnhancer`` with H sharded over ``group``: H must divide
    shards · 2^(n_downsample_global + n_local_enhancers)."""
    _divides(x, group, len(model.global_trunk.down) + model.n_local_enhancers)
    return sp.sharded_apply(
        lambda s: local_enhancer_slab_forward(model, s, group), x, group)


def unet_msrb_slab_forward(model: UNetGeneratorHD, x: torch.Tensor,
                           group=None) -> torch.Tensor:
    """``UNetGeneratorHD`` (the r2l_MSRB generator) on one H-slab: 7×7
    stride-2 halo downs, the MSRB blocks (3×3 / 5×5 halo convs), the skip
    concats (the same rows on both sides), the transpose-conv ups."""
    h = _in_relu(_conv(x, model.init_block.conv, group), group)
    skips = []
    for conv in model.down_conv:
        h = _in_relu(_conv(h, conv, group), group)
        skips.append(h)
    for blk in model.msrb:
        cat1 = torch.cat([tnn.relu(_conv(h, blk.b00_conv, group)),
                          tnn.relu(_conv(h, blk.b01_conv, group))], -1)
        cat2 = torch.cat([tnn.relu(_conv(cat1, blk.b10_conv, group)),
                          tnn.relu(_conv(cat1, blk.b11_conv, group))], -1)
        h = _conv(cat2, blk.out_conv, group)
    for convt, skip in zip(model.up_convt, reversed(skips)):
        h = _in_relu(_convt(torch.cat([h, skip], -1), convt, group), group)
    return _head(h, model.output_layer, group)


def unet_msrb_sharded_apply(model: UNetGeneratorHD, x: torch.Tensor,
                            group=None) -> torch.Tensor:
    """``UNetGeneratorHD`` with H sharded over ``group``: H must divide
    shards · 8."""
    _divides(x, group, 3)
    return sp.sharded_apply(
        lambda s: unet_msrb_slab_forward(model, s, group), x, group)


def generator_sharded_apply(model: nn.Module, x: torch.Tensor, group=None
                            ) -> torch.Tensor:
    """The ``*_sharded_apply`` of ``model``'s family."""
    for cls, fn in ((GlobalGenerator, global_generator_sharded_apply),
                    (LocalEnhancer, local_enhancer_sharded_apply),
                    (UNetGeneratorHD, unet_msrb_sharded_apply)):
        if isinstance(model, cls):
            return fn(model, x, group)
    raise NotImplementedError(
        f"spatial sharding supports the global, local and UNet generators, "
        f"not {type(model).__name__}")
