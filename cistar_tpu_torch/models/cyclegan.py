"""CycleGAN generators (counterpart of ``cistar_tpu/models/cyclegan.py``):
``ResnetGenerator`` ('p2p*') and ``MultiscaleBilinearGenerator``
('bilinear*', the reference CLI's default ``bilinear_content``).

Submodule names follow the JAX param tree: ``init_conv``, ``down.i`` for
``down_i``, ``res.i.…`` for ``res_i/…``, ``up.i`` for ``up_i``,
``out_conv``; ``core/convert.py`` maps one onto the other.
"""

from __future__ import annotations

import torch
from torch import nn

from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import (Conv2d, ConvTranspose2d,
                                         MultiAtrousConv, ReflectConv2d,
                                         ResidualBlock, ResidualBlockAtrous)


class ResnetGenerator(nn.Module):
    """c7s1 → 3× stride-2 down → N residual blocks → 3× transpose up →
    c7s1 + tanh. NHWC in and out; compute dtype follows the input."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 n_residual_blocks: int = 6, in_features: int = 64):
        super().__init__()
        f = in_features
        self.n_residual_blocks = n_residual_blocks
        self.init_conv = ReflectConv2d(input_nc, f, 7)
        self.down = nn.ModuleList()
        for _ in range(3):
            self.down.append(Conv2d(f, f * 2, 3, stride=2, padding=1))
            f *= 2
        self.res = nn.ModuleList(ResidualBlock(f)
                                 for _ in range(n_residual_blocks))
        self.up = nn.ModuleList()
        for _ in range(3):
            self.up.append(ConvTranspose2d(f, f // 2, 3, stride=2, padding=1,
                                           output_padding=1))
            f //= 2
        self.out_conv = ReflectConv2d(f, output_nc, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = tnn.relu(tnn.instance_norm(self.init_conv(x)))
        for m in self.down:
            h = tnn.relu(tnn.instance_norm(m(h)))
        for m in self.res:
            h = m(h)
        for m in self.up:
            h = tnn.relu(tnn.instance_norm(m(h)))
        return tnn.tanh(self.out_conv(h))


class _SkipDecoderBase(nn.Module):
    """Encoder → residual trunk → decoder whose stage ``i`` takes the trunk
    path concatenated with encoder output ``down_sample - 1 - i``
    (``_SkipDecoderBase``). Subclasses give the three kinds of block."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 n_residual_blocks: int = 6, in_features: int = 64,
                 down_sample: int = 3):
        super().__init__()
        f = in_features
        self.init_conv = ReflectConv2d(input_nc, f, 7)
        self.down = nn.ModuleList()
        for _ in range(down_sample):
            self.down.append(self.encoder_block(f, f * 2))
            f *= 2
        self.res = nn.ModuleList(self.res_block(f)
                                 for _ in range(n_residual_blocks))
        self.up = nn.ModuleList()
        for _ in range(down_sample):
            self.up.append(self.decoder_block(2 * f, f // 2))
            f //= 2
        self.out_conv = ReflectConv2d(f, output_nc, 7)

    def encoder_block(self, cin: int, features: int) -> nn.Module:
        raise NotImplementedError

    def res_block(self, features: int) -> nn.Module:
        return ResidualBlock(features)

    def decoder_block(self, cin: int, features: int) -> nn.Module:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = tnn.relu(tnn.instance_norm(self.init_conv(x)))
        skips = []
        for m in self.down:
            h = m(h)
            skips.append(h)
        for m in self.res:
            h = m(h)
        for m, skip in zip(self.up, reversed(skips)):
            h = m(torch.cat([h, skip], dim=-1))
        return tnn.tanh(self.out_conv(h))


class _BilinearUpBlock(nn.Module):
    """2× bilinear upsample → conv3×3 (zero pad 1) → IN → ReLU
    (``_BilinearUpBlock``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = Conv2d(cin, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(tnn.upsample_bilinear(x, 2))
        return tnn.relu(tnn.instance_norm(h))


class MultiscaleBilinearGenerator(_SkipDecoderBase):
    """``MultiscaleBilinearGenerator`` ('bilinear_content'): stride-2
    ``MultiAtrousConv`` encoder, ``ResidualBlockAtrous`` trunk, bilinear
    upsample + conv decoder."""

    def encoder_block(self, cin: int, features: int) -> nn.Module:
        return MultiAtrousConv(cin, features, stride=2)

    def res_block(self, features: int) -> nn.Module:
        return ResidualBlockAtrous(features)

    def decoder_block(self, cin: int, features: int) -> nn.Module:
        return _BilinearUpBlock(cin, features)


def build_generator(gen_type: str, input_nc: int = 1, output_nc: int = 1,
                    in_features: int = 16, n_residual_blocks: int = 6
                    ) -> nn.Module:
    """The reference CLI's dispatch on the prefix of ``gen_type``
    (``build_generator``). Parameters are drawn from PyTorch's global
    generator, on the CPU."""
    if gen_type.startswith("p2p"):
        return ResnetGenerator(input_nc, output_nc, n_residual_blocks,
                               in_features)
    if gen_type.startswith("bilinear"):
        return MultiscaleBilinearGenerator(input_nc, output_nc,
                                           n_residual_blocks, in_features)
    if gen_type.startswith(("atrous", "unet")):
        raise NotImplementedError(
            f"gen_type={gen_type!r} is not ported yet: the atrous* and unet* "
            "generators come with a later slice (ROADMAP queue 1, item 7); "
            "'p2p*' and 'bilinear*' run here")
    raise ValueError(f"unknown gen_type {gen_type!r}")


def seeded_generator(gen_type: str, n_residual_blocks: int, in_features: int,
                     input_nc: int = 1, output_nc: int = 1, seed: int = 0,
                     device: DeviceLike = None) -> nn.Module:
    """A randomly initialised generator from ``seed``, in eval mode on
    ``device`` (``None`` → CUDA). The weights depend on ``seed`` only, not
    on the device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = build_generator(gen_type, input_nc, output_nc, in_features,
                            n_residual_blocks)
    return g.to(resolve_device(device)).eval()
