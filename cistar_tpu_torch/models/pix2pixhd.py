"""pix2pixHD generators (counterpart of ``cistar_tpu/models/pix2pixhd.py``):
``GlobalGenerator`` (``netG=global``) and ``UNetGeneratorHD``
(``netG=UNet``, the r2l_MSRB experiment's generator).

Submodule names follow the JAX param trees, and ``core/convert.py`` maps
one onto the other:
  * GlobalGenerator: ``trunk.stem.conv``, ``trunk.down.i.conv``,
    ``trunk.res.i.conv{1,2}``, ``trunk.up.i.convt``, ``head.conv`` for
    ``trunk/stem/conv``, ``trunk/down_i/conv``, …;
  * UNetGeneratorHD: ``init_block.conv``, ``down_conv.i``, ``msrb.i.…``,
    ``up_convt.i``, ``output_layer.conv`` for ``init_block/conv``,
    ``down_i_conv``, ``msrb_i/…``, ``up_i_convt``, ``output_layer/conv``.

Instance norm and reflect padding only; the other norms, paddings and
generators come with later slices (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import torch
from torch import nn

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import (MSRB, Conv2d, ConvTranspose2d,
                                         ReflectConv2d, ResidualBlock)

_LATER = "(ROADMAP queue 1, item 9)"


def _instance_only(norm: str, padding_type: str = "reflect") -> None:
    if norm != "instance" or padding_type != "reflect":
        raise NotImplementedError(
            f"norm={norm!r}, padding_type={padding_type!r} is not ported "
            f"yet: instance norm with reflect padding runs here {_LATER}")


class ResnetBlock(ResidualBlock):
    """pix2pixHD resnet block (``ResnetBlock``) with reflect padding and
    instance norm: reflect conv3×3 → IN → ReLU → reflect conv3×3 → IN,
    plus the skip."""

    def __init__(self, features: int, padding_type: str = "reflect",
                 norm: str = "instance"):
        _instance_only(norm, padding_type)
        super().__init__(features)


class _C7S1(nn.Module):
    """Reflect 7×7 conv → IN → ReLU (``_C7S1``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = ReflectConv2d(cin, features, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(tnn.instance_norm(self.conv(x)))


class _Down(nn.Module):
    """Stride-2 conv3×3 (pad 1) → IN → ReLU (``_Down``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = Conv2d(cin, features, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(tnn.instance_norm(self.conv(x)))


class _Up(nn.Module):
    """Stride-2 transpose conv3×3 → IN → ReLU (``_Up``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.convt = ConvTranspose2d(cin, features, 3, stride=2, padding=1,
                                     output_padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(tnn.instance_norm(self.convt(x)))


class _OutHead(nn.Module):
    """Reflect 7×7 conv → tanh (``_OutHead``)."""

    def __init__(self, cin: int, output_nc: int):
        super().__init__()
        self.conv = ReflectConv2d(cin, output_nc, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.tanh(self.conv(x))


class GlobalGeneratorTrunk(nn.Module):
    """GlobalGenerator without its head (``GlobalGeneratorTrunk``): c7s1 →
    n stride-2 downs → n_blocks resnet blocks at ngf·2ⁿ → n ups."""

    def __init__(self, input_nc: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 norm: str = "instance", padding_type: str = "reflect"):
        super().__init__()
        _instance_only(norm, padding_type)
        self.stem = _C7S1(input_nc, ngf)
        self.down = nn.ModuleList(
            _Down(ngf * 2 ** i, ngf * 2 ** (i + 1))
            for i in range(n_downsampling))
        f = ngf * 2 ** n_downsampling
        self.res = nn.ModuleList(ResnetBlock(f, padding_type, norm)
                                 for _ in range(n_blocks))
        self.up = nn.ModuleList(
            _Up(ngf * 2 ** (n_downsampling - i),
                ngf * 2 ** (n_downsampling - i) // 2)
            for i in range(n_downsampling))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for m in (*self.down, *self.res, *self.up):
            h = m(h)
        return h


class GlobalGenerator(nn.Module):
    """c7s1-ngf → n× down → n_blocks resnet → n× up → c7s1-out + tanh
    (``GlobalGenerator``). NHWC in and out; compute dtype follows the
    input."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 norm: str = "instance", padding_type: str = "reflect"):
        super().__init__()
        self.trunk = GlobalGeneratorTrunk(input_nc, ngf, n_downsampling,
                                          n_blocks, norm, padding_type)
        self.head = _OutHead(ngf, output_nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))


class UNetGeneratorHD(nn.Module):
    """p2pHD ``UNetGenerator`` (``UNetGeneratorHD``): c7s1 → three 7×7
    stride-2 (pad 3) downs with IN+ReLU → MSRB blocks → three transpose-conv
    ups on the skip concat, with IN+ReLU → 7×7 reflect head + tanh."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 n_residual_blocks: int = 3, in_features: int = 64):
        super().__init__()
        f = in_features
        self.init_block = _C7S1(input_nc, f)
        self.down_conv = nn.ModuleList(
            Conv2d(f * 2 ** i, f * 2 ** (i + 1), 7, stride=2, padding=3)
            for i in range(3))
        feats = f * 8
        self.msrb = nn.ModuleList(MSRB(feats)
                                  for _ in range(n_residual_blocks))
        self.up_convt = nn.ModuleList(
            ConvTranspose2d(2 * feats // 2 ** i, feats // 2 ** (i + 1), 3,
                            stride=2, padding=1, output_padding=1)
            for i in range(3))
        self.output_layer = _OutHead(f, output_nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.init_block(x)
        skips = []
        for conv in self.down_conv:
            h = tnn.relu(tnn.instance_norm(conv(h)))
            skips.append(h)
        for m in self.msrb:
            h = m(h)
        for convt, skip in zip(self.up_convt, reversed(skips)):
            h = tnn.relu(tnn.instance_norm(convt(torch.cat([h, skip], -1))))
        return self.output_layer(h)


def define_g(net_g: str, input_nc: int, output_nc: int, ngf: int,
             n_downsample_global: int = 3, n_blocks_global: int = 9,
             norm: str = "instance") -> nn.Module:
    """The generator dispatch of ``define_g`` for ``global`` and ``UNet``.
    Parameters are drawn from PyTorch's global generator, on the CPU."""
    if net_g == "global":
        return GlobalGenerator(input_nc, output_nc, ngf, n_downsample_global,
                               n_blocks_global, norm)
    if net_g == "UNet":
        _instance_only(norm)
        return UNetGeneratorHD(input_nc, output_nc, n_blocks_global, ngf)
    raise NotImplementedError(
        f"netG={net_g!r} is not ported yet: 'global' and 'UNet' run here "
        f"{_LATER}")
