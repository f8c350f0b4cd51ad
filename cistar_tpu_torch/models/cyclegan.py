"""CycleGAN ResNet generator (counterpart of
``cistar_tpu/models/cyclegan.py::ResnetGenerator``).

Submodule names follow the JAX param tree: ``init_conv``, ``down.i`` for
``down_i``, ``res.i.conv{1,2}`` for ``res_i/conv{1,2}``, ``up.i`` for
``up_i``, ``out_conv``; ``core/convert.py`` maps one onto the other.
"""

from __future__ import annotations

import torch
from torch import nn

from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import (Conv2d, ConvTranspose2d,
                                         ReflectConv2d, ResidualBlock)


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


def build_resnet_generator(n_residual_blocks: int = 9, in_features: int = 64,
                           input_nc: int = 1, output_nc: int = 1,
                           seed: int = 0, device: DeviceLike = None
                           ) -> ResnetGenerator:
    """A seeded, randomly initialised generator on ``device`` (``None`` →
    CUDA). The weights depend on ``seed`` only, not on the device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = ResnetGenerator(input_nc, output_nc, n_residual_blocks,
                            in_features)
    return g.to(resolve_device(device)).eval()
