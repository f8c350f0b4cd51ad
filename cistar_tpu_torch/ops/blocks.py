"""``nn.Module`` blocks over the NHWC primitives (counterpart of
``cistar_tpu/ops/blocks.py``).

Parameters are fp32 in PyTorch layouts, initialised as the JAX blocks are:
weights ~ N(0, 0.02), biases zero. Compute dtype follows the input.
"""

from __future__ import annotations

import torch
from typing import List, Sequence

from torch import nn

from cistar_tpu_torch.ops import nn as tnn


class _ConvBase(nn.Module):
    def __init__(self, w_shape, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(w_shape))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, 0.0, 0.02)


class Conv2d(_ConvBase):
    """``ops/blocks.py::Conv2d``: NHWC in/out, OIHW weight."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__((cout, cin, kernel, kernel), cout)
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.conv2d(x, self.weight, self.bias, self.stride,
                          self.padding, self.dilation)


class ReflectConv2d(_ConvBase):
    """``ops/blocks.py::ReflectConv2d``: stride-1 reflect-padded conv."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__((cout, cin, kernel, kernel), cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.conv2d_reflect(x, self.weight, self.bias)


class ConvTranspose2d(_ConvBase):
    """``ops/blocks.py::ConvTranspose2d``: weight ``(in, out, kh, kw)``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, output_padding: int = 0):
        super().__init__((cin, cout, kernel, kernel), cout)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                    self.padding, self.output_padding)


class ResidualBlock(nn.Module):
    """``ops/blocks.py::ResidualBlock``: reflect conv3×3 → IN → ReLU →
    reflect conv3×3 → IN, plus the skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = ReflectConv2d(features, features, 3)
        self.conv2 = ReflectConv2d(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = tnn.relu(tnn.instance_norm(self.conv1(x)))
        return x + tnn.instance_norm(self.conv2(h))


class MultiAtrousConv(nn.Module):
    """``ops/blocks.py::MultiAtrousConv``: parallel 3×3 branches
    ``b{i}_conv`` at dilation = padding = ``rates[i]``, each → IN → ReLU,
    summed in branch order."""

    def __init__(self, cin: int, features: int,
                 rates: Sequence[int] = (2, 4, 6, 8), stride: int = 1):
        super().__init__()
        self.rates, self.stride = tuple(rates), stride
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i}_conv", Conv2d(cin, features, 3, stride,
                                                 padding=r, dilation=r))

    def branches(self) -> List[Conv2d]:
        return [getattr(self, f"b{i}_conv") for i in range(len(self.rates))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = None
        for conv in self.branches():
            h = tnn.relu(tnn.instance_norm(conv(x)))
            out = h if out is None else out + h
        return out


class ResidualBlockAtrous(nn.Module):
    """``ops/blocks.py::ResidualBlockAtrous``: ``MultiAtrousConv`` → reflect
    conv3×3 → IN, plus the skip."""

    def __init__(self, features: int):
        super().__init__()
        self.atrous = MultiAtrousConv(features, features)
        self.conv = ReflectConv2d(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + tnn.instance_norm(self.conv(self.atrous(x)))
