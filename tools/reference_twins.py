"""Torch twins of the reference's networks, in the reference's own
``state_dict`` key layouts: what its training scripts save as ``.pth``
(``CycleGAN/models.py``, ``CycleGAN/train.py:281-290``;
``p2pHD/models/networks.py``, ``p2pHD/models/base_model.py:42-47``).

They are test-harness implementations following the reference
architectures, not the reference's code: NCHW, plain ``torch.nn``, no
import of either package. The checkpoint-import tests and ``chip_smoke.py``
save their seeded ``state_dict`` s, convert them with
``cistar_tpu_torch/apps/convert_checkpoint.py`` and hold the port's modules
to the twins' own forwards.

  * :class:`CycleResnetG` / :class:`CycleD`: CycleGAN's ``Generator`` (one
    flat ``model`` Sequential) and ``Discriminator``;
  * :class:`SkipDecoderG`: ``GeneratorUnet`` (``kind="unet"``) and the
    ``GeneratorMultiscale`` variants (``"atrous"``, ``"bilinear"``);
  * :class:`GlobalG`, :class:`LocalEnhancerT`, :class:`MultiscaleD`,
    :class:`UNetHD`: pix2pixHD's ``GlobalGenerator``, ``LocalEnhancer``,
    ``MultiscaleDiscriminator`` (``getIntermFeat``) and ``UNetGenerator``.

:func:`with_one_pass_norms` gives a twin whose instance norms take the
JAX package's one-pass moments (E[x²] − E[x]², as the port computes them)
in place of ``nn.InstanceNorm2d``'s: the same function, rounded as the
port rounds it, which tells a conversion fault from that difference.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def numpy_state_dict(m: nn.Module) -> Dict[str, np.ndarray]:
    """``m.state_dict()`` as numpy copies."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in m.state_dict().items()}


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy → NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor → NHWC tensor (a view)."""
    return t.permute(0, 2, 3, 1)


def _res_block_t(nf):
    return nn.Sequential(
        nn.ReflectionPad2d(1), nn.Conv2d(nf, nf, 3), nn.InstanceNorm2d(nf),
        nn.ReLU(True), nn.ReflectionPad2d(1), nn.Conv2d(nf, nf, 3),
        nn.InstanceNorm2d(nf))


class ResBlockT(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.conv_block = _res_block_t(nf)

    def forward(self, x):
        return x + self.conv_block(x)


class CycleResnetG(nn.Module):
    """CycleGAN ``Generator`` (same Sequential layout)."""

    def __init__(self, input_nc=1, output_nc=1, n_res=2, nf=8):
        super().__init__()
        f = nf
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, f, 7),
                  nn.InstanceNorm2d(f), nn.ReLU(True)]
        for _ in range(3):
            layers += [nn.Conv2d(f, f * 2, 3, stride=2, padding=1),
                       nn.InstanceNorm2d(f * 2), nn.ReLU(True)]
            f *= 2
        for _ in range(n_res):
            layers += [ResBlockT(f)]
        for _ in range(3):
            layers += [nn.ConvTranspose2d(f, f // 2, 3, stride=2, padding=1,
                                          output_padding=1),
                       nn.InstanceNorm2d(f // 2), nn.ReLU(True)]
            f //= 2
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(nf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class CycleD(nn.Module):
    """CycleGAN ``Discriminator``: a PatchGAN averaged to one score."""

    def __init__(self, input_nc=1):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(input_nc, 64, 4, stride=2, padding=1),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(64, 128, 4, stride=2, padding=1), nn.InstanceNorm2d(128),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(128, 256, 4, stride=2, padding=1),
            nn.InstanceNorm2d(256), nn.LeakyReLU(0.2, True),
            nn.Conv2d(256, 512, 4, padding=1), nn.InstanceNorm2d(512),
            nn.LeakyReLU(0.2, True),
            nn.Conv2d(512, 1, 4, padding=1))

    def forward(self, x):
        h = self.model(x)
        return torch.nn.functional.avg_pool2d(h, h.size()[2:]).view(
            h.size()[0], -1)


def _global_layers(input_nc, output_nc, ngf, n_down, n_blocks,
                   with_head=True):
    layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
              nn.InstanceNorm2d(ngf), nn.ReLU(True)]
    for i in range(n_down):
        m = 2 ** i
        layers += [nn.Conv2d(ngf * m, ngf * m * 2, 3, stride=2, padding=1),
                   nn.InstanceNorm2d(ngf * m * 2), nn.ReLU(True)]
    m = 2 ** n_down
    for _ in range(n_blocks):
        layers += [ResBlockT(ngf * m)]
    for i in range(n_down):
        m = 2 ** (n_down - i)
        layers += [nn.ConvTranspose2d(ngf * m, ngf * m // 2, 3, stride=2,
                                      padding=1, output_padding=1),
                   nn.InstanceNorm2d(ngf * m // 2), nn.ReLU(True)]
    if with_head:
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
    return layers


class GlobalG(nn.Module):
    """pix2pixHD ``GlobalGenerator`` (one flat ``model`` Sequential)."""

    def __init__(self, input_nc=1, output_nc=1, ngf=8, n_down=2, n_blocks=2):
        super().__init__()
        self.model = nn.Sequential(
            *_global_layers(input_nc, output_nc, ngf, n_down, n_blocks))

    def forward(self, x):
        return self.model(x)


class LocalEnhancerT(nn.Module):
    """pix2pixHD ``LocalEnhancer``: the trunk under ``model``, the streams
    under ``model1_1`` / ``model1_2``."""

    def __init__(self, input_nc=1, output_nc=1, ngf=4, n_down=2, n_blocks=2,
                 n_blocks_local=1):
        super().__init__()
        ngf_global = ngf * 2
        trunk = _global_layers(input_nc, output_nc, ngf_global, n_down,
                               n_blocks, with_head=False)
        self.model = nn.Sequential(*trunk)
        self.model1_1 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7),
            nn.InstanceNorm2d(ngf), nn.ReLU(True),
            nn.Conv2d(ngf, ngf * 2, 3, stride=2, padding=1),
            nn.InstanceNorm2d(ngf * 2), nn.ReLU(True))
        ups = [ResBlockT(ngf * 2) for _ in range(n_blocks_local)]
        ups += [nn.ConvTranspose2d(ngf * 2, ngf, 3, stride=2, padding=1,
                                   output_padding=1),
                nn.InstanceNorm2d(ngf), nn.ReLU(True),
                nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                nn.Tanh()]
        self.model1_2 = nn.Sequential(*ups)
        self.downsample = nn.AvgPool2d(3, stride=2, padding=[1, 1],
                                       count_include_pad=False)

    def forward(self, x):
        coarse = self.model(self.downsample(x))
        return self.model1_2(self.model1_1(x) + coarse)


class NLayerD(nn.Module):
    def __init__(self, input_nc=2, ndf=8, n_layers=3):
        super().__init__()
        seqs = [[nn.Conv2d(input_nc, ndf, 4, stride=2, padding=2),
                 nn.LeakyReLU(0.2, True)]]
        nf = ndf
        for _ in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            seqs += [[nn.Conv2d(nf_prev, nf, 4, stride=2, padding=2),
                      nn.InstanceNorm2d(nf), nn.LeakyReLU(0.2, True)]]
        nf_prev, nf = nf, min(nf * 2, 512)
        seqs += [[nn.Conv2d(nf_prev, nf, 4, stride=1, padding=2),
                  nn.InstanceNorm2d(nf), nn.LeakyReLU(0.2, True)]]
        seqs += [[nn.Conv2d(nf, 1, 4, stride=1, padding=2)]]
        self.n_models = len(seqs)
        for n, s in enumerate(seqs):
            setattr(self, "model" + str(n), nn.Sequential(*s))

    def forward(self, x):
        res = [x]
        for n in range(self.n_models):
            res.append(getattr(self, "model" + str(n))(res[-1]))
        return res[1:]


class MultiscaleD(nn.Module):
    """pix2pixHD ``MultiscaleDiscriminator`` with ``getIntermFeat``: each
    scale's layers as ``scale{i}_layer{j}``; per scale, every layer's
    output."""

    def __init__(self, input_nc=2, ndf=8, n_layers=3, num_D=2):
        super().__init__()
        self.num_D, self.n_layers = num_D, n_layers
        for i in range(num_D):
            d = NLayerD(input_nc, ndf, n_layers)
            for j in range(n_layers + 2):
                setattr(self, f"scale{i}_layer{j}",
                        getattr(d, "model" + str(j)))
        self.downsample = nn.AvgPool2d(3, stride=2, padding=[1, 1],
                                       count_include_pad=False)

    def forward(self, x):
        out = []
        inp = x
        for i in range(self.num_D):
            models = [getattr(self, f"scale{self.num_D - 1 - i}_layer{j}")
                      for j in range(self.n_layers + 2)]
            res = [inp]
            for m in models:
                res.append(m(res[-1]))
            out.append(res[1:])
            if i != self.num_D - 1:
                inp = self.downsample(inp)
        return out


class MSRB(nn.Module):
    def __init__(self, nf):
        super().__init__()

        def node(i, o, k, p):
            return nn.Sequential(nn.Conv2d(i, o, k, stride=1, padding=p),
                                 nn.ReLU(True))
        self.b00 = node(nf, nf, 3, 1)
        self.b01 = node(nf, nf, 5, 2)
        self.b10 = node(nf * 2, nf, 3, 1)
        self.b11 = node(nf * 2, nf, 5, 2)
        self.out = nn.Conv2d(nf * 2, nf, 1, 1)

    def forward(self, x):
        c1 = torch.cat((self.b00(x), self.b01(x)), dim=1)
        c2 = torch.cat((self.b10(c1), self.b11(c1)), dim=1)
        return self.out(c2)


class UNetHD(nn.Module):
    """pix2pixHD ``UNetGenerator`` (the r2l_MSRB experiments' netG)."""

    def __init__(self, input_nc=1, output_nc=1, n_res=2, nf=8):
        super().__init__()
        self.init_block = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, nf, 7),
            nn.InstanceNorm2d(nf), nn.ReLU(True))
        enc = []
        f = nf
        for _ in range(3):
            enc.append(nn.Sequential(
                nn.Conv2d(f, f * 2, 7, stride=2, padding=3),
                nn.InstanceNorm2d(f * 2), nn.ReLU(True)))
            f *= 2
        self.encoder = nn.ModuleList(enc)
        self.res_block = nn.Sequential(*[MSRB(f) for _ in range(n_res)])
        dec = []
        for _ in range(3):
            dec.append(nn.Sequential(
                nn.ConvTranspose2d(f * 2, f // 2, 3, stride=2, padding=1,
                                   output_padding=1),
                nn.InstanceNorm2d(f // 2), nn.ReLU(True)))
            f //= 2
        self.decoder = nn.ModuleList(dec)
        self.output_layer = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(f, output_nc, 7), nn.Tanh())

    def forward(self, x):
        h = self.init_block(x)
        skips = []
        for layer in self.encoder:
            h = layer(h)
            skips.append(h)
        h = self.res_block(skips[-1])
        for i, layer in enumerate(self.decoder):
            h = layer(torch.cat((h, skips[2 - i]), dim=1))
        return self.output_layer(h)


class MultiAtrousConv(nn.Module):
    def __init__(self, ipc, opc, stride=1):
        super().__init__()

        def branch(r):
            return nn.Sequential(nn.Conv2d(ipc, opc, 3, stride, r, r),
                                 nn.InstanceNorm2d(opc), nn.ReLU())
        self.b0, self.b1 = branch(2), branch(4)
        self.b2, self.b3 = branch(6), branch(8)

    def forward(self, x):
        return self.b0(x) + self.b1(x) + self.b2(x) + self.b3(x)


class MultiAtrousTransposeConv(nn.Module):
    def __init__(self, ipc, opc, stride=2):
        super().__init__()
        bo = opc // 4

        def branch(r):
            return nn.Sequential(
                nn.ConvTranspose2d(ipc, bo, 3, stride=stride, padding=r,
                                   dilation=r, output_padding=1),
                nn.InstanceNorm2d(bo))
        self.b0, self.b1 = branch(2), branch(4)
        self.b2, self.b3 = branch(6), branch(8)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(torch.cat(
            (self.b0(x), self.b1(x), self.b2(x), self.b3(x)), dim=1))


class ResAtrous(nn.Module):
    """The bilinear generator's atrous residual block."""

    def __init__(self, nf):
        super().__init__()
        self.atrous = MultiAtrousConv(nf, nf, 1)
        self.tail = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(nf, nf, 3),
                                  nn.InstanceNorm2d(nf))

    def forward(self, x):
        return x + self.tail(self.atrous(x))


class SkipDecoderG(nn.Module):
    """CycleGAN ``GeneratorUnet`` (``kind="unet"``) and
    ``GeneratorMultiscale`` with the atrous decoder (``"atrous"``) or the
    bilinear one and atrous residual blocks (``"bilinear"``)."""

    def __init__(self, kind, input_nc=1, output_nc=1, n_res=1, nf=8):
        super().__init__()
        self.init_block = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, nf, 7),
            nn.InstanceNorm2d(nf), nn.ReLU(True))
        f = nf
        enc = []
        for _ in range(3):
            if kind == "unet":
                enc.append(nn.Sequential(nn.Conv2d(f, f * 2, 3, 2, 1),
                                         nn.InstanceNorm2d(f * 2),
                                         nn.ReLU(True)))
            else:
                enc.append(MultiAtrousConv(f, f * 2, stride=2))
            f *= 2
        self.encoder = nn.ModuleList(enc)
        self.res_block = nn.Sequential(*[
            ResAtrous(f) if kind == "bilinear" else ResBlockT(f)
            for _ in range(n_res)])
        dec = []
        for _ in range(3):
            if kind == "bilinear":
                dec.append(nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="bilinear"),
                    nn.Conv2d(f * 2, f // 2, 3, padding=1),
                    nn.InstanceNorm2d(f // 2), nn.ReLU(True)))
            elif kind == "atrous":
                dec.append(MultiAtrousTransposeConv(f * 2, f // 2, stride=2))
            else:
                dec.append(nn.Sequential(
                    nn.ConvTranspose2d(f * 2, f // 2, 3, 2, 1,
                                       output_padding=1),
                    nn.InstanceNorm2d(f // 2), nn.ReLU(True)))
            f //= 2
        self.decoder = nn.ModuleList(dec)
        self.output_layer = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(f, output_nc, 7), nn.Tanh())

    def forward(self, x):
        h = self.init_block(x)
        skips = []
        for layer in self.encoder:
            h = layer(h)
            skips.append(h)
        h = self.res_block(skips[-1])
        for i, layer in enumerate(self.decoder):
            h = layer(torch.cat((h, skips[2 - i]), dim=1))
        return self.output_layer(h)


class OnePassInstanceNorm(nn.Module):
    """Instance norm without affine parameters from one-pass fp32 moments:
    var = E[x²] − E[x]², clamped at 0 (NCHW)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean((2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean((2, 3), keepdim=True) - mean * mean,
                          min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def with_one_pass_norms(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with each ``nn.InstanceNorm2d`` (affine=False)
    replaced by :class:`OnePassInstanceNorm` of its ``eps``."""
    model = copy.deepcopy(model)
    for m in list(model.modules()):
        for name, child in list(m.named_children()):
            if isinstance(child, nn.InstanceNorm2d):
                setattr(m, name, OnePassInstanceNorm(child.eps))
    return model


def seeded(cls, seed: int = 0, **kw) -> nn.Module:
    """``cls(**kw)`` in eval mode, its parameters drawn from ``seed`` (on
    the CPU, whatever the global generator holds)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**kw).eval()
