"""pix2pixHD generators (counterpart of ``cistar_tpu/models/pix2pixhd.py``):
``GlobalGenerator`` (``netG=global``), ``LocalEnhancer`` (``netG=local``),
``MultiscaleGlobalGenerator`` (``netG=multiscale``) and ``UNetGeneratorHD``
(``netG=UNet``, the r2l_MSRB experiment's generator).

Submodule names follow the JAX param trees, and ``core/convert.py`` maps
one onto the other:
  * GlobalGenerator: ``trunk.stem.conv``, ``trunk.down.i.conv``,
    ``trunk.res.i.conv{1,2}``, ``trunk.up.i.convt``, ``head.conv`` for
    ``trunk/stem/conv``, ``trunk/down_i/conv``, …;
  * LocalEnhancer: ``global.…`` (a ``GlobalGeneratorTrunk``),
    ``enh{n}_stem``, ``enh{n}_down``, ``enh{n}_res_{i}``, ``enh{n}_up``,
    ``head``, the JAX names;
  * MultiscaleGlobalGenerator: ``b1_stem``, ``b1_down``, ``feat_stem``,
    ``connect_b12``, ``connect_b23``, ``res.i.{conv,norm}{1,2}``,
    ``up.i.{convt,norm}``, ``head.conv``; each BatchNorm's ``weight`` /
    ``bias`` / ``running_mean`` / ``running_var`` for JAX's ``gamma`` (γ−1)
    / ``beta`` and ``batch_stats`` ``mean`` / ``var``;
  * UNetGeneratorHD: ``init_block.conv``, ``down_conv.i``, ``msrb.i.…``,
    ``up_convt.i``, ``output_layer.conv`` for ``init_block/conv``,
    ``down_i_conv``, ``msrb_i/…``, ``up_i_convt``, ``output_layer/conv``;
  * MultiscaleDiscriminator: ``scale_k.layer{n}_conv`` for
    ``scale_k/layer{n}_conv``;
  * Encoder: ``stem.conv``, ``down.i.conv``, ``up.i.convt``, ``head.conv``
    for ``stem/conv``, ``down_i/conv``, ….

Reflect padding only. Instance norm, and BatchNorm (``"batch"``) in
``global`` and ``local`` and in ``MultiscaleGlobalGenerator``, which always
runs it (a quirk of the reference's ``define_G``); in train mode a
BatchNorm normalizes with the batch's statistics and updates its running
ones. The discriminator and the encoder take instance norm only: the JAX
engine refuses a BatchNorm discriminator, and the norm option sets both.
The other paddings and ``AutoEncoder`` come with a later slice (ROADMAP
queue 1, item 9). ``GlobalGeneratorTrunk`` (with ``GlobalGenerator``'s
head) and ``UNetGeneratorHD`` record their stem and downs, blocks, and
ups and head as the spans ``g.encode``, ``g.trunk`` and ``g.decode``
(:mod:`cistar_tpu_torch.runtime.spans`); ``LocalEnhancer`` records its
global trunk so and its fine stream (the enhancers and the head) as
``g.enhance``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cistar_tpu_torch.ops import nn as tnn
from cistar_tpu_torch.ops.blocks import (MSRB, Conv2d, ConvTranspose2d,
                                         ReflectConv2d, ResidualBlock)
from cistar_tpu_torch.runtime import spans

_LATER = "(ROADMAP queue 1, item 9)"


def _reflect_only(padding_type: str) -> None:
    if padding_type != "reflect":
        raise NotImplementedError(
            f"padding_type={padding_type!r} is not ported yet: reflect "
            f"padding runs here {_LATER}")


def _instance_only(norm: str, what: str) -> None:
    if norm != "instance":
        raise NotImplementedError(
            f"the {what} takes instance norm only (norm={norm!r}): the JAX "
            "engine threads no BatchNorm statistics through it")


class BatchNorm(nn.Module):
    """``NormLayer("batch")``, PyTorch's BatchNorm semantics, NHWC, in
    fp32, the result cast back to the input dtype. ``weight`` is γ (JAX
    stores γ−1); ``running_mean`` / ``running_var`` start at 0 and 1, as in
    JAX. The layer starts in eval mode.

    Eval: ``((x − running_mean) / sqrt(running_var + 1e-5)) · weight +
    bias``. Train: the same with the batch's statistics over (N, H, W), the
    mean and the biased variance ``mean((x − μ)²)`` (two passes, as JAX
    computes them, not E[x²] − E[x]²), in JAX's op order; each call then
    moves the running statistics by momentum 0.1 towards μ and the unbiased
    variance ``σ² · n / max(n − 1, 1)``, outside autograd.

    ``mesh`` (set by a data-parallel trainer, a
    :class:`~cistar_tpu_torch.parallel.sharding.Mesh`): in train mode the
    input is this rank's slice of the global batch, and both passes sum
    over ranks (differentiably) before dividing by the global count, so
    the statistics, the running update and the gradients are the global
    batch's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.mesh = None
        self.eps, self.momentum = eps, 0.1
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.training = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean.float(), self.running_var.float()
        elif self.mesh is not None and self.mesh.grouped:
            from cistar_tpu_torch.parallel.sharding import \
                all_reduce_sum_grad as psum
            n = x.shape[0] * x.shape[1] * x.shape[2] * self.mesh.size
            mean = psum(xf.sum(dim=(0, 1, 2)), self.mesh) / n
            var = psum(torch.square(xf - mean).sum(dim=(0, 1, 2)),
                       self.mesh) / n
            self._update(mean, var, n)
        else:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.square(xf - mean).mean(dim=(0, 1, 2))
            self._update(mean, var, x.shape[0] * x.shape[1] * x.shape[2])
        out = (xf - mean) / torch.sqrt(var + self.eps)
        return (self.weight.float() * out + self.bias.float()).to(x.dtype)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var
                               + m * (var * (n / max(n - 1, 1))))


def _make_norm(norm: str, features: int):
    """``None`` for instance norm (no parameters), a :class:`BatchNorm` for
    ``"batch"``."""
    if norm == "instance":
        return None
    if norm == "batch":
        return BatchNorm(features)
    raise ValueError(f"unknown norm {norm!r}")


def _apply_norm(norm, h: torch.Tensor) -> torch.Tensor:
    return tnn.instance_norm(h) if norm is None else norm(h)


class ResnetBlock(ResidualBlock):
    """pix2pixHD resnet block (``ResnetBlock``) with reflect padding:
    reflect conv3×3 → norm → ReLU → reflect conv3×3 → norm, plus the skip;
    norm ``"instance"`` or ``"batch"`` (``norm1`` / ``norm2``)."""

    def __init__(self, features: int, padding_type: str = "reflect",
                 norm: str = "instance"):
        _reflect_only(padding_type)
        super().__init__(features)
        self.norm1 = _make_norm(norm, features)
        self.norm2 = _make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = tnn.relu(_apply_norm(self.norm1, self.conv1(x)))
        return x + _apply_norm(self.norm2, self.conv2(h))


class _C7S1(nn.Module):
    """Reflect 7×7 conv → norm → ReLU (``_C7S1``)."""

    def __init__(self, cin: int, features: int, norm: str = "instance"):
        super().__init__()
        self.conv = ReflectConv2d(cin, features, 7)
        self.norm = _make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(_apply_norm(self.norm, self.conv(x)))


class _Down(nn.Module):
    """Stride-2 conv3×3 (pad 1) → norm → ReLU (``_Down``)."""

    def __init__(self, cin: int, features: int, norm: str = "instance"):
        super().__init__()
        self.conv = Conv2d(cin, features, 3, stride=2, padding=1)
        self.norm = _make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(_apply_norm(self.norm, self.conv(x)))


class _Up(nn.Module):
    """Stride-2 transpose conv3×3 → norm → ReLU (``_Up``)."""

    def __init__(self, cin: int, features: int, norm: str = "instance"):
        super().__init__()
        self.convt = ConvTranspose2d(cin, features, 3, stride=2, padding=1,
                                     output_padding=1)
        self.norm = _make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.relu(_apply_norm(self.norm, self.convt(x)))


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
        _reflect_only(padding_type)
        self.stem = _C7S1(input_nc, ngf, norm)
        self.down = nn.ModuleList(
            _Down(ngf * 2 ** i, ngf * 2 ** (i + 1), norm)
            for i in range(n_downsampling))
        f = ngf * 2 ** n_downsampling
        self.res = nn.ModuleList(ResnetBlock(f, padding_type, norm)
                                 for _ in range(n_blocks))
        self.up = nn.ModuleList(
            _Up(ngf * 2 ** (n_downsampling - i),
                ngf * 2 ** (n_downsampling - i) // 2, norm)
            for i in range(n_downsampling))

    def forward(self, x: torch.Tensor,
                head: Optional[nn.Module] = None) -> torch.Tensor:
        """The trunk's output, or ``head``'s of it (inside ``g.decode``)."""
        with spans.span("g.encode"):
            h = self.stem(x)
            for m in self.down:
                h = m(h)
        with spans.span("g.trunk"):
            for m in self.res:
                h = m(h)
        with spans.span("g.decode"):
            for m in self.up:
                h = m(h)
            return h if head is None else head(h)


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
        return self.trunk(x, self.head)


class LocalEnhancer(nn.Module):
    """Coarse-to-fine generator (``LocalEnhancer``): a
    :class:`GlobalGeneratorTrunk` at ngf·2^n_local_enhancers features,
    registered as ``global``, on the input average-pooled n_local_enhancers
    times; each enhancer n adds a fine-scale stream (stem, a stride-2 down)
    to the coarser output, then runs its resnet blocks and an up; the last
    carries the head. Reflect padding."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 32,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 norm: str = "instance"):
        super().__init__()
        self.n_local_enhancers = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.add_module("global", GlobalGeneratorTrunk(
            input_nc, ngf * 2 ** n_local_enhancers, n_downsample_global,
            n_blocks_global, norm))
        for n in range(1, n_local_enhancers + 1):
            f = ngf * 2 ** (n_local_enhancers - n)
            self.add_module(f"enh{n}_stem", _C7S1(input_nc, f, norm))
            self.add_module(f"enh{n}_down", _Down(f, 2 * f, norm))
            for i in range(n_blocks_local):
                self.add_module(f"enh{n}_res_{i}",
                                ResnetBlock(2 * f, norm=norm))
            self.add_module(f"enh{n}_up", _Up(2 * f, f, norm))
        self.head = _OutHead(ngf, output_nc)

    @property
    def global_trunk(self) -> GlobalGeneratorTrunk:
        """The ``global`` submodule (a Python keyword as an attribute)."""
        return self._modules["global"]

    def enhancer(self, n: int, part: str) -> nn.Module:
        """Submodule ``enh{n}_{part}`` (``stem``, ``down``, ``res_{i}``,
        ``up``)."""
        return self._modules[f"enh{n}_{part}"]

    def pyramid(self, x: torch.Tensor) -> list:
        """[x, x/2, …]: n_local_enhancers 3×3 stride-2 average pools
        (``count_include_pad=False``)."""
        pyr = [x]
        for _ in range(self.n_local_enhancers):
            pyr.append(tnn.avg_pool2d(pyr[-1], 3, 2, padding=1))
        return pyr

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pyr = self.pyramid(x)
        h = self.global_trunk(pyr[-1])
        with spans.span("g.enhance"):
            for n in range(1, self.n_local_enhancers + 1):
                d = self.enhancer(n, "down")(
                    self.enhancer(n, "stem")(pyr[self.n_local_enhancers - n]))
                h = d + h
                for i in range(self.n_blocks_local):
                    h = self.enhancer(n, f"res_{i}")(h)
                h = self.enhancer(n, "up")(h)
            return self.head(h)


class MultiscaleGlobalGenerator(nn.Module):
    """Three-branch input pyramid fused by strided convs
    (``MultiscaleGlobalGenerator``): b1 is a stem and a stride-2 conv on the
    full image; b2 and b3 are ONE stem module (``feat_stem``, shared weights
    as in the reference) on the 1× and 2× 3×3 stride-2 max-pooled input;
    [b1, b2] is fused by ``connect_b12`` to 4·ngf at /4, [b12, b3] by
    ``connect_b23`` to 8·ngf at /8; then the resnet blocks, three ups and
    the head. BatchNorm (the reference's ``define_G`` gives this family no
    other) and reflect padding. NHWC in and out; compute dtype follows the
    input."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9):
        super().__init__()
        self.b1_stem = _C7S1(input_nc, ngf, "batch")
        self.b1_down = _Down(ngf, ngf, "batch")
        self.feat_stem = _C7S1(input_nc, ngf, "batch")
        self.connect_b12 = _Down(2 * ngf, 4 * ngf, "batch")
        self.connect_b23 = _Down(5 * ngf, 8 * ngf, "batch")
        self.res = nn.ModuleList(ResnetBlock(8 * ngf, norm="batch")
                                 for _ in range(n_blocks))
        self.up = nn.ModuleList(_Up(ngf * m, ngf * m // 2, "batch")
                                for m in (8, 4, 2))
        self.head = _OutHead(ngf, output_nc)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The three branches and the two fuse convs: the trunk's input."""
        b1 = self.b1_down(self.b1_stem(x))
        b2_in = tnn.max_pool2d(x, 3, 2, padding=1)
        b3_in = tnn.max_pool2d(b2_in, 3, 2, padding=1)
        b12 = self.connect_b12(torch.cat([b1, self.feat_stem(b2_in)], -1))
        return self.connect_b23(torch.cat([b12, self.feat_stem(b3_in)], -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encode(x)
        for m in (*self.res, *self.up):
            h = m(h)
        return self.head(h)


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
        with spans.span("g.encode"):
            h = self.init_block(x)
            skips = []
            for conv in self.down_conv:
                h = tnn.relu(tnn.instance_norm(conv(h)))
                skips.append(h)
        with spans.span("g.trunk"):
            for m in self.msrb:
                h = m(h)
        with spans.span("g.decode"):
            for convt, skip in zip(self.up_convt, reversed(skips)):
                h = tnn.relu(tnn.instance_norm(
                    convt(torch.cat([h, skip], -1))))
            return self.output_layer(h)


class AutoEncoder(nn.Module):
    """GlobalGenerator split into named stages for GAN inversion
    (``AutoEncoder``): ``init_layer`` (c7s1), ``encoder_i`` (stride-2
    downs), ``resblock_i``, ``decoder_i`` (ups), ``output_layer`` (7×7
    reflect head + tanh), the JAX names; :meth:`encode` runs the first two
    groups, :meth:`decode` the rest."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 norm: str = "instance", padding_type: str = "reflect"):
        super().__init__()
        _reflect_only(padding_type)
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.init_layer = _C7S1(input_nc, ngf, norm)
        for i in range(n_downsampling):
            self.add_module(f"encoder_{i}", _Down(ngf * 2 ** i,
                                                  ngf * 2 ** (i + 1), norm))
        f = ngf * 2 ** n_downsampling
        for i in range(n_blocks):
            self.add_module(f"resblock_{i}", ResnetBlock(f, padding_type,
                                                         norm))
        for i in range(n_downsampling):
            c = ngf * 2 ** (n_downsampling - i)
            self.add_module(f"decoder_{i}", _Up(c, c // 2, norm))
        self.output_layer = _OutHead(ngf, output_nc)

    def _stage(self, name: str, n: int) -> list:
        return [self._modules[f"{name}_{i}"] for i in range(n)]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = self.init_layer(x)
        for m in self._stage("encoder", self.n_downsampling):
            h = m(h)
        return h

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        for m in (*self._stage("resblock", self.n_blocks),
                  *self._stage("decoder", self.n_downsampling)):
            h = m(h)
        return self.output_layer(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def define_g(net_g: str, input_nc: int, output_nc: int, ngf: int,
             n_downsample_global: int = 3, n_blocks_global: int = 9,
             n_local_enhancers: int = 1, n_blocks_local: int = 3,
             norm: str = "instance") -> nn.Module:
    """The generator dispatch of ``define_g``: ``global``, ``local``,
    ``encoder`` (the instance-feature :class:`Encoder` as G, to
    ``output_nc`` channels), ``multiscale`` (BatchNorm whatever ``norm``
    says, the reference's quirk), ``autoencoder`` and ``UNet`` (which takes
    no norm). Parameters are drawn from PyTorch's global generator, on the
    CPU."""
    if net_g == "global":
        return GlobalGenerator(input_nc, output_nc, ngf, n_downsample_global,
                               n_blocks_global, norm)
    if net_g == "local":
        return LocalEnhancer(input_nc, output_nc, ngf, n_downsample_global,
                             n_blocks_global, n_local_enhancers,
                             n_blocks_local, norm)
    if net_g == "encoder":
        return Encoder(input_nc, output_nc, ngf, n_downsample_global, norm)
    if net_g == "multiscale":
        return MultiscaleGlobalGenerator(input_nc, output_nc, ngf,
                                         n_blocks_global)
    if net_g == "autoencoder":
        return AutoEncoder(input_nc, output_nc, ngf, n_downsample_global,
                           n_blocks_global, norm)
    if net_g == "UNet":
        # the reference builds the same UNet whatever ``norm`` says
        return UNetGeneratorHD(input_nc, output_nc, n_blocks_global, ngf)
    raise ValueError(f"generator {net_g!r} not implemented")


class Encoder(nn.Module):
    """Instance-feature encoder (``Encoder``): c7s1 → n stride-2 downs → n
    ups → 7×7 reflect head + tanh to ``output_nc`` (``feat_num``) channels,
    then, given instance ids, :func:`instance_average_pool`. Instance
    norm."""

    def __init__(self, input_nc: int = 1, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, norm: str = "instance"):
        super().__init__()
        _instance_only(norm, "encoder")
        self.stem = _C7S1(input_nc, ngf)
        self.down = nn.ModuleList(
            _Down(ngf * 2 ** i, ngf * 2 ** (i + 1))
            for i in range(n_downsampling))
        self.up = nn.ModuleList(
            _Up(ngf * 2 ** (n_downsampling - i),
                ngf * 2 ** (n_downsampling - i) // 2)
            for i in range(n_downsampling))
        self.head = _OutHead(ngf, output_nc)

    def forward(self, x: torch.Tensor, inst: torch.Tensor = None,
                max_instances: int = 64) -> torch.Tensor:
        h = self.stem(x)
        for m in (*self.down, *self.up):
            h = m(h)
        out = self.head(h)
        if inst is None:
            return out
        return instance_average_pool(out, inst, max_instances)


def instance_average_pool(features: torch.Tensor, inst: torch.Tensor,
                          max_instances: int = 64) -> torch.Tensor:
    """Each feature replaced by its mean over the image's pixels of the same
    instance id (``instance_average_pool``), with the JAX version's
    arithmetic. Per image, the ids are compacted as ``jnp.unique(size=K,
    fill_value=-2)`` does: the sorted distinct ids, the first K of them,
    padded with −2. The means are one-hot sums in fp32; a pixel whose id is
    not among the K keeps its value. Batched, with no host read.

    ``features`` (N, H, W, C); ``inst`` (N, H, W) or (N, H, W, 1), cast to
    int32 (truncating, as ``astype``)."""
    if inst.dim() == 4:
        inst = inst[..., 0]
    n, h, w, c = features.shape
    k = max_instances
    ids = inst.to(torch.int32).reshape(n, h * w)
    srt = torch.sort(ids, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(first.long(), dim=1) - 1
    # every id's first occurrence goes to its rank; the rest to slot K
    slot = torch.where(first & (rank < k), rank, torch.full_like(rank, k))
    uniq = torch.full((n, k + 1), -2, dtype=torch.int32,
                      device=ids.device).scatter_(1, slot, srt)[:, :k]
    onehot = (ids[:, :, None] == uniq[:, None, :]).float()     # (N, HW, K)
    flat = features.reshape(n, h * w, c).float()
    sums = onehot.transpose(1, 2) @ flat                        # (N, K, C)
    counts = onehot.sum(dim=1)[..., None]                       # (N, K, 1)
    means = sums / torch.clamp(counts, min=1.0)
    pooled = onehot @ means                                     # (N, HW, C)
    covered = onehot.sum(dim=2, keepdim=True) > 0
    return torch.where(covered, pooled, flat).reshape(n, h, w, c) \
        .to(features.dtype)


class NLayerDiscriminator(nn.Module):
    """The pix2pixHD PatchGAN (``NLayerDiscriminator``): 4×4 convs with
    zero padding 2, channels doubling from ``ndf`` to at most 512: a
    stride-2 conv + LeakyReLU(0.2), ``n_layers − 1`` stride-2 convs + IN +
    LeakyReLU, a stride-1 conv + IN + LeakyReLU, a one-channel stride-1
    conv (each stride-1 layer grows the map by 1), then a sigmoid unless
    LSGAN. Returns every layer's output when ``get_interm_feat``, else the
    last. Instance norm; NHWC."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, get_interm_feat: bool = False):
        super().__init__()
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid
        self.get_interm_feat = get_interm_feat
        nf = [ndf]
        for _ in range(n_layers):
            nf.append(min(nf[-1] * 2, 512))
        self.layer0_conv = Conv2d(input_nc, ndf, 4, stride=2, padding=2)
        for n in range(1, n_layers + 1):
            self.add_module(f"layer{n}_conv", Conv2d(
                nf[n - 1], nf[n], 4, stride=2 if n < n_layers else 1,
                padding=2))
        self.add_module(f"layer{n_layers + 1}_conv",
                        Conv2d(nf[n_layers], 1, 4, stride=1, padding=2))

    def forward(self, x: torch.Tensor):
        h = tnn.leaky_relu(self.layer0_conv(x), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            conv = self._modules[f"layer{n}_conv"]
            h = tnn.leaky_relu(tnn.instance_norm(conv(h)), 0.2)
            feats.append(h)
        h = self._modules[f"layer{self.n_layers + 1}_conv"](h)
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        return feats if self.get_interm_feat else h


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGANs over an average-pool pyramid
    (``MultiscaleDiscriminator``): the i-th runs ``scale_{num_D−1−i}`` on
    the input pooled i times (3×3, stride 2, padding 1,
    ``count_include_pad=False``). Returns a list of per-scale lists: every
    layer's output with ``get_interm_feat``, else the last alone."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, num_D: int = 3,
                 get_interm_feat: bool = False):
        super().__init__()
        self.num_D, self.get_interm_feat = num_D, get_interm_feat
        for k in range(num_D):
            self.add_module(f"scale_{k}", NLayerDiscriminator(
                input_nc, ndf, n_layers, use_sigmoid, get_interm_feat))

    def forward(self, x: torch.Tensor) -> list:
        results, inp = [], x
        for i in range(self.num_D):
            out = self._modules[f"scale_{self.num_D - 1 - i}"](inp)
            results.append(out if self.get_interm_feat else [out])
            if i != self.num_D - 1:
                inp = tnn.avg_pool2d(inp, 3, 2, padding=1)
        return results


def define_d(input_nc: int, ndf: int, n_layers_d: int,
             norm: str = "instance", use_sigmoid: bool = False,
             num_d: int = 2, get_interm_feat: bool = True
             ) -> MultiscaleDiscriminator:
    """``define_d``: a :class:`MultiscaleDiscriminator`; instance norm
    only. Parameters are drawn from PyTorch's global generator, on the
    CPU."""
    _instance_only(norm, "discriminator")
    return MultiscaleDiscriminator(input_nc, ndf, n_layers_d, use_sigmoid,
                                   num_d, get_interm_feat)


# --------------------------------------------------------------------------- #
# the transfer pair, the Wasserstein critic and the UDA modules
# --------------------------------------------------------------------------- #
class InstanceNormAffine(nn.Module):
    """``NormLayer("instance_affine")``: instance norm with a learned
    per-channel ``weight`` (γ; JAX stores γ − 1) and ``bias`` (β), in fp32,
    cast back. γ starts at 1 + N(0, 0.02), as JAX draws it."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.instance_norm(x, self.eps, self.weight, self.bias)


class FeatureEncoder(nn.Module):
    """Pyramid feature encoder (``FeatureEncoder``): ONE c7s1 ``stem``
    applied to the input and to its 3×3 stride-2 max pools, ``n_scale``
    branches in all; ``down.0`` takes branch 0, ``down.i`` the previous
    result concatenated with branch i, each a stride-2 conv → norm → ReLU
    to ngf·2^(i+1); the downs past ``n_scale`` run plain. Out: ngf·2^max(
    n_downsampling, n_scale) channels at 1/2^max(…) resolution."""

    def __init__(self, input_nc: int = 1, ngf: int = 32,
                 n_downsampling: int = 4, n_scale: int = 3,
                 norm: str = "instance"):
        super().__init__()
        self.n_scale = n_scale
        self.stem = _C7S1(input_nc, ngf, norm)
        cins = [ngf] + [ngf * 2 ** i + ngf for i in range(1, n_scale)]
        cins += [ngf * 2 ** (n_scale + i)
                 for i in range(n_downsampling - n_scale)]
        self.down = nn.ModuleList(_Down(c, ngf * 2 ** (i + 1), norm)
                                  for i, c in enumerate(cins))
        self.out_channels = ngf * 2 ** len(cins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches, inp = [], x
        for i in range(self.n_scale):
            branches.append(self.stem(inp))
            if i != self.n_scale - 1:
                inp = tnn.max_pool2d(inp, 3, 2, padding=1)
        h = None
        for i, down in enumerate(self.down):
            if i < self.n_scale:
                h = branches[0] if i == 0 else torch.cat([h, branches[i]], -1)
            h = down(h)
        return h


class TransferGenerator(nn.Module):
    """The decoder half that pairs with :class:`FeatureEncoder`
    (``TransferGenerator``): ``n_blocks`` resnet blocks at ngf·2^
    n_upsampling, ``n_upsampling`` ups, the 7×7 reflect head + tanh."""

    def __init__(self, output_nc: int = 1, n_blocks: int = 9, ngf: int = 32,
                 n_upsampling: int = 4, norm: str = "instance",
                 padding_type: str = "reflect"):
        super().__init__()
        f = ngf * 2 ** n_upsampling
        self.res = nn.ModuleList(ResnetBlock(f, padding_type, norm)
                                 for _ in range(n_blocks))
        self.up = nn.ModuleList(
            _Up(ngf * 2 ** (n_upsampling - i),
                ngf * 2 ** (n_upsampling - i) // 2, norm)
            for i in range(n_upsampling))
        self.head = _OutHead(ngf, output_nc)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for m in (*self.res, *self.up):
            h = m(h)
        return self.head(h)


class TransferPairG(nn.Module):
    """``E`` (:class:`FeatureEncoder`) then ``G`` (:class:`TransferGenerator`)
    as one generator (``engines/extended.py::TransferPairG``, the
    reference's ``fake = netG(netE(input))``)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 32,
                 n_downsampling: int = 4, n_scale: int = 3,
                 n_blocks: int = 3, norm: str = "instance"):
        super().__init__()
        self.E = FeatureEncoder(input_nc, ngf, n_downsampling, n_scale, norm)
        self.G = TransferGenerator(output_nc, n_blocks, ngf, n_downsampling,
                                   norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.G(self.E(x))


class WDiscriminator(nn.Module):
    """Wasserstein critic (``WDiscriminator``): ``n_layer − 1`` stages of a
    4×4 stride-2 zero-pad-1 conv without bias (``conv_i``; ngf, then
    doubling to at most 512), affine instance norm (``norm_i``) and
    LeakyReLU 0.2, then a one-channel conv of the same kind
    (``conv_out``); LeakyReLU on it with ``activate``; with ``flatten``, the
    mean of the whole batch's map in fp32, a scalar."""

    def __init__(self, input_nc: int = 1, ngf: int = 16, n_layer: int = 5,
                 activate: bool = False, flatten: bool = True):
        super().__init__()
        self.n_layer, self.activate, self.flatten = n_layer, activate, flatten
        cin = input_nc
        for i in range(n_layer - 1):
            f = ngf if i == 0 else min(cin * 2, 512)
            self.add_module(f"conv_{i}", Conv2d(cin, f, 4, stride=2,
                                                padding=1, bias=False))
            self.add_module(f"norm_{i}", InstanceNormAffine(f))
            cin = f
        self.conv_out = Conv2d(cin, 1, 4, stride=2, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layer - 1):
            h = tnn.leaky_relu(self._modules[f"norm_{i}"](
                self._modules[f"conv_{i}"](h)), 0.2)
        h = self.conv_out(h)
        if self.activate:
            h = tnn.leaky_relu(h, 0.2)
        if self.flatten:
            return h.float().mean()
        return h


def _stride2_size(size: int, n: int) -> int:
    for _ in range(n):
        size = (size - 1) // 2 + 1
    return size


class UDAEncoder(nn.Module):
    """UDA shared encoder (``UDAEncoder``): c7s1 stem with instance norm,
    ``down_conv`` 3×3 stride-2 convs (``down_i_conv``) each with
    BatchNorm (``down_i_bn``) and ReLU, channels doubling to at most
    ``max_ch``, instance-norm resnet blocks (``res.i``); with ``linear``,
    the NHWC-flattened map times ``linear_w`` ((H·W·C, max_ch), JAX's
    layout) plus ``linear_b`` in fp32, for inputs of ``size``²."""

    def __init__(self, input_nc: int = 1, size: int = 512,
                 down_conv: int = 3, ngf: int = 16, n_resblocks: int = 3,
                 linear: bool = False, max_ch: int = 512):
        super().__init__()
        self.down_conv, self.linear = down_conv, linear
        self.stem = _C7S1(input_nc, ngf)
        nf = ngf
        for i in range(down_conv):
            cin, nf = nf, min(nf * 2, max_ch)
            self.add_module(f"down_{i}_conv",
                            Conv2d(cin, nf, 3, stride=2, padding=1))
            self.add_module(f"down_{i}_bn", BatchNorm(nf))
        self.res = nn.ModuleList(ResnetBlock(nf) for _ in range(n_resblocks))
        self.out_channels = nf
        if linear:
            n_in = _stride2_size(size, down_conv) ** 2 * nf
            self.linear_w = nn.Parameter(0.02 * torch.randn(n_in, max_ch))
            self.linear_b = nn.Parameter(torch.zeros(max_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for i in range(self.down_conv):
            h = tnn.relu(self._modules[f"down_{i}_bn"](
                self._modules[f"down_{i}_conv"](h)))
        for m in self.res:
            h = m(h)
        if self.linear:   # fp32, as JAX promotes ``flat @ w`` to it
            return h.reshape(h.shape[0], -1).float() @ self.linear_w \
                + self.linear_b
        return h


class UDADecoder(nn.Module):
    """UDA per-domain decoder (``UDADecoder``): resnet blocks (``res.i``),
    each followed by instance norm and ReLU; ``down_conv`` 4×4 stride-2
    pad-1 transpose convs (``up_i_convt``) halving the channels (floor 4),
    each with BatchNorm (``up_i_bn``) and ReLU; the 7×7 reflect head +
    tanh (``head``). ``input_nc`` is the encoder's channel count."""

    def __init__(self, input_nc: int, output_nc: int = 1,
                 down_conv: int = 3, n_resblocks: int = 3):
        super().__init__()
        self.down_conv = down_conv
        nc = input_nc
        self.res = nn.ModuleList(ResnetBlock(nc) for _ in range(n_resblocks))
        for i in range(down_conv):
            cin, nc = nc, max(nc // 2, 4)
            self.add_module(f"up_{i}_convt", ConvTranspose2d(
                cin, nc, 4, stride=2, padding=1))
            self.add_module(f"up_{i}_bn", BatchNorm(nc))
        self.head = _OutHead(nc, output_nc)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for m in self.res:
            h = tnn.relu(tnn.instance_norm(m(h)))
        for i in range(self.down_conv):
            h = tnn.relu(self._modules[f"up_{i}_bn"](
                self._modules[f"up_{i}_convt"](h)))
        return self.head(h)


class DomainFeatureDiscriminator(nn.Module):
    """Feature-space domain classifier (``DomainFeatureDiscriminator``):
    four 3×3 pad-1 convs (``conv_i``) with BatchNorm (``bn_i``) and
    LeakyReLU 0.2, channels halving from ``input_nc`` (floor ``min_nf``),
    then a one-channel conv (``conv_out``), BatchNorm (``bn_out``) and a
    sigmoid."""

    def __init__(self, input_nc: int, min_nf: int = 8):
        super().__init__()
        cin, nf = input_nc, max(input_nc // 2, min_nf)
        for i in range(4):
            self.add_module(f"conv_{i}", Conv2d(cin, nf, 3, padding=1))
            self.add_module(f"bn_{i}", BatchNorm(nf))
            cin, nf = nf, max(nf // 2, min_nf)
        self.conv_out = Conv2d(cin, 1, 3, padding=1)
        self.bn_out = BatchNorm(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(4):
            h = tnn.leaky_relu(self._modules[f"bn_{i}"](
                self._modules[f"conv_{i}"](h)), 0.2)
        return torch.sigmoid(self.bn_out(self.conv_out(h)))
