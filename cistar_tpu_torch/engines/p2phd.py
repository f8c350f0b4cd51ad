"""pix2pixHD engines (counterpart of ``cistar_tpu/engines/p2phd.py``).

:class:`Pix2PixHDInference` holds one generator, ``netG`` ``global``
(``GlobalGenerator``), ``local`` (``LocalEnhancer``), ``multiscale``
(``MultiscaleGlobalGenerator``, always BatchNorm), ``UNet``
(``UNetGeneratorHD``), ``encoder`` (``Encoder``), ``autoencoder``
(``AutoEncoder``) or ``transfer`` (``TransferPairG``, the generator of
``engines/extended.py::make_transfer_p2p``), and serves
:meth:`~Pix2PixHDInference.infer_step` (the plain forward in the compute
dtype) and :meth:`~Pix2PixHDInference.infer_step_int8` (the family's int8
engine; the last three have none, as in JAX), both after the reference's
input encoding (``pix2pixHD_model.py:119-150``). With ``spatial_mesh`` (a
:class:`~cistar_tpu_torch.parallel.sharding.Mesh`), the plain forward of
``global``, ``local`` and ``UNet`` with instance norm runs H-sharded over
the mesh's processes (:mod:`cistar_tpu_torch.parallel.spatial_models`):
every rank holds the whole batch, runs its H-slab and gathers the whole
output.

:class:`Pix2PixHD` adds the multiscale PatchGAN discriminator, the
instance-feature encoder netE and the train step of the reference
(``pix2pixHD_model.py:160-204``, ``train.py:78-164``): G's loss is the
LSGAN term, GAN feature matching (4 / (n_layers_D + 1) · 1 / num_D · λ ·
L1 per D layer, against the detached real features) and the optional
VGG19 loss; netE trains with G; D steps on the detached fake of the same
G forward, through the replay pool when ``pool_size > 0``, only when its
loss is at least 0.1; the LR is constant for ``niter`` epochs, then decays
linearly over ``niter_decay``; ``niter_fix_global`` trains only the
enhancer streams of ``local``. The step runs the plain ops under autograd,
no CUDA kernel of the port (they are forward-only), and reads nothing back
to the host.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from cistar_tpu_torch.core.convert import (
    batch_stats_to_jax, encoder_from_jax, generator_from_jax,
    generator_to_jax, global_generator_from_jax, local_enhancer_from_jax,
    multiscale_discriminator_from_jax,
    multiscale_global_generator_from_jax, unet_generator_hd_from_jax,
    unet_generator_hd_to_jax)
from cistar_tpu_torch.core.optim import AdamState, adam_step
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.losses.gan import gan_loss, l1_loss
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import (BatchNorm, Encoder,
                                               TransferPairG, define_d,
                                               define_g)
from cistar_tpu_torch.ops.quant_int8 import QBlock, quantize_global_trunk
from cistar_tpu_torch.parallel import sharding
from cistar_tpu_torch.parallel import spatial as sp
from cistar_tpu_torch.parallel.sharding import Mesh
from cistar_tpu_torch.parallel.spatial_models import generator_sharded_apply
from cistar_tpu_torch.runtime import spans
from cistar_tpu_torch.utils.image_pool import (PoolState, init_pool,
                                               sharded_push_and_pop)

# netG → (JAX params, batch_stats → state_dict; state_dict → JAX params;
# quantizer; int8 forward), None where JAX has no int8 engine
_FAMILIES: Dict[str, Tuple[Callable, Callable, Optional[Callable],
                           Optional[Callable]]] = {
    "global": (global_generator_from_jax, generator_to_jax,
               quantize_global_trunk, fi.global_generator_int8_trunk_apply),
    "local": (local_enhancer_from_jax, generator_to_jax,
              fi.quantize_local_enhancer, fi.local_enhancer_int8_apply),
    "multiscale": (multiscale_global_generator_from_jax, generator_to_jax,
                   fi.quantize_multiscale_global,
                   fi.multiscale_global_int8_apply),
    "UNet": (unet_generator_hd_from_jax, unet_generator_hd_to_jax,
             fi.quantize_unet_msrb, fi.unet_msrb_int8_apply),
    "encoder": (generator_from_jax, generator_to_jax, None, None),
    "autoencoder": (generator_from_jax, generator_to_jax, None, None),
    "transfer": (generator_from_jax, generator_to_jax, None, None),
}


def get_edges(t: torch.Tensor) -> torch.Tensor:
    """Instance-boundary map of an NHWC instance map (``get_edges``): 1
    where a pixel differs from its left, right, upper or lower neighbour."""
    e = torch.zeros_like(t, dtype=torch.bool)
    diff_w = t[:, :, 1:, :] != t[:, :, :-1, :]
    e[:, :, 1:, :] |= diff_w
    e[:, :, :-1, :] |= diff_w
    diff_h = t[:, 1:, :, :] != t[:, :-1, :, :]
    e[:, 1:, :, :] |= diff_h
    e[:, :-1, :, :] |= diff_h
    return e.float()


class Pix2PixHDInference:
    """Inference-only pix2pixHD with a ported generator family.

    Weights are random from ``seed`` (the same on every device) until
    :meth:`load_jax_params` replaces them. Inputs are NHWC; outputs are
    fp32 NHWC, as in the JAX engine.
    """

    def __init__(self, net_g: str = "global", ngf: int = 64,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 input_nc: int = 1, output_nc: int = 1, label_nc: int = 0,
                 r2l: bool = True, no_instance: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None, norm: str = "instance",
                 n_scale: int = 3, spatial_mesh: Optional[Mesh] = None):
        if net_g not in _FAMILIES:
            raise ValueError(f"generator {net_g!r} not implemented")
        if spatial_mesh is not None and (
                norm != "instance" or net_g not in ("global", "local",
                                                    "UNet")):
            raise NotImplementedError(
                "spatial sharding supports instance-norm global/local/"
                f"UNet generators (got netG={net_g!r}, norm={norm!r})")
        self.spatial_mesh = spatial_mesh
        self.net_g, self.norm, self.n_scale = net_g, norm, n_scale
        self.ngf = ngf
        self.n_downsample_global = n_downsample_global
        self.n_blocks_global = n_blocks_global
        self.n_local_enhancers = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.input_nc, self.output_nc, self.label_nc = input_nc, output_nc, \
            label_nc
        self.r2l, self.no_instance = r2l, no_instance
        self.device = resolve_device(device)
        self.cdt = compute_dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G = self._build_g()
        self.G.to(self.device).eval()
        self._convert, self._to_jax, self._quantize, self._int8_fwd = \
            _FAMILIES[net_g]

    def _build_g(self) -> torch.nn.Module:
        if self.net_g == "transfer":   # instance norm, as JAX builds it
            return TransferPairG(self.g_input_nc(), self.output_nc, self.ngf,
                                 self.n_downsample_global, self.n_scale,
                                 self.n_blocks_global)
        return define_g(self.net_g, self.g_input_nc(), self.output_nc,
                        self.ngf, self.n_downsample_global,
                        self.n_blocks_global, self.n_local_enhancers,
                        self.n_blocks_local, self.norm)

    def label_input_nc(self) -> int:
        """Channels of the encoded label, as the discriminator sees it (no
        features)."""
        nc = self.label_nc if (self.label_nc != 0 and not self.r2l) \
            else self.input_nc
        return nc + (0 if self.no_instance else 1)

    def g_input_nc(self) -> int:
        """Channels of the generator's input: the encoded label here."""
        return self.label_input_nc()

    def has_batch_norm(self) -> bool:
        return any(isinstance(m, BatchNorm) for m in self.G.modules())

    def load_jax_params(self, g_params: Mapping[str, Any],
                        g_stats: Optional[Mapping[str, Any]] = None) -> None:
        """Load the JAX engine's generator param tree (numpy leaves) and,
        for a generator with BatchNorm (``multiscale``, or ``norm="batch"``),
        its ``batch_stats`` tree ``g_stats``, without which it raises
        ValueError as the JAX engine's ``quantize_generator`` does."""
        if g_stats is None and self.has_batch_norm():
            raise ValueError(
                f"netG={self.net_g!r} runs BatchNorm: pass g_stats, the "
                "generator's batch_stats (part of the checkpoint)")
        self.G.load_state_dict(self._convert(g_params,
                                             batch_stats=g_stats or {}))

    def jax_params(self) -> Dict[str, Any]:
        """G as JAX trees (numpy fp32 leaves), keyed by the checkpoint
        labels: ``G`` and ``G_stats`` (its ``batch_stats``, ``None`` without
        BatchNorm)."""
        sd = self.G.state_dict()
        return {"G": self._to_jax(sd), "G_stats": batch_stats_to_jax(sd)}

    def encode_input(self, label: torch.Tensor,
                     inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One-hot labels (``label_nc > 0`` and not r2l; a label outside
        [0, label_nc) gives zeros) and, unless ``no_instance``, the
        instance edge map (``encode_input``). fp32 NHWC."""
        label = label.to(self.device)
        if self.label_nc != 0 and not self.r2l:
            ids = label[..., 0].long()
            x = (ids[..., None] == torch.arange(self.label_nc,
                                                device=self.device)).float()
        else:
            x = label.float()
        if not self.no_instance and inst is not None:
            x = torch.cat([x, get_edges(inst.to(self.device))], dim=-1)
        return x

    @torch.inference_mode()
    def infer_step(self, label: torch.Tensor,
                   inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G(encode_input(label, inst)) in the compute dtype
        (``infer_step``)."""
        return self._forward(None, label, inst)

    @torch.inference_mode()
    def quantize_generator(self) -> List[QBlock]:
        """Static int8 quantization of the generator's trunk
        (``quantize_generator``): the resnet blocks of ``global`` and of
        ``local``'s global trunk, those of ``multiscale`` with the running
        statistics of their BatchNorms folded in, the MSRB blocks of
        ``UNet``. The int8 forwards of ``global`` and ``local`` run instance
        norm, so with ``norm="batch"`` they raise, as the JAX engine's; so
        do ``encoder``, ``autoencoder`` and ``transfer``, which have no int8
        engine."""
        if self.net_g != "multiscale" and self.has_batch_norm():
            raise NotImplementedError(
                "int8 inference engines assume instance norm; this generator "
                f"was built with norm={self.norm!r}. Run --data_type 16/32.")
        if self._quantize is None:
            raise NotImplementedError(
                f"no int8 inference engine for netG={self.net_g!r} "
                "(supported: global, local, UNet, multiscale); run "
                "--data_type 16/32")
        return self._quantize(self.G)

    def _g(self, x: torch.Tensor) -> torch.Tensor:
        """G's plain forward: whole-image, or H-sharded over
        ``spatial_mesh`` (the whole output on every rank)."""
        if self.spatial_mesh is None:
            return self.G(x)
        return generator_sharded_apply(self.G, x,
                                       sp.group_of(self.spatial_mesh))

    def _forward(self, qblocks: Optional[List[QBlock]], label: torch.Tensor,
                 inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        with spans.span("p2phd.infer"):
            with spans.span("p2phd.stage_in"):
                if spans.active():
                    self._count_pageable(label, inst)
                x = self.encode_input(label, inst).to(self.cdt)
            if qblocks is None:
                return self._g(x).float()
            return self._int8_fwd(self.G, qblocks, x).float()

    def _count_pageable(self, *inputs: Optional[torch.Tensor]) -> None:
        """``stage_in.pageable_bytes``: the inputs' bytes copied to the
        device from host memory that is not pinned."""
        if self.device.type == "cpu":
            return
        for t in inputs:
            if t is not None and t.device.type == "cpu" and not t.is_pinned():
                spans.count("stage_in.pageable_bytes",
                            t.numel() * t.element_size())

    @torch.inference_mode()
    def infer_step_int8(self, qblocks: List[QBlock], label: torch.Tensor,
                        inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`infer_step` through the family's int8 engine
        (``infer_step_int8``); ``qblocks`` from :meth:`quantize_generator`."""
        return self._forward(qblocks, label, inst)

    def program(self, qblocks: Optional[List[QBlock]] = None
                ) -> torch.nn.Module:
        """The generator as a module of the label alone, ``forward(label)``
        → :meth:`infer_step` (``qblocks``: :meth:`infer_step_int8`), the
        program ``p2phd_test --export_onnx`` exports: G's weights are its
        parameters, the quantized trunk its constants, so the file holds
        them, as the JAX export closes over them."""
        return _P2PProgram(self, qblocks)


class _P2PProgram(torch.nn.Module):
    def __init__(self, engine: Pix2PixHDInference,
                 qblocks: Optional[List[QBlock]]):
        super().__init__()
        self.G = engine.G
        self._engine, self._qblocks = engine, qblocks

    def forward(self, label: torch.Tensor) -> torch.Tensor:
        return self._engine._forward(self._qblocks, label)


Params = Dict[str, torch.Tensor]


class P2PState(NamedTuple):
    """G's and D's params (the modules' own ``Parameter`` tensors, by
    name), their Adam states, the replay pool (``None`` at ``pool_size``
    0) and its device generator, the epoch (int32 device scalar, drives the
    LR schedule); netE's params and Adam state when it trains with G; G's
    BatchNorm running statistics (its buffers, by name) when it has any."""
    g: Params
    d: Params
    opt_g: AdamState
    opt_d: AdamState
    pool: Optional[PoolState]
    pool_gen: torch.Generator
    epoch: torch.Tensor
    e: Optional[Params] = None
    opt_e: Optional[AdamState] = None
    g_stats: Optional[Params] = None


Preds = List[List[torch.Tensor]]


class Pix2PixHD(Pix2PixHDInference):
    """The pix2pixHD trainer: G, the multiscale discriminator D, and netE
    when ``instance_feat`` / ``label_feat`` generate features. Its
    :meth:`train_step` is the JAX engine's step, op for op, in eager
    PyTorch; it updates the state's tensors in place and returns the state
    (the JAX step donates its state). G and D run in the compute dtype with
    fp32 params, netE in fp32; the losses, gradients and Adam states are
    fp32. Weights come from ``seed`` through :meth:`init_state`, the same
    on every device. The arguments are the JAX engine's; ``n_scale`` sets
    the ``transfer`` generator's pyramid
    (``engines/extended.py::make_transfer_p2p``).

    With ``mesh`` (:func:`~cistar_tpu_torch.parallel.sharding.make_mesh`)
    each process steps on its slice of the global batch and the step is the
    JAX program's over the whole batch: G's training-mode BatchNorms reduce
    their statistics over ranks, the gradients are averaged over ranks
    before Adam, the D gate reads the global ``loss_D``, the pool runs on
    the gathered fakes and the metrics are global means.

    With ``spatial_mesh`` every process reads the same whole batch and G
    runs H-sharded (its gathered fake the same on every rank); D, the
    losses, the pool and the VGG loss run on the whole image on every
    rank. G's (and netE's) gradients, each rank holding the part that
    flowed through its own slab, are summed over ranks before Adam; D's,
    each rank's the whole gradient, are averaged, so that D replicas whose
    convs round differently from run to run stay equal; the metrics, and
    with them the D gate, are averaged too. Every rank's parameters stay
    equal bit for bit. ``mesh`` and ``spatial_mesh`` exclude each other,
    as the JAX CLI spends its devices on one axis or the other."""

    def __init__(self, net_g: str = "global", input_nc: int = 1,
                 output_nc: int = 1, label_nc: int = 0, ngf: int = 64,
                 ndf: int = 64, n_downsample_global: int = 3,
                 n_blocks_global: int = 9, n_local_enhancers: int = 1,
                 n_blocks_local: int = 3, n_layers_d: int = 3,
                 num_d: int = 2, norm: str = "instance",
                 no_instance: bool = True, r2l: bool = True,
                 use_lsgan: bool = True, lambda_feat: float = 10.0,
                 use_ganfeat_loss: bool = True,
                 vgg_criterion: Optional[Callable] = None, lr: float = 1e-4,
                 beta1: float = 0.5, niter: int = 50, niter_decay: int = 50,
                 niter_fix_global: int = 0, pool_size: int = 0,
                 d_loss_floor: float = 0.1, image_size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 instance_feat: bool = False, label_feat: bool = False,
                 load_features: bool = False, feat_num: int = 3,
                 nef: int = 16, n_downsample_e: int = 4,
                 max_instances: int = 64, seed: int = 0,
                 device: DeviceLike = None, n_scale: int = 3,
                 mesh: Optional[Mesh] = None,
                 spatial_mesh: Optional[Mesh] = None):
        if mesh is not None and spatial_mesh is not None:
            raise ValueError("mesh (data parallelism) and spatial_mesh "
                             "(spatial sharding) exclude each other")
        # use_features / gen_features: pix2pixHD_model.py:26-28
        self.use_features = instance_feat or label_feat
        self.gen_features = self.use_features and not load_features
        self.label_feat, self.feat_num = label_feat, feat_num
        self.nef, self.n_downsample_e = nef, n_downsample_e
        self.max_instances = max_instances
        self.ndf, self.n_layers_d, self.num_d = ndf, n_layers_d, num_d
        self.use_lsgan, self.lambda_feat = use_lsgan, lambda_feat
        self.use_ganfeat = use_ganfeat_loss
        self.vgg_criterion = vgg_criterion
        self.lr, self.beta1 = lr, beta1
        self.niter, self.niter_decay = niter, niter_decay
        self.niter_fix_global = niter_fix_global
        self.pool_size, self.d_floor = pool_size, d_loss_floor
        self.image_size = image_size
        super().__init__(net_g, ngf, n_downsample_global, n_blocks_global,
                         n_local_enhancers, n_blocks_local, input_nc,
                         output_nc, label_nc, r2l, no_instance,
                         compute_dtype, seed, device, norm, n_scale,
                         spatial_mesh)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.D = self._build_d().to(self.device)
            self.E = self._build_e()
        if self.E is not None:
            self.E.to(self.device).eval()
        self._on = torch.ones((), dtype=torch.bool, device=self.device)
        self.mesh = mesh
        for m in self.G.modules():
            if isinstance(m, BatchNorm):
                m.mesh = mesh

    def g_input_nc(self) -> int:
        """The encoded label's channels, plus ``feat_num`` when G takes
        instance features."""
        return self.label_input_nc() + (self.feat_num if self.use_features
                                        else 0)

    def _build_d(self) -> torch.nn.Module:
        return define_d(self.label_input_nc() + self.output_nc, self.ndf,
                        self.n_layers_d, self.norm,
                        use_sigmoid=not self.use_lsgan, num_d=self.num_d,
                        get_interm_feat=self.use_ganfeat)

    def _build_e(self) -> Optional[torch.nn.Module]:
        if not self.gen_features:
            return None
        return Encoder(self.output_nc, self.feat_num, self.nef,
                       self.n_downsample_e, self.norm)

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0, image_size: Optional[int] = None
                   ) -> P2PState:
        """Fresh weights of G, D and netE from ``seed`` (drawn on the CPU,
        so the same on every device), BatchNorm statistics at 0 and 1, zero
        Adam states, an empty pool, epoch 0."""
        size = image_size or self.image_size
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = (self._build_g(), self._build_d(), self._build_e())
        for net, f in zip((self.G, self.D, self.E), fresh):
            if net is not None:
                net.load_state_dict(f.state_dict())
        g, d = dict(self.G.named_parameters()), dict(self.D.named_parameters())
        e = dict(self.E.named_parameters()) if self.E is not None else None
        dev = self.device
        pool = (init_pool(self.pool_size,
                          (size, size, self.label_input_nc() + self.output_nc),
                          dev) if self.pool_size > 0 else None)
        return P2PState(
            g=g, d=d, opt_g=AdamState(list(g.values())),
            opt_d=AdamState(list(d.values())), pool=pool,
            pool_gen=torch.Generator(device=dev).manual_seed(seed),
            epoch=torch.zeros((), dtype=torch.int32, device=dev), e=e,
            opt_e=AdamState(list(e.values())) if e is not None else None,
            g_stats=dict(self.G.named_buffers()) or None)

    def load_jax_params(self, g_params: Mapping[str, Any],
                        g_stats: Optional[Mapping[str, Any]] = None,
                        d_params: Optional[Mapping[str, Any]] = None,
                        e_params: Optional[Mapping[str, Any]] = None
                        ) -> None:
        """Load the JAX engine's param trees (numpy leaves) into the nets,
        in place: a state from :meth:`init_state` sees them. G's as
        :meth:`Pix2PixHDInference.load_jax_params`; D's and netE's when
        given."""
        super().load_jax_params(g_params, g_stats)
        if d_params is not None:
            self.D.load_state_dict(multiscale_discriminator_from_jax(d_params))
        if e_params is not None:
            self.E.load_state_dict(encoder_from_jax(e_params))

    def jax_params(self) -> Dict[str, Any]:
        """The nets as JAX trees (numpy fp32 leaves), keyed by the
        checkpoint labels: :meth:`Pix2PixHDInference.jax_params`'s, ``D``,
        and ``E`` (``None`` without netE)."""
        out = super().jax_params()
        out["D"] = generator_to_jax(self.D.state_dict())
        out["E"] = (generator_to_jax(self.E.state_dict())
                    if self.E is not None else None)
        return out

    def next_epoch(self, state: P2PState) -> P2PState:
        return state._replace(epoch=state.epoch + 1)

    # -- helpers -------------------------------------------------------------
    def lr_at(self, epoch: torch.Tensor) -> torch.Tensor:
        """The LR at ``epoch`` (``lr_at``, ``pix2pixHD_model.py:299-308``):
        constant for ``niter`` epochs, then linear to 0 over
        ``niter_decay``; constant when ``niter_decay <= 0``. An fp32 scalar
        on ``epoch``'s device."""
        if self.niter_decay <= 0:
            return torch.full((), self.lr, dtype=torch.float32,
                              device=epoch.device)
        decay = torch.clamp(epoch.float() - self.niter + 1.0, min=0.0)
        return self.lr * torch.clamp(1.0 - decay / self.niter_decay, 0.0,
                                     1.0)

    def _fix_global_mask(self, names: List[str],
                         grads: List[torch.Tensor], epoch: torch.Tensor
                         ) -> List[torch.Tensor]:
        """Zero the gradients of ``local``'s global trunk while ``epoch <
        niter_fix_global``: only the ``enh*`` and ``head`` params train
        (``_fix_global_mask``, ``pix2pixHD_model.py:93-108``)."""
        if self.niter_fix_global <= 0 or self.net_g != "local":
            return grads
        scale = 1.0 - (epoch < self.niter_fix_global).float()
        out = []
        for name, g in zip(names, grads):
            top = name.split(".")[0]
            out.append(g if top.startswith("enh") or top == "head"
                       else g * scale)
        return out

    def _pool_ids(self, label: torch.Tensor,
                  inst: Optional[torch.Tensor]) -> torch.Tensor:
        """Instance ids for feature pooling: ``inst``, or the label map
        under ``label_feat`` (``pix2pixHD_model.py:148-149``)."""
        ids = label if (self.label_feat or inst is None) else inst
        if ids.dim() == 4:
            ids = ids[..., 0]
        return ids.to(torch.int32)

    def _d(self, x: torch.Tensor) -> Preds:
        return [[t.float() for t in scale]
                for scale in self.D(x.to(self.cdt))]

    def _g_input(self, input_label: torch.Tensor, label: torch.Tensor,
                 inst: Optional[torch.Tensor], image: Optional[torch.Tensor],
                 feat: Optional[torch.Tensor]) -> torch.Tensor:
        """G's input: the encoded label, with netE's instance-pooled
        features of the real image (not detached: netE trains through G's
        losses) or the given ``feat``."""
        if self.gen_features:
            feat = self.E(image, self._pool_ids(label, inst),
                          self.max_instances)
        elif not self.use_features:
            return input_label
        return torch.cat([input_label, feat.to(self.device, torch.float32)],
                         dim=-1)

    # -- the step ------------------------------------------------------------
    @torch.enable_grad()
    def train_step(self, state: P2PState, label: torch.Tensor,
                   inst: Optional[torch.Tensor], image: torch.Tensor,
                   feat: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Tuple[P2PState, Dict[str, torch.Tensor],
                              torch.Tensor]:
        """One step on NHWC ``label`` / ``image`` (and ``inst``, ``feat``
        where the options use them); returns the state, the metrics
        (device scalars) and G's fake (fp32). ``mark(label)``, when given,
        is called at the end of each phase (``g_forward``, ``g_backward``,
        ``g_adam``, ``d_forward_backward``, ``d_adam``), for a per-phase
        timing; each phase is also a span under ``p2phd.train_step``."""
        with spans.span("p2phd.train_step"):
            return self._train_step(state, label, inst, image, feat,
                                    spans.phases(mark))

    def _train_step(self, state: P2PState, label: torch.Tensor,
                    inst: Optional[torch.Tensor], image: torch.Tensor,
                    feat: Optional[torch.Tensor], phase: spans.Phases
                    ) -> Tuple[P2PState, Dict[str, torch.Tensor],
                               torch.Tensor]:
        dev = self.device
        label = label.to(dev, torch.float32)
        image = image.to(dev, torch.float32)
        inst = None if inst is None else inst.to(dev)
        input_label = self.encode_input(label, inst)
        lr_now = self.lr_at(state.epoch)
        feat_w = 4.0 / (self.n_layers_d + 1)
        d_w = 1.0 / self.num_d
        bs = label.shape[0]

        # ---- G (and netE): the BatchNorms' running statistics move once,
        # in this forward; D's params are not inputs of the grad ----------
        g_in = self._g_input(input_label, label, inst, image, feat)
        self.G.train()
        try:
            fake = self._g(g_in.to(self.cdt)).float()
        finally:
            self.G.eval()
        if self.use_ganfeat:
            # one D call over (fake ‖ real): per-image norms make it equal
            # to two calls
            both = self._d(torch.cat([torch.cat([input_label, fake], -1),
                                      torch.cat([input_label, image], -1)]))
            pred_fake = [[t[:bs] for t in s] for s in both]
            pred_real = [[t[bs:] for t in s] for s in both]
        else:
            pred_fake = self._d(torch.cat([input_label, fake], -1))
        loss_g_gan = gan_loss(pred_fake, True, self.use_lsgan)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss_feat = zero
        if self.use_ganfeat:
            for i in range(self.num_d):
                for j in range(len(pred_fake[i]) - 1):
                    loss_feat = loss_feat + d_w * feat_w * self.lambda_feat \
                        * l1_loss(pred_fake[i][j], pred_real[i][j].detach())
        loss_vgg = zero
        if self.vgg_criterion is not None:
            loss_vgg = self.vgg_criterion(fake, image) * self.lambda_feat
        loss_g = loss_g_gan + loss_feat + loss_vgg
        phase.end("g_forward")

        g_names, g_params = list(state.g), list(state.g.values())
        e_params = list(state.e.values()) if self.gen_features else []
        grads = torch.autograd.grad(loss_g, g_params + e_params)
        phase.end("g_backward")
        g_grads = self._fix_global_mask(g_names, list(grads[:len(g_params)]),
                                        state.epoch)
        # data parallelism averages G's gradients; spatial sharding sums
        # the slabs' parts
        red = self.mesh or self.spatial_mesh
        g_red = "mean" if self.spatial_mesh is None else "sum"
        adam_step(g_params, g_grads, state.opt_g, lr_now, self._on,
                  b1=self.beta1, mesh=red, reduce=g_red)
        if self.gen_features:
            adam_step(e_params, grads[len(g_params):], state.opt_e, lr_now,
                      self._on, b1=self.beta1, mesh=red, reduce=g_red)
        phase.end("g_adam")

        # ---- D on the detached fake of the same forward (through the
        # pool), gated on loss_D >= d_loss_floor --------------------------
        fake = fake.detach()
        fake_concat = torch.cat([input_label, fake], -1)
        real_concat = torch.cat([input_label, image], -1)
        pool = state.pool
        if pool is not None:
            pool, fake_concat = sharded_push_and_pop(
                pool, fake_concat, state.pool_gen, self.mesh)
        both = self._d(torch.cat([fake_concat, real_concat]))
        nb = fake_concat.shape[0]
        loss_d_fake = gan_loss([[t[:nb] for t in s] for s in both], False,
                               self.use_lsgan)
        loss_d_real = gan_loss([[t[nb:] for t in s] for s in both], True,
                               self.use_lsgan)
        loss_d = (loss_d_fake + loss_d_real) * 0.5
        d_params = list(state.d.values())
        d_grads = torch.autograd.grad(loss_d, d_params)
        phase.end("d_forward_backward")
        metrics = sharding.global_means(
            {"G_GAN": loss_g_gan, "G_GAN_Feat": loss_feat,
             "G_VGG": loss_vgg, "D_real": loss_d_real,
             "D_fake": loss_d_fake, "loss_D": loss_d,
             "loss_G": loss_g_gan + loss_feat + loss_vgg}, red)
        metrics = {k: v.detach() for k, v in metrics.items()}
        adam_step(d_params, d_grads, state.opt_d, lr_now,
                  metrics["loss_D"] >= self.d_floor, b1=self.beta1,
                  mesh=red)
        phase.end("d_adam", last=True)
        return state._replace(pool=pool), metrics, fake

    # -- inference with features ---------------------------------------------
    @torch.inference_mode()
    def infer_encoded(self, label: torch.Tensor, inst: torch.Tensor,
                      image: torch.Tensor) -> torch.Tensor:
        """G(encode_input ‖ netE's pooled features of the real image)
        (``infer_encoded``, ``pix2pixHD_model.py:210-214``)."""
        dev = self.device
        label, image = label.to(dev), image.to(dev, torch.float32)
        inst = None if inst is None else inst.to(dev)
        feat = self.E(image, self._pool_ids(label, inst), self.max_instances)
        x = torch.cat([self.encode_input(label, inst), feat], dim=-1)
        return self._g(x.to(self.cdt)).float()

    @torch.inference_mode()
    def infer_with_features(self, label: torch.Tensor,
                            inst: Optional[torch.Tensor],
                            feat_map: torch.Tensor) -> torch.Tensor:
        """G(encode_input ‖ ``feat_map``) (``infer_with_features``)."""
        x = torch.cat([self.encode_input(label, inst),
                       feat_map.to(self.device, torch.float32)], dim=-1)
        return self._g(x.to(self.cdt)).float()


def sample_features(inst: np.ndarray, clusters: Mapping[int, np.ndarray],
                    feat_num: int, rng=None) -> np.ndarray:
    """Per-object style sampling from precomputed cluster centres, on the
    host (``sample_features``, ``pix2pixHD_model.py:230-249``): for each
    instance id, a random cluster row of its label (``id // 1000`` for ids
    ≥ 1000) painted over the object's pixels. (N, H, W, feat_num) fp32."""
    rng = rng or np.random
    if inst.ndim == 4:
        inst = inst[..., 0]
    n, h, w = inst.shape
    feat_map = np.zeros((n, h, w, feat_num), np.float32)
    for i in np.unique(inst.astype(int)):
        label = i if i < 1000 else i // 1000
        if label not in clusters:
            continue
        feat = clusters[label]
        row = feat[rng.randint(0, feat.shape[0])]
        feat_map[inst.astype(int) == i] = row[:feat_num]
    return feat_map
