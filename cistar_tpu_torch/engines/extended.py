"""Extended trainers (counterpart of ``cistar_tpu/engines/extended.py``).

  * :func:`make_transfer_p2p`: the pix2pixHD trainer with G =
    ``TransferGenerator ∘ FeatureEncoder`` (``netG="transfer"``,
    ``Pix2PixHDTransferModel``).
  * :class:`R2LTransfer`: feature-space alignment between pretrained
    radar / lidar encoder-generator pairs (``pix2pixHD_model.py:625-893``).
    The radar encoder, both generators and both image discriminators are
    frozen; the feature critic DF steps first (LSGAN on feature maps, only
    while its loss exceeds 0.2), then the lidar encoder, on the image GAN
    term through the frozen lidar D and the alignment term against the
    updated DF.
  * :class:`R2LAE`: the UDA shared-encoder autoencoder (``udaModel.R2LAE``):
    one encoder over radar ‖ lidar, a decoder per domain, a feature domain
    classifier (BCE on clipped probabilities) and an image D per domain,
    all six stepped from the gradient of one joint loss, with no detach
    anywhere (the reference accumulates six backward passes, then steps).
  * :class:`R2LImageCritic`: a Wasserstein critic between lidar and radar
    images with gradient penalty (``udaModel.R2LImageDiscriminator``).

Each step is the JAX step op for op in eager PyTorch: plain ops under
autograd, no CUDA kernel of the port (they are forward-only), no value read
back to the host. Params, gradients, Adam states and losses are fp32; the
nets run in the compute dtype. Weights are drawn from ``seed`` on the CPU,
the same on every device; the states hold the modules' own ``Parameter``
tensors and the steps update them in place. ``jax_params`` /
``load_jax_params`` map the trainable nets (and BatchNorm statistics) to
the JAX package's param trees and back.

:class:`R2LAE` and :class:`R2LImageCritic` take a ``mesh``
(:func:`~cistar_tpu_torch.parallel.sharding.make_mesh`, data parallelism):
each process steps on its slice of the global batch, and the step is the
JAX program's over the whole batch — the BatchNorm statistics sum over
ranks, the losses and metrics are global means, the gradients are
averaged before each Adam.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from cistar_tpu_torch.core.convert import (batch_stats_to_jax,
                                           generator_from_jax,
                                           generator_to_jax)
from cistar_tpu_torch.core.optim import AdamState, adam_step
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.losses.gan import (gan_loss, gradient_penalty_at,
                                         l1_loss, mse_loss)
from cistar_tpu_torch.models.pix2pixhd import (BatchNorm,
                                               DomainFeatureDiscriminator,
                                               FeatureEncoder,
                                               TransferGenerator, UDADecoder,
                                               UDAEncoder, WDiscriminator,
                                               define_d)
from cistar_tpu_torch.parallel import sharding
from cistar_tpu_torch.parallel.sharding import Mesh

Params = Dict[str, torch.Tensor]
Mark = Optional[Callable[[str], None]]


def make_transfer_p2p(output_nc: int = 1, ngf: int = 32,
                      n_downsampling: int = 4, n_scale: int = 3,
                      n_blocks: int = 3, **p2p_kwargs):
    """The :class:`~cistar_tpu_torch.engines.p2phd.Pix2PixHD` trainer whose
    generator is the FeatureEncoder / TransferGenerator pair
    (``netG="transfer"``): the whole pix2pixHD objective and step."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD

    return Pix2PixHD(net_g="transfer", output_nc=output_nc, ngf=ngf,
                     n_downsample_global=n_downsampling,
                     n_blocks_global=n_blocks, n_scale=n_scale, **p2p_kwargs)


def _seeded(seed: int, build: Callable[[], Any]):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _reload(nets, fresh) -> None:
    for net, f in zip(nets, fresh):
        net.load_state_dict(f.state_dict())


def _d_preds(d: torch.nn.Module, x: torch.Tensor, cdt) -> list:
    return [[t.float() for t in scale] for scale in d(x.to(cdt))]


def _split(preds: list, n: int) -> Tuple[list, list]:
    return ([[t[:n] for t in s] for s in preds],
            [[t[n:] for t in s] for s in preds])


# --------------------------------------------------------------------------- #
# R2LTransfer
# --------------------------------------------------------------------------- #
class R2LState(NamedTuple):
    """The trainable nets (their ``Parameter`` tensors, by name) and their
    Adam states."""
    lidar_e: Params
    net_df: Params
    opt_lidar_e: AdamState
    opt_df: AdamState


FROZEN = ("radar_e", "radar_g", "lidar_g", "net_dr", "net_dl")


class R2LTransfer:
    """Feature-space domain alignment (``R2LTransfer``,
    ``pix2pixHD_model.py:625-893``). Trainable: the lidar encoder ``E`` and
    the feature critic ``DF`` (``WDiscriminator(ngf=16, df_layers,
    activate=True, flatten=False)``). Frozen, passed to each step as a dict
    of modules (:meth:`init_frozen`, :meth:`frozen_from_checkpoints`): the
    radar encoder, the radar and lidar generators and the two image
    discriminators; they take no gradient and do not change."""

    def __init__(self, output_nc: int = 1, ngf: int = 32,
                 n_downsampling: int = 4, n_scale: int = 3,
                 n_blocks: int = 3, ndf: int = 64, n_layers_d: int = 3,
                 num_d: int = 2, lambda_feat: float = 10.0,
                 lr: float = 1e-4, beta1: float = 0.5, df_layers: int = 5,
                 d_loss_floor: float = 0.2, image_size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None):
        self.output_nc, self.ngf = output_nc, ngf
        self.n_downsampling, self.n_scale = n_downsampling, n_scale
        self.n_blocks, self.ndf = n_blocks, ndf
        self.n_layers_d, self.num_d = n_layers_d, num_d
        self.df_layers, self.lambda_feat = df_layers, lambda_feat
        self.lr, self.beta1, self.d_floor = lr, beta1, d_loss_floor
        self.image_size, self.cdt = image_size, compute_dtype
        self.device = resolve_device(device)
        self.E, self.DF = (m.to(self.device) for m in
                           _seeded(seed, self._build_trainable))
        self._lr = torch.full((), lr, dtype=torch.float32,
                              device=self.device)
        self._on = torch.ones((), dtype=torch.bool, device=self.device)

    def _encoder(self) -> FeatureEncoder:
        # one-channel frames, as JAX inits E (its unread input_nc is dropped)
        return FeatureEncoder(1, self.ngf, self.n_downsampling, self.n_scale)

    def _build_trainable(self):
        e = self._encoder()
        return e, WDiscriminator(e.out_channels, 16, self.df_layers,
                                 activate=True, flatten=False)

    def _build_frozen(self) -> Dict[str, torch.nn.Module]:
        def g():
            return TransferGenerator(self.output_nc, self.n_blocks, self.ngf,
                                     self.n_downsampling)

        def d():
            return define_d(2, self.ndf, self.n_layers_d, num_d=self.num_d,
                            get_interm_feat=True)

        return {"radar_e": self._encoder(), "radar_g": g(), "lidar_g": g(),
                "net_dr": d(), "net_dl": d()}

    # -- state ---------------------------------------------------------------
    def init_frozen(self, seed: int = 0) -> Dict[str, torch.nn.Module]:
        """Random frozen nets from ``seed``, in eval mode on the device,
        their params without ``requires_grad`` (``init_frozen``; replace
        them with trained ones through :meth:`frozen_from_checkpoints`)."""
        frozen = _seeded(seed, self._build_frozen)
        for m in frozen.values():
            m.to(self.device).eval().requires_grad_(False)
        return frozen

    def frozen_from_checkpoints(self, seed: int = 0, **trees
                                ) -> Dict[str, torch.nn.Module]:
        """:meth:`init_frozen`, then each net given as a JAX param tree
        (``radar_e=…``, …, numpy leaves; the dict of JAX's ``init_frozen``
        / ``frozen_from_checkpoints`` unpacks into it) loaded over its
        random init."""
        frozen = self.init_frozen(seed)
        for key, tree in trees.items():
            if key not in FROZEN:
                raise KeyError(f"{key!r} is not a frozen net of R2LTransfer")
            if tree is not None:
                frozen[key].load_state_dict(
                    generator_from_jax(tree, batch_stats={}))
        return frozen

    @staticmethod
    def frozen_to_jax(frozen: Mapping[str, torch.nn.Module]
                      ) -> Dict[str, Any]:
        """The frozen nets as JAX param trees (numpy fp32 leaves)."""
        return {k: generator_to_jax(m.state_dict()) for k, m in
                frozen.items()}

    def init_state(self, seed: int = 0) -> R2LState:
        """Fresh ``E`` and ``DF`` from ``seed`` and zero Adam states."""
        _reload((self.E, self.DF), _seeded(seed, self._build_trainable))
        e, df = dict(self.E.named_parameters()), \
            dict(self.DF.named_parameters())
        return R2LState(lidar_e=e, net_df=df,
                        opt_lidar_e=AdamState(list(e.values())),
                        opt_df=AdamState(list(df.values())))

    def jax_params(self) -> Dict[str, Any]:
        return {"lidar_e": generator_to_jax(self.E.state_dict()),
                "net_df": generator_to_jax(self.DF.state_dict())}

    def load_jax_params(self, lidar_e: Mapping[str, Any],
                        net_df: Mapping[str, Any]) -> None:
        """The JAX state's ``lidar_e`` / ``net_df`` trees into ``E`` /
        ``DF``, in place (a state from :meth:`init_state` sees them)."""
        self.E.load_state_dict(generator_from_jax(lidar_e, batch_stats={}))
        self.DF.load_state_dict(generator_from_jax(net_df, batch_stats={}))

    # -- the step ------------------------------------------------------------
    @torch.enable_grad()
    def train_step(self, state: R2LState,
                   frozen: Mapping[str, torch.nn.Module],
                   radar: torch.Tensor, lidar: torch.Tensor, mark: Mark = None
                   ) -> Tuple[R2LState, Dict[str, torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor]]:
        """One step on NHWC ``radar`` / ``lidar``: the metrics (device
        scalars) and the cross decodes (radar → lidar, lidar → radar;
        fp32). ``mark(label)`` is called at the end of each phase
        (``df_step``, ``e_forward``, ``e_backward``, ``e_adam``,
        ``decode``)."""
        mark = mark or (lambda name: None)
        dev, cdt = self.device, self.cdt
        radar = radar.to(dev, torch.float32)
        lidar = lidar.to(dev, torch.float32)
        bs = radar.shape[0]
        one = torch.ones(1, device=dev)

        def run(net, x):
            return net(x.to(cdt)).float()

        with torch.no_grad():
            radar_feat = run(frozen["radar_e"], radar)   # the "real" features
        lidar_feat = run(self.E, lidar)

        # ---- the feature critic: LSGAN on feature maps, gated on its loss.
        # One DF call over both: its instance norms are per image
        pred = run(self.DF, torch.cat([radar_feat, lidar_feat.detach()]))
        loss_df = 0.5 * mse_loss(pred[:bs], one) \
            + 0.5 * mse_loss(pred[bs:], torch.zeros(1, device=dev))
        df_params = list(state.net_df.values())
        df_grads = torch.autograd.grad(loss_df, df_params)
        adam_step(df_params, df_grads, state.opt_df, self._lr,
                  loss_df > self.d_floor, b1=self.beta1)
        mark("df_step")

        # ---- the lidar encoder, against the updated critic ---------------
        feat_w = 4.0 / (self.n_layers_d + 1)
        d_w = 1.0 / self.num_d
        lidar_gen = run(frozen["lidar_g"], lidar_feat)
        pred_fake = _d_preds(frozen["net_dl"],
                             torch.cat([lidar, lidar_gen], -1), cdt)
        loss_gan = gan_loss(pred_fake, True)
        # the critic should call the lidar features "real"
        loss_align = mse_loss(run(self.DF, lidar_feat), one)
        mark("e_forward")
        e_params = list(state.lidar_e.values())
        e_grads = torch.autograd.grad(loss_gan + loss_align, e_params)
        mark("e_backward")
        adam_step(e_params, e_grads, state.opt_lidar_e, self._lr, self._on,
                  b1=self.beta1)
        mark("e_adam")

        with torch.no_grad():
            # feature matching is a log-only metric: the reference's branch
            # optimizes the two terms above (pix2pixHD_model.py:806-811)
            pred_real = _d_preds(frozen["net_dl"],
                                 torch.cat([lidar, lidar], -1), cdt)
            loss_feat = torch.zeros((), device=dev)
            for i in range(self.num_d):
                for j in range(len(pred_fake[i]) - 1):
                    loss_feat = loss_feat + d_w * feat_w * self.lambda_feat \
                        * l1_loss(pred_fake[i][j], pred_real[i][j])
            # the cross decodes, for inspection
            radar_trans = run(frozen["lidar_g"], radar_feat)
            lidar_trans = run(frozen["radar_g"], lidar_feat)
        mark("decode")
        metrics = {"G_GAN": loss_gan, "G_GAN_Feat": loss_feat,
                   "G_Loss": loss_align, "D_Loss": loss_df}
        return (state, {k: v.detach() for k, v in metrics.items()},
                (radar_trans, lidar_trans))


# --------------------------------------------------------------------------- #
# R2LAE
# --------------------------------------------------------------------------- #
NETS = ("e", "g_radar", "g_lidar", "df", "dr", "dl")
BN_NETS = ("e", "g_radar", "g_lidar", "df")


class R2LAEState(NamedTuple):
    """The six nets' ``Parameter`` tensors by name, their Adam states
    (``opts``, keyed as the nets) and the BatchNorm running statistics of
    the encoder, the decoders and DF (``stats``, their buffers by name)."""
    e: Params
    g_radar: Params
    g_lidar: Params
    df: Params
    dr: Params
    dl: Params
    opts: Dict[str, AdamState]
    stats: Dict[str, Params]


class R2LAE:
    """UDA trainer (``udaModel.py:385-617``): ``E`` (:class:`UDAEncoder`),
    ``G_radar`` / ``G_lidar`` (:class:`UDADecoder`), ``DF``
    (:class:`DomainFeatureDiscriminator`, or with ``wgan`` a
    ``WDiscriminator(activate=False, flatten=False)``), ``DR`` / ``DL``
    (multiscale PatchGANs on the one-channel images). With ``mesh`` each
    rank steps on its slice of the global batch: every BatchNorm reduces
    its statistics over ranks, the losses are the rank's means and the
    metrics global ones, and the six nets' gradients are averaged over
    ranks, which makes the step the global batch's."""

    def __init__(self, input_nc: int = 1, size: int = 512,
                 n_downsample: int = 3, ngf: int = 16,
                 encoder_resblock: int = 0, max_ch: int = 256,
                 wgan: bool = False, ndf: int = 64, n_layers_d: int = 3,
                 num_d: int = 2, lr: float = 1e-4, beta1: float = 0.5,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.input_nc, self.size, self.n_downsample = input_nc, size, \
            n_downsample
        self.ngf, self.encoder_resblock, self.max_ch = ngf, \
            encoder_resblock, max_ch
        self.wgan, self.ndf, self.n_layers_d, self.num_d = wgan, ndf, \
            n_layers_d, num_d
        self.lr, self.beta1, self.cdt = lr, beta1, compute_dtype
        self.device = resolve_device(device)
        (self.E, self.G_radar, self.G_lidar, self.DF, self.DR,
         self.DL) = (m.to(self.device) for m in _seeded(seed, self._build))
        self._lr = torch.full((), lr, dtype=torch.float32,
                              device=self.device)
        self._on = torch.ones((), dtype=torch.bool, device=self.device)
        self.mesh = mesh
        for net in (self.E, self.G_radar, self.G_lidar, self.DF):
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.mesh = mesh

    def _build(self):
        e = UDAEncoder(self.input_nc, self.size, self.n_downsample, self.ngf,
                       self.encoder_resblock, max_ch=self.max_ch)
        nc = e.out_channels

        def dec():
            return UDADecoder(nc, 1, self.n_downsample,
                              self.encoder_resblock)

        def d():
            return define_d(1, self.ndf, self.n_layers_d, num_d=self.num_d,
                            get_interm_feat=True)

        df = (WDiscriminator(nc, activate=False, flatten=False) if self.wgan
              else DomainFeatureDiscriminator(nc))
        return e, dec(), dec(), df, d(), d()

    def nets(self) -> Dict[str, torch.nn.Module]:
        return dict(zip(NETS, (self.E, self.G_radar, self.G_lidar, self.DF,
                               self.DR, self.DL)))

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> R2LAEState:
        """Fresh nets from ``seed``, running statistics at 0 and 1, zero
        Adam states."""
        nets = self.nets()
        _reload(nets.values(), _seeded(seed, self._build))
        params = {k: dict(m.named_parameters()) for k, m in nets.items()}
        return R2LAEState(
            **params,
            opts={k: AdamState(list(p.values())) for k, p in params.items()},
            stats={k: dict(nets[k].named_buffers()) for k in BN_NETS})

    def jax_params(self) -> Dict[str, Any]:
        """The six nets as JAX param trees by state field, and ``stats``:
        the BatchNorm statistics trees of the encoder, decoders and DF
        (``{}`` for a net without BatchNorm)."""
        nets = self.nets()
        out = {k: generator_to_jax(m.state_dict()) for k, m in nets.items()}
        out["stats"] = {k: batch_stats_to_jax(nets[k].state_dict()) or {}
                        for k in BN_NETS}
        return out

    def load_jax_params(self, params: Mapping[str, Any],
                        stats: Mapping[str, Any]) -> None:
        """JAX's six param trees (keyed by state field) and its ``stats``
        into the nets, in place."""
        for k, m in self.nets().items():
            m.load_state_dict(generator_from_jax(
                params[k], batch_stats=stats.get(k) or {}))

    # -- the step ------------------------------------------------------------
    def _train_mode(self, on: bool) -> None:
        for m in (self.E, self.G_radar, self.G_lidar, self.DF):
            m.train(on)

    @torch.enable_grad()
    def train_step(self, state: R2LAEState, radar: torch.Tensor,
                   lidar: torch.Tensor, mark: Mark = None
                   ) -> Tuple[R2LAEState, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
        """One step on NHWC ``radar`` / ``lidar``: the metrics (device
        scalars) and the decodes ``lidar_gen`` / ``radar_gen`` of the
        forward (fp32). Each BatchNorm normalizes with its batch: the
        encoder's spans both domains, DF's the concatenated features, each
        decoder's its own half; each moves its running statistics once.
        ``mark(label)`` ends the phases ``forward``, ``backward``,
        ``adam``."""
        mark = mark or (lambda name: None)
        dev, cdt = self.device, self.cdt
        radar = radar.to(dev, torch.float32)
        lidar = lidar.to(dev, torch.float32)
        bs = radar.shape[0]

        self._train_mode(True)
        try:
            feat = self.E(torch.cat([radar, lidar]).to(cdt)).float()
            radar_feat, lidar_feat = feat[:bs], feat[bs:]
            pred_f = self.DF(feat.to(cdt)).float()
            lidar_gen = self.G_lidar(lidar_feat.to(cdt)).float()
            radar_gen = self.G_radar(radar_feat.to(cdt)).float()
        finally:
            self._train_mode(False)
        ones = torch.ones_like(pred_f[:bs])
        zeros = torch.zeros_like(pred_f[:bs])
        target_real = torch.cat([ones, zeros])
        target_flip = torch.cat([zeros, ones])
        # BCE on clipped probabilities: with wgan the critic's raw scores
        # would make torch's BCELoss raise (udaModel.py:419,452); the clip
        # lets that configuration run, as in JAX
        p = torch.clamp(pred_f, 1e-6, 1 - 1e-6)
        log_p, log_q = torch.log(p), torch.log(1 - p)
        loss_d_encoder = -torch.mean(target_real * log_p
                                     + (1 - target_real) * log_q)
        loss_encoder = -torch.mean(target_flip * log_p
                                   + (1 - target_flip) * log_q)
        mse_lidar = mse_loss(lidar, lidar_gen)
        mse_radar = mse_loss(radar, radar_gen)
        # one call of each image D over (fake ‖ real): per-image norms
        fake_l, real_l = _split(_d_preds(self.DL, torch.cat(
            [lidar_gen, lidar]), cdt), bs)
        fake_r, real_r = _split(_d_preds(self.DR, torch.cat(
            [radar_gen, radar]), cdt), bs)
        loss_g_gan_lidar = gan_loss(fake_l, True)
        loss_d_lidar = gan_loss(real_l, True) + gan_loss(fake_l, False)
        loss_g_gan_radar = gan_loss(fake_r, True)
        loss_d_radar = gan_loss(real_r, True) + gan_loss(fake_r, False)
        loss_gan_lidar = mse_lidar + loss_g_gan_lidar
        loss_gan_radar = mse_radar + loss_g_gan_radar
        total = (loss_gan_lidar + loss_gan_radar + loss_d_lidar
                 + loss_d_radar + loss_d_encoder + loss_encoder)
        mark("forward")

        groups = [list(getattr(state, k).values()) for k in NETS]
        grads = torch.autograd.grad(total, [p for g in groups for p in g])
        mark("backward")
        o = 0
        for k, g in zip(NETS, groups):
            adam_step(g, grads[o:o + len(g)], state.opts[k], self._lr,
                      self._on, b1=self.beta1, mesh=self.mesh)
            o += len(g)
        mark("adam")
        metrics = sharding.global_means(
            {"gan_radar": loss_gan_radar, "gan_lidar": loss_gan_lidar,
             "MSE_radar": mse_radar, "MSE_lidar": mse_lidar,
             "w_distance_F": loss_d_encoder, "d_radar": loss_d_radar,
             "d_lidar": loss_d_lidar}, self.mesh)
        return (state, {k: v.detach() for k, v in metrics.items()},
                {"lidar_gen": lidar_gen.detach(),
                 "radar_gen": radar_gen.detach()})

    @torch.inference_mode()
    def infer(self, state: R2LAEState, radar: torch.Tensor,
              lidar: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Eval mode: the BatchNorms use their running statistics, so each
        frame's output is independent of the batch; outputs in the compute
        dtype, as JAX returns them."""
        dev, cdt = self.device, self.cdt
        bs = radar.shape[0]
        ip = torch.cat([radar.to(dev), lidar.to(dev)]).float()
        feat = self.E(ip.to(cdt)).float()
        return {"lidar_gen": self.G_lidar(feat[bs:].to(cdt)),
                "radar_gen": self.G_radar(feat[:bs].to(cdt))}


# --------------------------------------------------------------------------- #
# the image critic
# --------------------------------------------------------------------------- #
class CriticState(NamedTuple):
    """The critic's ``Parameter`` tensors by name, its Adam state, and the
    device generator of the penalty's interpolation weights."""
    d: Params
    opt: AdamState
    gen: torch.Generator


class R2LImageCritic:
    """Wasserstein distance between lidar and radar images
    (``udaModel.py:309-381``): ``D`` is ``WDiscriminator(ngf, n_layer,
    flatten=True)``, a batch mean; the loss is ``mean D(lidar) − mean
    D(radar) + w_lambda · GP`` (GP with λ = 1); Adam β = (0.5, 0.9) with
    weight decay 1e-4 (``optax.chain(add_decayed_weights, adam)``). With
    ``mesh`` each rank steps on its slice of the global batch and the step
    is the global batch's (the metrics global means, the gradient averaged
    over ranks)."""

    def __init__(self, ngf: int = 16, n_layer: int = 5,
                 w_lambda: float = 10.0, lr: float = 1e-4,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.ngf, self.n_layer, self.w_lambda = ngf, n_layer, w_lambda
        self.lr, self.cdt = lr, compute_dtype
        self.device = resolve_device(device)
        self.D = _seeded(seed, self._build).to(self.device)
        self._lr = torch.full((), lr, dtype=torch.float32,
                              device=self.device)
        self._on = torch.ones((), dtype=torch.bool, device=self.device)

    def _build(self) -> WDiscriminator:
        return WDiscriminator(1, self.ngf, self.n_layer, flatten=True)

    def init_state(self, seed: int = 0) -> CriticState:
        """Fresh ``D`` from ``seed``, a zero Adam state and the penalty's
        generator seeded with ``seed``."""
        _reload((self.D,), (_seeded(seed, self._build),))
        d = dict(self.D.named_parameters())
        return CriticState(
            d=d, opt=AdamState(list(d.values())),
            gen=torch.Generator(device=self.device).manual_seed(seed))

    def jax_params(self) -> Dict[str, Any]:
        return {"d": generator_to_jax(self.D.state_dict())}

    def load_jax_params(self, d: Mapping[str, Any]) -> None:
        self.D.load_state_dict(generator_from_jax(d, batch_stats={}))

    @torch.enable_grad()
    def train_step(self, state: CriticState, lidar: torch.Tensor,
                   radar: torch.Tensor, eps: Optional[torch.Tensor] = None,
                   mark: Mark = None
                   ) -> Tuple[CriticState, Dict[str, torch.Tensor]]:
        """One critic step on NHWC ``lidar`` (the penalty's "real") and
        ``radar``. ``eps`` (N, 1, 1, 1), the interpolation weights, is drawn
        from ``state.gen`` unless given; with ``mesh``, ``eps`` is the
        global batch's (drawn for it on every rank, the same draws) and the
        rank takes its slice. ``mark(label)`` ends the phases ``forward``,
        ``backward``, ``adam``."""
        mark = mark or (lambda name: None)
        dev = self.device
        lidar = lidar.to(dev, torch.float32)
        radar = radar.to(dev, torch.float32)
        ranks = self.mesh.size if self.mesh is not None else 1
        if eps is None:
            eps = torch.rand((lidar.shape[0] * ranks, 1, 1, 1),
                             generator=state.gen, device=dev)
        if self.mesh is not None:
            eps = sharding.shard_batch(eps, self.mesh)

        def critic(x):
            return self.D(x.to(self.cdt))

        def global_critic(x):
            # the global batch's mean: this rank's images weigh 1/N of the
            # global N each
            return critic(x) / ranks if ranks > 1 else critic(x)

        lidar_f = critic(lidar).float()
        radar_f = critic(radar).float()
        # the critic is a batch mean, so the penalty's gradient per image
        # is 1/N of the per-image critic's, as in JAX; N the global batch
        gp = gradient_penalty_at(global_critic, lidar, radar, eps.to(dev),
                                 lam=1.0)
        distance = lidar_f.mean() - radar_f.mean() + self.w_lambda * gp
        mark("forward")
        params = list(state.d.values())
        grads = torch.autograd.grad(distance, params)
        mark("backward")
        adam_step(params, grads, state.opt, self._lr, self._on, b1=0.5,
                  b2=0.9, weight_decay=1e-4, injected=False, mesh=self.mesh)
        mark("adam")
        metrics = sharding.global_means(
            {"w_distance": distance, "lidar_F": lidar_f.mean(),
             "radar_F": radar_f.mean(), "gp": gp}, self.mesh)
        return state, {k: v.detach() for k, v in metrics.items()}
