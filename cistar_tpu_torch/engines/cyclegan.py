"""CycleGAN engines (counterpart of ``cistar_tpu/engines/cyclegan.py``).

:class:`CycleGANInference` holds the two generators, G_A2B and G_B2A, and
serves :meth:`~CycleGANInference.infer_step` (the plain forward in the
compute dtype) and :meth:`~CycleGANInference.infer_step_int8` (the
family's int8 engine), each returning fake_B, fake_A and recover_B, as
``CycleGAN/test.py:141-145`` does. :class:`CycleGAN` adds the two
discriminators and the train step of the reference loop
(``CycleGAN/train.py:171-272``): per batch, a skip of sparse radar frames
(< 300 points), a generator step (identity + GAN×10 + cycle×2 losses over
both directions), then two discriminator steps each gated on ``loss_D >
0.1``, with 50-image replay pools feeding D, Adam(lr 2e-4, β=(0.5, 0.999))
×3 and per-epoch linear LR decay (``LambdaLR``, ``CycleGAN/utils.py:116-124``).
All four generator families are ported: ResNet ('p2p*'),
``MultiscaleBilinear`` ('bilinear*', the default), ``Multiscale`` /
``MultiscaleDenseDecoder`` ('atrous*', by ``dense_decoder``) and ``Unet``
('unet*').

The train step runs the plain ops under autograd; no CUDA kernel of the
port is on it (they are forward-only). The skip and the D gates are masked
updates on device bools, as in the JAX step, so a step reads nothing back
to the host.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import torch

from cistar_tpu_torch.core.convert import (generator_from_jax,
                                           generator_to_jax,
                                           patch_discriminator_from_jax,
                                           patch_discriminator_to_jax,
                                           resnet_generator_from_jax,
                                           resnet_generator_to_jax)
from cistar_tpu_torch.core.optim import AdamState, adam_step
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.losses.gan import count_points, l1_loss, lsgan_loss
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.cyclegan import (PatchDiscriminator,
                                              build_generator)
from cistar_tpu_torch.ops.quant_int8 import QBlock, quantize_resnet_trunk
from cistar_tpu_torch.parallel import sharding
from cistar_tpu_torch.parallel.sharding import Mesh, global_means
from cistar_tpu_torch.utils.image_pool import (PoolState, init_pool,
                                               sharded_push_and_pop)

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
QGen = Union[List[QBlock], fi.QTrunk]

# family prefix → (JAX params → state_dict, quantizer, int8 forward), as
# the JAX engine dispatches them (quantize_generators, _int8_fwd)
_FAMILIES: Dict[str, Tuple[Callable, Callable, Callable]] = {
    "p2p": (resnet_generator_from_jax, quantize_resnet_trunk,
            fi.resnet_generator_int8_trunk_apply),
    "bilinear": (generator_from_jax, fi.quantize_bilinear_trunk,
                 fi.bilinear_generator_int8_trunk_apply),
    "atrous": (generator_from_jax, fi.quantize_multiscale_trunk,
               fi.multiscale_generator_int8_trunk_apply),
    "unet": (generator_from_jax, fi.quantize_unet_trunk,
             fi.unet_generator_int8_trunk_apply),
}


class CycleGANInference:
    """Inference-only CycleGAN with one of the ported generator families.

    Weights are random from ``seed`` (the same on every device) until
    :meth:`load_jax_params` replaces them. Inputs are NHWC; outputs are
    fp32 NHWC, as in the JAX engine. ``dense_decoder`` picks the 'atrous*'
    decoder, as ``build_generator`` does; the other families ignore it.
    """

    def __init__(self, gen_type: str = "bilinear_content", input_nc: int = 1,
                 output_nc: int = 1, in_features: int = 16,
                 n_residual_blocks: int = 6,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None, dense_decoder: bool = True):
        self.dense_decoder = dense_decoder
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G_a2b = self._build(gen_type, input_nc, output_nc,
                                     in_features, n_residual_blocks)
            self.G_b2a = self._build(gen_type, output_nc, input_nc,
                                     in_features, n_residual_blocks)
        self.device = resolve_device(device)
        self.cdt = compute_dtype
        self._convert, self._quantize, self._int8_fwd = next(
            v for k, v in _FAMILIES.items() if gen_type.startswith(k))
        self.G_a2b.to(self.device).eval()
        self.G_b2a.to(self.device).eval()

    def _build(self, gen_type: str, input_nc: int, output_nc: int,
               in_features: int, n_residual_blocks: int) -> torch.nn.Module:
        return build_generator(gen_type, input_nc, output_nc, in_features,
                               n_residual_blocks, self.dense_decoder)

    def load_jax_params(self, g_a2b: Mapping[str, Any],
                        g_b2a: Mapping[str, Any]) -> None:
        """Load the JAX engine's generator param trees (numpy leaves)."""
        for gen, params in ((self.G_a2b, g_a2b), (self.G_b2a, g_b2a)):
            gen.load_state_dict(self._convert(params))

    def _gen(self, gen, x: torch.Tensor) -> torch.Tensor:
        return gen(x.to(self.device, self.cdt)).float()

    @torch.inference_mode()
    def infer_step(self, real_a: torch.Tensor, real_b: torch.Tensor
                   ) -> Triple:
        """fake_B, fake_A and recover_B = G_A2B(Normalize(0.5, 0.5)(fake_A))."""
        fake_b = self._gen(self.G_a2b, real_a)
        fake_a = self._gen(self.G_b2a, real_b)
        recover_b = self._gen(self.G_a2b, (fake_a - 0.5) / 0.5)
        return fake_b, fake_a, recover_b

    @torch.inference_mode()
    def quantize_generators(self) -> Tuple[QGen, QGen]:
        """Static int8 quantization of both generators, by family: the
        ResNet and 'unet' trunks' residual blocks; the bilinear generator's
        atrous residual blocks and encoder stages; the 'atrous' generators'
        residual blocks and encoder stages."""
        return self._quantize(self.G_a2b), self._quantize(self.G_b2a)

    def _gen_int8(self, gen, q: QGen, x: torch.Tensor) -> torch.Tensor:
        return self._int8_fwd(gen, q, x.to(self.device, self.cdt)).float()

    @torch.inference_mode()
    def infer_step_int8(self, q_a2b: QGen, q_b2a: QGen,
                        batch_ab: Tuple[torch.Tensor, torch.Tensor]
                        ) -> Triple:
        """:meth:`infer_step` through both generators' int8 engines."""
        real_a, real_b = batch_ab
        fake_b = self._gen_int8(self.G_a2b, q_a2b, real_a)
        fake_a = self._gen_int8(self.G_b2a, q_b2a, real_b)
        recover_b = self._gen_int8(self.G_a2b, q_a2b, (fake_a - 0.5) / 0.5)
        return fake_b, fake_a, recover_b

    # -- the sharded inference program (the deployment unit) -----------------
    def program_args(self, engine: str = "bf16") -> Tuple[Any, ...]:
        """The leading arguments of :class:`InferProgram`, in the JAX order:
        ``bf16``: (g_a2b, g_b2a), each generator's parameters by name;
        ``int8``: the same, then both generators' quantized trunks."""
        weights = tuple({k: v.detach() for k, v in g.named_parameters()}
                        for g in (self.G_a2b, self.G_b2a))
        if engine == "int8":
            return weights + self.quantize_generators()
        return weights

    def make_sharded_infer(self, mesh: Mesh, engine: str = "bf16",
                           program: Optional[Callable] = None) -> Callable:
        """Batch-sharded inference over ``mesh`` (the JAX
        ``make_sharded_infer``, ``CycleGAN/test.py:141-145`` semantics):
        ``bf16``: ``f(g_a2b, g_b2a, a, b)``; ``int8``: ``f(g_a2b, g_b2a,
        q_a2b, q_b2a, a, b)``, each on the global batch ``a`` / ``b`` and
        returning the global ``(fake_b, fake_a, recover_b)``: every rank
        runs the per-rank ``program`` (default :class:`InferProgram`, or a
        loaded export of one) on its slice, then gathers the three outputs
        in rank order. No other collective: instance norm is per image.
        The per-rank program is the returned function's ``program``. The
        JAX program's int8 body is the ResNet engine whatever the family;
        here it is the engine's own family, the same at 'p2p*'."""
        if engine not in ("bf16", "int8"):
            raise ValueError(f"engine must be 'bf16' or 'int8', got "
                             f"{engine!r}")
        prog = program if program is not None \
            else InferProgram(self, engine == "int8")

        @torch.inference_mode()
        def infer(*args):
            *weights, a, b = args
            outs = prog(*weights, sharding.shard_batch(a, mesh),
                        sharding.shard_batch(b, mesh))
            return tuple(sharding.all_gather_batch(o, mesh) for o in outs)

        infer.program = prog
        return infer


class _Gen(torch.nn.Module):
    """One generator call of :class:`InferProgram`: the plain forward, or
    the family's int8 forward, in the engine's compute dtype, fp32 out."""

    def __init__(self, engine: CycleGANInference, gen: torch.nn.Module,
                 int8: bool):
        super().__init__()
        self.gen, self.engine, self.int8 = gen, engine, int8

    def forward(self, x: torch.Tensor, q: Optional[QGen] = None
                ) -> torch.Tensor:
        if self.int8:
            return self.engine._gen_int8(self.gen, q, x)
        return self.engine._gen(self.gen, x)


class InferProgram(torch.nn.Module):
    """The per-rank program of :meth:`CycleGANInference.make_sharded_infer`,
    the module that ``cyclegan_test --export_engine`` exports: ``forward(
    g_a2b, g_b2a, a, b)`` (``int8``: ``forward(g_a2b, g_b2a, q_a2b, q_b2a,
    a, b)``) → ``(fake_b, fake_a, recover_b)``, the generators run with the
    given parameters (``torch.func.functional_call``). The generators are
    held outside the module's registry, so an export of it holds no
    weights: they are its arguments, as in JAX."""

    def __init__(self, engine: CycleGANInference, int8: bool):
        super().__init__()
        self.int8 = int8
        self._gens = (_Gen(engine, engine.G_a2b, int8),
                      _Gen(engine, engine.G_b2a, int8))

    @staticmethod
    def _call(gen: _Gen, params, x, q):
        return torch.func.functional_call(
            gen, {f"gen.{k}": v for k, v in params.items()}, (x, q))

    def forward(self, g_a2b, g_b2a, *rest):
        q_a2b, q_b2a, a, b = rest if self.int8 else (None, None, *rest)
        a2b, b2a = self._gens
        fake_b = self._call(a2b, g_a2b, a, q_a2b)
        fake_a = self._call(b2a, g_b2a, b, q_b2a)
        recover_b = self._call(a2b, g_a2b, (fake_a - 0.5) / 0.5, q_a2b)
        return fake_b, fake_a, recover_b


# family prefix → the port's generator state_dict → JAX params
_TO_JAX: Dict[str, Callable] = {"p2p": resnet_generator_to_jax,
                                "bilinear": generator_to_jax,
                                "atrous": generator_to_jax,
                                "unet": generator_to_jax}

Params = Dict[str, torch.Tensor]


def lambda_lr_factor(epoch: torch.Tensor, n_epochs: int, start_epoch: int,
                     decay_epoch: int) -> torch.Tensor:
    """``LambdaLR.step`` (``CycleGAN/utils.py:116-124``): linear decay to 0
    from ``decay_epoch`` to ``n_epochs``, on ``epoch``'s device."""
    if n_epochs <= decay_epoch:      # no decay phase (avoid 0/0)
        return torch.ones((), dtype=torch.float32, device=epoch.device)
    e = epoch.float()
    # floor at 0 so stepping past n_epochs can never flip the lr negative
    return torch.clamp(
        1.0 - torch.clamp(e + start_epoch - decay_epoch, min=0.0)
        / (n_epochs - decay_epoch), min=0.0)


class CycleGANState(NamedTuple):
    """The four nets' params (the modules' own ``Parameter`` tensors, by
    name), the three Adam states, both pools, the pools' device generator
    and the epoch (int32 device scalar, drives the LR schedule)."""
    g_a2b: Params
    g_b2a: Params
    d_a: Params
    d_b: Params
    opt_g: AdamState
    opt_d_a: AdamState
    opt_d_b: AdamState
    pool_a: PoolState
    pool_b: PoolState
    pool_gen: torch.Generator
    epoch: torch.Tensor


class CycleGAN(CycleGANInference):
    """The CycleGAN trainer: G_A2B, G_B2A, D_A, D_B, three Adam states and
    two replay pools. :meth:`train_step` is the JAX engine's step, op for
    op, in eager PyTorch; :meth:`infer_step` serves the current params.

    The step updates the state's tensors in place and returns the state
    (the JAX step donates its state). Weights come from ``seed`` through
    :meth:`init_state`, the same on every device.

    With ``mesh`` (:func:`~cistar_tpu_torch.parallel.sharding.make_mesh`)
    each process steps on its slice of the global batch and the step is the
    JAX program's over the whole batch: the skip gate counts the points of
    the global batch, the gradients are averaged over ranks before Adam,
    the D gates read the global ``loss_D``, the pools run on the gathered
    fakes (:func:`~cistar_tpu_torch.utils.image_pool.sharded_push_and_pop`)
    and the metrics are global means."""

    def __init__(self, gen_type: str = "bilinear_content", input_nc: int = 1,
                 output_nc: int = 1, in_features: int = 16,
                 n_residual_blocks: int = 6, lr: float = 2e-4,
                 n_epochs: int = 10, start_epoch: int = 0,
                 decay_epoch: int = 9, pool_size: int = 50,
                 image_size: int = 512, batch_size: int = 4,
                 cycle_criterion: Optional[Callable] = None,
                 gan_weight: float = 10.0, cycle_weight: float = 2.0,
                 identity_weight: float = 1.0, min_points: float = 300.0,
                 d_loss_floor: float = 0.1,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None, dense_decoder: bool = True,
                 mesh: Optional[Mesh] = None):
        super().__init__(gen_type, input_nc, output_nc, in_features,
                         n_residual_blocks, compute_dtype, seed, device,
                         dense_decoder)
        self.mesh = mesh
        self.gen_type = gen_type
        self.input_nc, self.output_nc = input_nc, output_nc
        self.in_features = in_features
        self.n_residual_blocks = n_residual_blocks
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.D_a = PatchDiscriminator(input_nc).to(self.device)
            self.D_b = PatchDiscriminator(output_nc).to(self.device)
        self.lr, self.n_epochs = lr, n_epochs
        self.start_epoch, self.decay_epoch = start_epoch, decay_epoch
        self.pool_size, self.image_size = pool_size, image_size
        self.batch_size = batch_size
        self.criterion = cycle_criterion or l1_loss
        self.gan_w, self.cycle_w = gan_weight, cycle_weight
        self.id_w = identity_weight
        self.min_points, self.d_floor = min_points, d_loss_floor
        self._to_jax = next(v for k, v in _TO_JAX.items()
                            if gen_type.startswith(k))

    def _nets(self) -> Tuple[torch.nn.Module, ...]:
        return self.G_a2b, self.G_b2a, self.D_a, self.D_b

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0, image_size: Optional[int] = None
                   ) -> CycleGANState:
        """Fresh weights from ``seed`` (drawn on the CPU, so the same on
        every device), zero Adam states, empty pools."""
        size = image_size or self.image_size
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = (self._build(self.gen_type, self.input_nc,
                                 self.output_nc, self.in_features,
                                 self.n_residual_blocks),
                     self._build(self.gen_type, self.output_nc,
                                 self.input_nc, self.in_features,
                                 self.n_residual_blocks),
                     PatchDiscriminator(self.input_nc),
                     PatchDiscriminator(self.output_nc))
        for net, f in zip(self._nets(), fresh):
            net.load_state_dict(f.state_dict())
        g_a2b, g_b2a, d_a, d_b = (dict(n.named_parameters())
                                  for n in self._nets())
        dev = self.device
        return CycleGANState(
            g_a2b=g_a2b, g_b2a=g_b2a, d_a=d_a, d_b=d_b,
            opt_g=AdamState([*g_a2b.values(), *g_b2a.values()]),
            opt_d_a=AdamState(list(d_a.values())),
            opt_d_b=AdamState(list(d_b.values())),
            pool_a=init_pool(self.pool_size, (size, size, self.input_nc), dev),
            pool_b=init_pool(self.pool_size, (size, size, self.output_nc),
                             dev),
            pool_gen=torch.Generator(device=dev).manual_seed(seed),
            epoch=torch.full((), self.start_epoch, dtype=torch.int32,
                             device=dev))

    def load_jax_params(self, g_a2b: Mapping[str, Any],
                        g_b2a: Mapping[str, Any], d_a: Mapping[str, Any],
                        d_b: Mapping[str, Any]) -> None:
        """Load the JAX engine's four param trees (numpy leaves) into the
        nets, in place: a state from :meth:`init_state` sees them."""
        super().load_jax_params(g_a2b, g_b2a)
        for net, params in ((self.D_a, d_a), (self.D_b, d_b)):
            net.load_state_dict(patch_discriminator_from_jax(params))

    def jax_params(self) -> Dict[str, Dict[str, Any]]:
        """The four nets as JAX param trees (numpy fp32 leaves), keyed as
        the JAX ``CycleGANState`` fields."""
        return {"g_a2b": self._to_jax(self.G_a2b.state_dict()),
                "g_b2a": self._to_jax(self.G_b2a.state_dict()),
                "d_a": patch_discriminator_to_jax(self.D_a.state_dict()),
                "d_b": patch_discriminator_to_jax(self.D_b.state_dict())}

    def next_epoch(self, state: CycleGANState) -> CycleGANState:
        return state._replace(epoch=state.epoch + 1)

    # -- the step ------------------------------------------------------------
    def _disc(self, net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        return net(x.to(self.cdt)).float()

    def _g_losses(self, real_a: torch.Tensor, real_b: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The generator objective with the current D (JAX ``g_loss_fn``).
        The identity and translation passes through one generator are one
        call on the concatenated batch (instance norm is per image)."""
        bs = real_a.shape[0]
        ab = self._gen(self.G_a2b, torch.cat([real_b, real_a]))
        same_b, fake_b = ab[:bs], ab[bs:]
        loss_id_b = self.criterion(same_b, real_b) * self.id_w
        ba = self._gen(self.G_b2a, torch.cat([real_a, real_b]))
        same_a, fake_a = ba[:bs], ba[bs:]
        loss_id_a = self.criterion(same_a, real_a) * self.id_w

        loss_gan_a2b = lsgan_loss(self._disc(self.D_b, fake_b), True) \
            * self.gan_w
        loss_gan_b2a = lsgan_loss(self._disc(self.D_a, fake_a), True) \
            * self.gan_w

        rec_a = self._gen(self.G_b2a, fake_b)
        loss_cyc_aba = self.criterion(rec_a, real_a) * self.cycle_w
        rec_b = self._gen(self.G_a2b, fake_a)
        loss_cyc_bab = self.criterion(rec_b, real_b) * self.cycle_w

        total = (loss_id_a + loss_id_b + loss_gan_a2b + loss_gan_b2a
                 + loss_cyc_aba + loss_cyc_bab)
        return {"fake_a": fake_a, "fake_b": fake_b, "loss_G": total,
                "loss_G_identity": loss_id_a + loss_id_b,
                "loss_G_GAN": loss_gan_a2b + loss_gan_b2a,
                "loss_G_cycle": loss_cyc_aba + loss_cyc_bab}

    def _d_step(self, net: torch.nn.Module, params: Params, opt: AdamState,
                real: torch.Tensor, fake_hist: torch.Tensor,
                lr: torch.Tensor, do_step: torch.Tensor) -> torch.Tensor:
        """One discriminator step on ``cat([real, fake_hist])``, gated on
        ``loss_D > d_loss_floor`` (the pre-update loss) and the skip."""
        preds = self._disc(net, torch.cat([real, fake_hist]))
        n = real.shape[0]
        loss_d = (lsgan_loss(preds[:n], True)
                  + lsgan_loss(preds[n:], False)) * 0.5
        plist = list(params.values())
        grads = torch.autograd.grad(loss_d, plist)
        loss_d = sharding.all_reduce_mean(loss_d.detach(), self.mesh)
        adam_step(plist, grads, opt, lr, (loss_d > self.d_floor) & do_step,
                  mesh=self.mesh)
        return loss_d

    @torch.enable_grad()
    def train_step(self, state: CycleGANState, real_a: torch.Tensor,
                   real_b: torch.Tensor,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Tuple[CycleGANState, Dict[str, torch.Tensor]]:
        """One step on an NHWC batch in [-1, 1]; metrics are device
        scalars. ``mark(label)``, when given, is called at the end of each
        phase (``g_forward``, ``g_backward``, ``g_adam``, ``pools``,
        ``d_a``, ``d_b``), for a per-phase timing."""
        mark = mark or (lambda label: None)
        real_a = real_a.to(self.device, torch.float32)
        real_b = real_b.to(self.device, torch.float32)
        do_step = count_points(real_a, self.mesh) >= self.min_points
        lr_now = self.lr * lambda_lr_factor(
            state.epoch, self.n_epochs, self.start_epoch, self.decay_epoch)

        # ---- generator update: grads for G only; D's params are not
        # inputs of the grad, so they get none (and no .grad is left) ----
        aux = self._g_losses(real_a, real_b)
        mark("g_forward")
        g_params = [*state.g_a2b.values(), *state.g_b2a.values()]
        g_grads = torch.autograd.grad(aux["loss_G"], g_params)
        mark("g_backward")
        adam_step(g_params, g_grads, state.opt_g, lr_now, do_step,
                  mesh=self.mesh)
        mark("g_adam")

        # ---- replay pools (updated only on active steps) ------------------
        pool_a, fake_a_hist = sharded_push_and_pop(
            state.pool_a, aux.pop("fake_a").detach(), state.pool_gen,
            self.mesh, do_step)
        pool_b, fake_b_hist = sharded_push_and_pop(
            state.pool_b, aux.pop("fake_b").detach(), state.pool_gen,
            self.mesh, do_step)
        mark("pools")

        # ---- discriminator updates (gated on the loss floor) --------------
        loss_d_a = self._d_step(self.D_a, state.d_a, state.opt_d_a, real_a,
                                fake_a_hist, lr_now, do_step)
        mark("d_a")
        loss_d_b = self._d_step(self.D_b, state.d_b, state.opt_d_b, real_b,
                                fake_b_hist, lr_now, do_step)
        mark("d_b")

        metrics = global_means({k: v.detach() for k, v in aux.items()},
                               self.mesh)
        metrics.update({"loss_D_A": loss_d_a, "loss_D_B": loss_d_b,
                        "loss_D": loss_d_a + loss_d_b,
                        "skipped": 1.0 - do_step.float()})
        return state._replace(pool_a=pool_a, pool_b=pool_b), metrics
