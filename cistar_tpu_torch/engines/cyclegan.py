"""CycleGAN inference engine (counterpart of the inference half of
``cistar_tpu/engines/cyclegan.py::CycleGAN``).

Holds the two generators, G_A2B and G_B2A, and serves
:meth:`CycleGANInference.infer_step` (the plain forward in the compute
dtype) and :meth:`CycleGANInference.infer_step_int8` (the int8-trunk
engine), each returning fake_B, fake_A and recover_B, as
``CycleGAN/test.py:141-145`` does. Only the ResNet generator ('p2p*') is
ported so far; training comes with a later slice.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Tuple

import torch

from cistar_tpu_torch.core.convert import resnet_generator_from_jax
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.models.cyclegan import ResnetGenerator
from cistar_tpu_torch.models.fast_infer import \
    resnet_generator_int8_trunk_apply
from cistar_tpu_torch.ops.quant_int8 import QBlock, quantize_resnet_trunk

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class CycleGANInference:
    """Inference-only CycleGAN with the ResNet generators.

    Weights are random from ``seed`` (the same on every device) until
    :meth:`load_jax_params` replaces them. Inputs are NHWC; outputs are
    fp32 NHWC, as in the JAX engine.
    """

    def __init__(self, gen_type: str = "p2p", input_nc: int = 1,
                 output_nc: int = 1, in_features: int = 16,
                 n_residual_blocks: int = 6,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None):
        if not gen_type.startswith("p2p"):
            raise NotImplementedError(
                f"gen_type={gen_type!r} is not ported yet: the bilinear*, "
                "atrous* and unet* generators come with the slice that ports "
                "the other CycleGAN generator families (ROADMAP queue 1, "
                "item 7); only 'p2p*' (ResNet) runs here")
        self.device = resolve_device(device)
        self.cdt = compute_dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G_a2b = ResnetGenerator(input_nc, output_nc,
                                         n_residual_blocks, in_features)
            self.G_b2a = ResnetGenerator(output_nc, input_nc,
                                         n_residual_blocks, in_features)
        self.G_a2b.to(self.device).eval()
        self.G_b2a.to(self.device).eval()

    def load_jax_params(self, g_a2b: Mapping[str, Any],
                        g_b2a: Mapping[str, Any]) -> None:
        """Load the JAX engine's generator param trees (numpy leaves)."""
        for gen, params in ((self.G_a2b, g_a2b), (self.G_b2a, g_b2a)):
            gen.load_state_dict(resnet_generator_from_jax(params))

    def _gen(self, gen: ResnetGenerator, x: torch.Tensor) -> torch.Tensor:
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
    def quantize_generators(self) -> Tuple[List[QBlock], List[QBlock]]:
        """Static int8 quantization of both generators' residual trunks."""
        return (quantize_resnet_trunk(self.G_a2b),
                quantize_resnet_trunk(self.G_b2a))

    @torch.inference_mode()
    def infer_step_int8(self, q_a2b: List[QBlock], q_b2a: List[QBlock],
                        batch_ab: Tuple[torch.Tensor, torch.Tensor]
                        ) -> Triple:
        """:meth:`infer_step` with both generators' trunks in int8."""
        real_a, real_b = batch_ab

        def gen(g, q, x):
            return resnet_generator_int8_trunk_apply(
                g, q, x.to(self.device, self.cdt)).float()

        fake_b = gen(self.G_a2b, q_a2b, real_a)
        fake_a = gen(self.G_b2a, q_b2a, real_b)
        recover_b = gen(self.G_a2b, q_a2b, (fake_a - 0.5) / 0.5)
        return fake_b, fake_a, recover_b
