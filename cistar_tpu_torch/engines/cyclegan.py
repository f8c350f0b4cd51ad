"""CycleGAN inference engine (counterpart of the inference half of
``cistar_tpu/engines/cyclegan.py::CycleGAN``).

Holds the two generators, G_A2B and G_B2A, and serves
:meth:`CycleGANInference.infer_step` (the plain forward in the compute
dtype) and :meth:`CycleGANInference.infer_step_int8` (the family's int8
engine), each returning fake_B, fake_A and recover_B, as
``CycleGAN/test.py:141-145`` does. The ResNet ('p2p*') and
``MultiscaleBilinear`` ('bilinear*', the default) generators are ported;
training comes with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

import torch

from cistar_tpu_torch.core.convert import (generator_from_jax,
                                           resnet_generator_from_jax)
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.cyclegan import build_generator
from cistar_tpu_torch.ops.quant_int8 import QBlock, quantize_resnet_trunk

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
QGen = Union[List[QBlock], fi.QTrunk]

# family prefix → (JAX params → state_dict, quantizer, int8 forward)
_FAMILIES: Dict[str, Tuple[Callable, Callable, Callable]] = {
    "p2p": (resnet_generator_from_jax, quantize_resnet_trunk,
            fi.resnet_generator_int8_trunk_apply),
    "bilinear": (generator_from_jax, fi.quantize_bilinear_trunk,
                 fi.bilinear_generator_int8_trunk_apply),
}


class CycleGANInference:
    """Inference-only CycleGAN with one of the ported generator families.

    Weights are random from ``seed`` (the same on every device) until
    :meth:`load_jax_params` replaces them. Inputs are NHWC; outputs are
    fp32 NHWC, as in the JAX engine.
    """

    def __init__(self, gen_type: str = "bilinear_content", input_nc: int = 1,
                 output_nc: int = 1, in_features: int = 16,
                 n_residual_blocks: int = 6,
                 compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device: DeviceLike = None):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G_a2b = build_generator(gen_type, input_nc, output_nc,
                                         in_features, n_residual_blocks)
            self.G_b2a = build_generator(gen_type, output_nc, input_nc,
                                         in_features, n_residual_blocks)
        self.device = resolve_device(device)
        self.cdt = compute_dtype
        self._convert, self._quantize, self._int8_fwd = next(
            v for k, v in _FAMILIES.items() if gen_type.startswith(k))
        self.G_a2b.to(self.device).eval()
        self.G_b2a.to(self.device).eval()

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
        ResNet trunk's residual blocks; the bilinear generator's atrous
        residual blocks and encoder stages."""
        return self._quantize(self.G_a2b), self._quantize(self.G_b2a)

    @torch.inference_mode()
    def infer_step_int8(self, q_a2b: QGen, q_b2a: QGen,
                        batch_ab: Tuple[torch.Tensor, torch.Tensor]
                        ) -> Triple:
        """:meth:`infer_step` through both generators' int8 engines."""
        real_a, real_b = batch_ab

        def gen(g, q, x):
            return self._int8_fwd(g, q, x.to(self.device, self.cdt)).float()

        fake_b = gen(self.G_a2b, q_a2b, real_a)
        fake_a = gen(self.G_b2a, q_b2a, real_b)
        recover_b = gen(self.G_a2b, q_a2b, (fake_a - 0.5) / 0.5)
        return fake_b, fake_a, recover_b
