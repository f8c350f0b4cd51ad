"""pix2pixHD inference engine (counterpart of the inference half of
``cistar_tpu/engines/p2phd.py::Pix2PixHD``).

Holds one generator, ``netG`` ``global`` (``GlobalGenerator``), ``local``
(``LocalEnhancer``), ``multiscale`` (``MultiscaleGlobalGenerator``, always
BatchNorm) or ``UNet`` (``UNetGeneratorHD``), and serves
:meth:`Pix2PixHDInference.infer_step` (the plain forward in the compute
dtype) and :meth:`Pix2PixHDInference.infer_step_int8` (the family's int8
engine), both after the reference's input encoding
(``pix2pixHD_model.py:119-150``). The discriminators, the other
generators, the feature encoder and training come with later slices
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from cistar_tpu_torch.core.convert import (
    global_generator_from_jax, local_enhancer_from_jax,
    multiscale_global_generator_from_jax, unet_generator_hd_from_jax)
from cistar_tpu_torch.device import DeviceLike, resolve_device
from cistar_tpu_torch.models import fast_infer as fi
from cistar_tpu_torch.models.pix2pixhd import define_g
from cistar_tpu_torch.ops.quant_int8 import QBlock, quantize_global_trunk

# netG → (JAX params → state_dict, quantizer, int8 forward)
_FAMILIES: Dict[str, Tuple[Callable, Callable, Callable]] = {
    "global": (global_generator_from_jax, quantize_global_trunk,
               fi.global_generator_int8_trunk_apply),
    "local": (local_enhancer_from_jax, fi.quantize_local_enhancer,
              fi.local_enhancer_int8_apply),
    "multiscale": (multiscale_global_generator_from_jax,
                   fi.quantize_multiscale_global,
                   fi.multiscale_global_int8_apply),
    "UNet": (unet_generator_hd_from_jax, fi.quantize_unet_msrb,
             fi.unet_msrb_int8_apply),
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
                 device: DeviceLike = None):
        if net_g not in _FAMILIES:
            raise NotImplementedError(
                f"netG={net_g!r} is not ported yet: "
                f"{', '.join(map(repr, _FAMILIES))} run here (ROADMAP "
                "queue 1, item 9)")
        self.net_g = net_g
        self.input_nc, self.output_nc, self.label_nc = input_nc, output_nc, \
            label_nc
        self.r2l, self.no_instance = r2l, no_instance
        self.device = resolve_device(device)
        self.cdt = compute_dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G = define_g(net_g, self.g_input_nc(), output_nc, ngf,
                              n_downsample_global, n_blocks_global,
                              n_local_enhancers, n_blocks_local)
        self.G.to(self.device).eval()
        self._convert, self._quantize, self._int8_fwd = _FAMILIES[net_g]

    def g_input_nc(self) -> int:
        """Channels of the encoded input (``label_input_nc``; no features)."""
        nc = self.label_nc if (self.label_nc != 0 and not self.r2l) \
            else self.input_nc
        return nc + (0 if self.no_instance else 1)

    def load_jax_params(self, g_params: Mapping[str, Any],
                        g_stats: Optional[Mapping[str, Any]] = None) -> None:
        """Load the JAX engine's generator param tree (numpy leaves) and,
        for the BatchNorm family ``multiscale``, its ``batch_stats`` tree
        ``g_stats``, without which it raises ValueError as the JAX engine's
        ``quantize_generator`` does."""
        if self.net_g == "multiscale":
            if g_stats is None:
                raise ValueError(
                    "netG='multiscale' runs BatchNorm: pass g_stats, the "
                    "generator's batch_stats (part of the checkpoint)")
            sd = self._convert(g_params, g_stats)
        else:
            sd = self._convert(g_params)
        self.G.load_state_dict(sd)

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
        return self.G(self.encode_input(label, inst).to(self.cdt)).float()

    @torch.inference_mode()
    def quantize_generator(self) -> List[QBlock]:
        """Static int8 quantization of the generator's trunk
        (``quantize_generator``): the resnet blocks of ``global`` and of
        ``local``'s global trunk, those of ``multiscale`` with the running
        statistics of their BatchNorms folded in, the MSRB blocks of
        ``UNet``."""
        return self._quantize(self.G)

    @torch.inference_mode()
    def infer_step_int8(self, qblocks: List[QBlock], label: torch.Tensor,
                        inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`infer_step` through the family's int8 engine
        (``infer_step_int8``); ``qblocks`` from :meth:`quantize_generator`."""
        x = self.encode_input(label, inst).to(self.cdt)
        return self._int8_fwd(self.G, qblocks, x).float()
