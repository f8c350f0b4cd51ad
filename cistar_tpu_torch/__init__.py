"""PyTorch / CUDA port of ``cistar_tpu`` for NVIDIA Hopper (H100, sm_90a).

The layout mirrors the JAX package so each module's counterpart is found
under the same path:

  * ``ops/nn.py``, ``ops/blocks.py``   NHWC primitives and ``nn.Module`` blocks
  * ``ops/quant_int8.py``              int8 quantizers and the plain versions
                                       of the fused int8 blocks K1/K2/K5/K6
  * ``ops/head_conv.py``               the generator head (IN+ReLU → 7×7 → tanh)
  * ``models/cyclegan.py``             ``ResnetGenerator``,
                                       ``MultiscaleBilinearGenerator``
  * ``models/fast_infer.py``           their int8 inference engines
  * ``engines/cyclegan.py``            inference engine holding G_A2B / G_B2A
  * ``core/convert.py``                JAX param tree (numpy) → ``state_dict``
  * ``kernels/``, ``csrc/``            the hand-written CUDA kernels and their
                                       ``nvcc`` build

Public functions take and return NHWC tensors, as the JAX package's do.
Entry points take ``device=None``, which means CUDA (see :mod:`.device`).
"""

from cistar_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
