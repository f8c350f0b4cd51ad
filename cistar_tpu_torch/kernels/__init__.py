"""The port's hand-written CUDA kernels: their ``nvcc`` build
(:mod:`.build`), one ``ctypes`` wrapper module per source, and the
``cistar`` custom ops over them (:mod:`.custom_ops`), registered when this
package is imported."""

from cistar_tpu_torch.kernels import custom_ops  # noqa: F401
