"""JAX param tree (numpy arrays) → the port's ``state_dict``.

The inverse of the JAX package's import path
(``cistar_tpu/core/torch_import.py:44-56`` and
``core/convert_models.py::convert_cyclegan_resnet_generator``), kept as the
port's own copy so the port imports nothing of ``cistar_tpu``:

  * conv weight            HWIO → OIHW              (``transpose(3, 2, 0, 1)``)
  * transpose-conv weight  HWIO (I=in, O=out) → (in, out, kh, kw)
                           (``transpose(2, 3, 0, 1)``, no spatial flip)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def conv_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO → OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def conv_transpose_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO with I=in, O=out → PyTorch ConvTranspose2d ``(in, out, kh, kw)``."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def _torch_key(path: Tuple[str, ...]) -> str:
    """JAX module path → ``state_dict`` prefix: ``down_i`` / ``res_i`` /
    ``up_i`` become ``down.i`` / ``res.i`` / ``up.i`` (a ``ModuleList``);
    every other name is kept."""
    parts = []
    for p in path:
        stem, _, idx = p.rpartition("_")
        parts += [stem, idx] if stem in ("down", "res", "up") and idx.isdigit() \
            else [p]
    return ".".join(parts)


def _conv_nodes(params: Mapping[str, Any], path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Mapping[str, Any]]]:
    """Every ``{"w", "b"}`` node of a param tree, with its path."""
    for k, v in params.items():
        if "w" in v:
            yield path + (k,), v
        else:
            yield from _conv_nodes(v, path + (k,))


def generator_from_jax(params: Mapping[str, Any],
                       transposed: Callable[[Tuple[str, ...]], bool]
                       = lambda path: False) -> Dict[str, torch.Tensor]:
    """A generator's JAX params → ``state_dict`` of its port counterpart
    (:mod:`cistar_tpu_torch.models.cyclegan`). ``transposed(path)`` says
    which nodes are transpose convs. A ``MultiscaleBilinearGenerator``
    (``init_conv``, ``down_i/b{j}_conv``, ``res_i/atrous/b{j}_conv``,
    ``res_i/conv``, ``up_i/conv``, ``out_conv``) has none."""
    sd: Dict[str, torch.Tensor] = {}
    for path, node in _conv_nodes(params):
        w = np.asarray(node["w"], np.float32)
        w = conv_transpose_w_from_hwio(w) if transposed(path) \
            else conv_w_from_hwio(w)
        key = _torch_key(path)
        sd[f"{key}.weight"] = torch.from_numpy(w)
        sd[f"{key}.bias"] = torch.from_numpy(
            np.asarray(node["b"], np.float32).copy())
    return sd


def resnet_generator_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """``ResnetGenerator`` params (``init_conv / down_i / res_i/conv{1,2} /
    up_i / out_conv``, each ``{"w", "b"}``; ``up_i`` transpose convs) → a
    ``state_dict`` for :class:`~cistar_tpu_torch.models.cyclegan.
    ResnetGenerator`."""
    return generator_from_jax(
        params, lambda path: len(path) == 1 and path[0].startswith("up_"))
