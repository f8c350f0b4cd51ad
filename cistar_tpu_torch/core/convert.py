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

from typing import Any, Dict, Mapping

import numpy as np
import torch


def conv_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO → OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def conv_transpose_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO with I=in, O=out → PyTorch ConvTranspose2d ``(in, out, kh, kw)``."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def resnet_generator_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """``ResnetGenerator`` params (``init_conv / down_i / res_i/conv{1,2} /
    up_i / out_conv``, each ``{"w", "b"}``) → a ``state_dict`` for
    :class:`cistar_tpu_torch.models.cyclegan.ResnetGenerator`."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, node: Mapping[str, Any], kind: str) -> None:
        w = np.asarray(node["w"], np.float32)
        w = conv_w_from_hwio(w) if kind == "conv" \
            else conv_transpose_w_from_hwio(w)
        sd[f"{name}.weight"] = torch.from_numpy(w)
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(node["b"], np.float32).copy())

    n_blocks = sum(1 for k in params if k.startswith("res_"))
    put("init_conv", params["init_conv"], "conv")
    for i in range(3):
        put(f"down.{i}", params[f"down_{i}"], "conv")
    for i in range(n_blocks):
        for j in (1, 2):
            put(f"res.{i}.conv{j}", params[f"res_{i}"][f"conv{j}"], "conv")
    for i in range(3):
        put(f"up.{i}", params[f"up_{i}"], "convT")
    put("out_conv", params["out_conv"], "conv")
    return sd
