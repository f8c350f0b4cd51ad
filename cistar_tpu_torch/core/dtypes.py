"""Dtype policies (counterpart of ``cistar_tpu/core/dtypes.py``).

The reference runs fp32, with optional apex AMP O1 / fp16 inference
(``p2pHD/train.py:66-68``, ``p2pHD/test.py:45-48``). The port's fast
dtype is bfloat16 with fp32 accumulation, as the JAX package's:

  * parameters, optimizer state:        float32
  * activations / matmul inputs:        bfloat16 (policy "bf16") or float32
  * normalization statistics, losses:   float32 always

:func:`get_policy` takes JAX's three names.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_map


def _cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Compute / parameter dtype pair, named like JMP policies."""

    compute_dtype: torch.dtype
    param_dtype: torch.dtype

    def cast_to_compute(self, tree):
        """Every floating tensor of a pytree in the compute dtype; the
        rest as it is."""
        return _cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        """Every floating tensor of a pytree in the parameter dtype."""
        return _cast(tree, self.param_dtype)


_POLICIES = {
    "fp32": Policy(torch.float32, torch.float32),
    "bf16": Policy(torch.bfloat16, torch.float32),
    "full_bf16": Policy(torch.bfloat16, torch.bfloat16),
}


def get_policy(name: str) -> Policy:
    """A policy by name: "fp32", "bf16" (the default for training and
    inference), "full_bf16"."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown dtype policy {name!r}; options: "
                         f"{sorted(_POLICIES)}")
