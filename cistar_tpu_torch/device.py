"""The port's device rule: entry points run on the GPU unless told otherwise.

``device=None`` means ``cuda``. Without a GPU that raises: the port never
falls back to the CPU by itself. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is present); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cistar_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
