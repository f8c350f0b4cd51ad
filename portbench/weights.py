"""Weights from the run's seed, made on the device in one call: N(0, 0.02)
for every weight, zero biases, float32 (the type the program keeps its
parameters in), in the order of the reference's parameter list. The same
seed on the same device gives the same values, so the reference draws
them again after the program is gone."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.p2phd import Spec


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [torch.Size(s).numel() for n, s in spec if n.endswith("weight")]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    out, o = {}, 0
    for name, shape in spec:
        if name.endswith("weight"):
            k = torch.Size(shape).numel()
            out[name] = flat[o:o + k].view(shape)
            o += k
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``values`` into ``module``'s parameters, which must have the
    same names and shapes, no more and no fewer."""
    params = dict(module.named_parameters())
    mine = {k: tuple(v.shape) for k, v in params.items()}
    theirs = {k: tuple(v.shape) for k, v in values.items()}
    if mine != theirs:
        raise RuntimeError(
            "the program's parameters differ from the reference's: "
            f"only in the program {sorted(set(mine) - set(theirs))[:5]}, "
            f"only in the reference {sorted(set(theirs) - set(mine))[:5]}, "
            f"shapes {[(k, mine[k], theirs[k]) for k in mine
                       if k in theirs and mine[k] != theirs[k]][:5]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(values[k])
