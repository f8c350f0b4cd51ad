"""Checkpoints of the CycleGAN trainer as flat ``.npz`` pytrees (counterpart
of the CycleGAN part of ``cistar_tpu/core/checkpoint.py``).

The reference saves per-epoch ``{epoch}_net{G,D}_*.pth`` plus unversioned
latest copies, and ``--resume`` reloads only the four latest network files
(optimizers restart) (``CycleGAN/train.py:102-107,281-290``). The files are
the JAX package's: one ``.npz`` per network, keys the ``/``-joined paths of
its JAX param tree, HWIO weights. The port writes them through
``core/convert.py``'s ``*_to_jax`` converters and reads them through the
``*_from_jax`` ones, so a checkpoint of either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

_CG_NETS = ["netG_A2B", "netG_B2A", "netD_A", "netD_B"]
_CG_FIELDS = ["g_a2b", "g_b2a", "d_a", "d_b"]


def _flatten(prefix: str, tree: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(key, v))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def save_pytree(path: str, tree: Mapping[str, Any]) -> None:
    flat = {k: np.asarray(v) for k, v in _flatten("", tree).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


def save_cyclegan_state(out_dir: str, engine, epoch: Optional[int] = None
                        ) -> None:
    """The four nets of a :class:`~cistar_tpu_torch.engines.cyclegan.
    CycleGAN`, per epoch and as the latest copies, like
    ``CycleGAN/train.py:281-290``."""
    trees = engine.jax_params()
    for net, field in zip(_CG_NETS, _CG_FIELDS):
        if epoch is not None:
            save_pytree(os.path.join(out_dir, f"{epoch}_{net}.npz"),
                        trees[field])
        save_pytree(os.path.join(out_dir, f"{net}.npz"), trees[field])


def load_cyclegan_state(out_dir: str, engine, state):
    """Reload the four latest nets into ``engine``'s modules, in place
    (``state`` holds the same tensors and is returned); the optimizer state
    restarts, like the reference's ``--resume``. A missing or extra key
    raises."""
    trees = {field: load_pytree(os.path.join(out_dir, f"{net}.npz"))
             for net, field in zip(_CG_NETS, _CG_FIELDS)}
    engine.load_jax_params(**trees)
    return state
