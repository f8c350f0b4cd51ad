"""Checkpoints of the trainers as flat ``.npz`` pytrees (counterpart of
``cistar_tpu/core/checkpoint.py``, less its Orbax backend).

  * CycleGAN saves per-epoch ``{epoch}_net{G,D}_*.npz`` plus unversioned
    latest copies, and ``--resume`` reloads only the four latest network
    files (optimizers restart) (``CycleGAN/train.py:102-107,281-290``).
  * pix2pixHD saves ``{epoch}_net_{label}.npz`` under
    ``checkpoints/<name>/`` (:func:`save_network`), loads them tolerantly
    (:func:`load_network`, ``p2pHD/models/base_model.py:42-88``) and keeps
    ``iter.txt`` with ``epoch,iter`` for a crash resume
    (:func:`save_iter` / :func:`load_iter`, ``p2pHD/train.py:40-46,138-141``).

The files are the JAX package's: one ``.npz`` per network, keys the
``/``-joined paths of its JAX param tree, HWIO weights. The port writes them
through ``core/convert.py``'s ``*_to_jax`` converters and reads them
through the ``*_from_jax`` ones, so a checkpoint of either package loads in
the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

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


# --------------------------------------------------------------------------- #
# pix2pixHD labelled checkpoints + iter.txt resume
# --------------------------------------------------------------------------- #
def merge_partial(init_params: Mapping[str, Any], loaded: Mapping[str, Any]
                  ) -> Dict[str, Any]:
    """Tolerant merge: take loaded values where the key exists and shapes
    match (``core/torch_import.py::merge_partial``, the drift-tolerant load
    of ``p2pHD/models/base_model.py:50-88``): missing keys keep their
    initial values, extra keys are dropped, and size-mismatched tensors are
    skipped."""
    flat_init = _flatten("", init_params)
    merged = dict(flat_init)
    for k, v in _flatten("", loaded).items():
        if k in flat_init and np.shape(v) == np.shape(flat_init[k]):
            merged[k] = v
    return _unflatten(merged)


def save_network(save_dir: str, label: str, epoch_label,
                 tree: Mapping[str, Any]) -> None:
    """``{epoch}_net_{label}.npz`` under ``save_dir`` (p2pHD layout)."""
    save_pytree(os.path.join(save_dir, f"{epoch_label}_net_{label}.npz"),
                tree)


def load_network(save_dir: str, label: str, epoch_label,
                 like: Mapping[str, Any], strict: bool = False
                 ) -> Dict[str, Any]:
    """The tree of ``{epoch}_net_{label}.npz`` in the structure, shapes
    and dtypes of ``like`` (a JAX-layout tree of numpy arrays). ``strict``
    raises on a missing key; otherwise the load is :func:`merge_partial`'s."""
    path = os.path.join(save_dir, f"{epoch_label}_net_{label}.npz")
    loaded = load_pytree(path)
    flat_t = _flatten("", like)
    if strict:
        missing = set(flat_t) - set(_flatten("", loaded))
        if missing:
            raise ValueError(f"checkpoint {path} missing keys: "
                             f"{sorted(missing)[:5]} ...")
    flat_m = _flatten("", merge_partial(like, loaded))
    return _unflatten({k: np.asarray(flat_m[k]).astype(
        np.asarray(flat_t[k]).dtype) for k in flat_t})


def save_iter(save_dir: str, epoch: int, it: int) -> None:
    """``iter.txt``: ``epoch,iter`` of the next step to run."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "iter.txt"), "w") as f:
        f.write(f"{epoch},{it}")


def load_iter(save_dir: str) -> Tuple[int, int]:
    """``(epoch, iter)`` from ``iter.txt``; ``(1, 0)`` without one."""
    path = os.path.join(save_dir, "iter.txt")
    if not os.path.exists(path):
        return 1, 0
    with open(path) as f:
        epoch, it = f.read().strip().split(",")
    return int(epoch), int(it)
