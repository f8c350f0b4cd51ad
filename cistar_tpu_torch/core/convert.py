"""JAX param tree (numpy arrays) ↔ the port's ``state_dict``.

The ``*_from_jax`` functions are the inverse of the JAX package's import path
(``cistar_tpu/core/torch_import.py:44-56`` and
``core/convert_models.py::convert_cyclegan_resnet_generator``), kept as the
port's own copy so the port imports nothing of ``cistar_tpu``:

  * conv weight            HWIO → OIHW              (``transpose(3, 2, 0, 1)``)
  * transpose-conv weight  HWIO (I=in, O=out) → (in, out, kh, kw)
                           (``transpose(2, 3, 0, 1)``, no spatial flip)
  * BatchNorm, affine IN   ``gamma`` (stored as γ−1) + 1 → ``weight``,
                           ``beta`` → ``bias``; a BatchNorm's
                           ``batch_stats`` ``mean`` / ``var`` →
                           ``running_mean`` / ``running_var``

The ``*_to_jax`` functions map a ``state_dict`` back onto the JAX param
tree, with the same key paths: OIHW → HWIO, ``(in, out, kh, kw)`` → HWIO
with no flip, a BatchNorm's ``weight`` − 1 → ``gamma`` and ``bias`` →
``beta``; :func:`batch_stats_to_jax` gives its running statistics as the
``batch_stats`` tree. A round trip port → JAX → port is the identity (γ − 1
is exact for γ in [0.5, 2]); JAX → port → JAX rounds each ``gamma`` once,
where γ − 1 + 1 does. The checkpoint writer (``core/checkpoint.py``) saves
through them, so the JAX package loads what the port writes.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def conv_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO → OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def conv_transpose_w_from_hwio(w: np.ndarray) -> np.ndarray:
    """HWIO with I=in, O=out → PyTorch ConvTranspose2d ``(in, out, kh, kw)``."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def conv_w_to_hwio(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


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


def _nodes(params: Mapping[str, Any], path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Mapping[str, Any]]]:
    """Every conv ``{"w"[, "b"]}`` and norm ``{"gamma", "beta"}`` node of
    a param tree, with its path; arrays held directly by a module (the
    UDA encoder's ``linear_w`` / ``linear_b``) are not nodes."""
    for k, v in params.items():
        if not isinstance(v, Mapping):
            continue
        if "w" in v or "gamma" in v:
            yield path + (k,), v
        else:
            yield from _nodes(v, path + (k,))


def _stats_at(batch_stats: Optional[Mapping[str, Any]],
              path: Tuple[str, ...]) -> Optional[Mapping[str, Any]]:
    for p in path:
        if not isinstance(batch_stats, Mapping) or p not in batch_stats:
            return None
        batch_stats = batch_stats[p]
    return batch_stats


def _f32(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


_UNET_NAME = re.compile(r"^(down|up)_(\d+)_(convt?)$|^(msrb)_(\d+)$")


def _unet_key(path: Tuple[str, ...]) -> str:
    """``UNetGeneratorHD`` path → ``state_dict`` prefix: ``down_i_conv`` /
    ``up_i_convt`` / ``msrb_i`` become ``down_conv.i`` / ``up_convt.i`` /
    ``msrb.i``; every other name is kept."""
    parts = []
    for p in path:
        m = _UNET_NAME.match(p)
        if m is None:
            parts.append(p)
        elif m.group(4):
            parts += [m.group(4), m.group(5)]
        else:
            parts += [f"{m.group(1)}_{m.group(3)}", m.group(2)]
    return ".".join(parts)


def _named_convt(path: Tuple[str, ...]) -> bool:
    """The transpose convs of every generator but ``ResnetGenerator``: the
    nodes whose name ends in ``convt`` (``up_i/convt``,
    ``up_i/b{j}_convt``, ``trunk/up_i/convt``, ``up_i_convt``, …)."""
    return path[-1].endswith("convt")


def generator_from_jax(params: Mapping[str, Any],
                       transposed: Callable[[Tuple[str, ...]], bool]
                       = _named_convt,
                       key: Callable[[Tuple[str, ...]], str] = _torch_key,
                       batch_stats: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """A generator's JAX params → ``state_dict`` of its port counterpart
    (:mod:`cistar_tpu_torch.models`). ``transposed(path)`` says which nodes
    are transpose convs (by default those named ``*convt``), ``key(path)``
    names each node's module. The CycleGAN skip-decoder generators take the
    defaults: ``init_conv``, ``down_i/conv`` or ``down_i/b{j}_conv``,
    ``res_i/conv{1,2}`` or ``res_i/atrous/b{j}_conv`` + ``res_i/conv``,
    ``up_i/convt``, ``up_i/b{j}_convt`` or ``up_i/conv``, ``out_conv``. A
    norm node needs ``batch_stats`` (ValueError without it): it is a
    BatchNorm where they hold running statistics at its path, else an
    affine instance norm (``weight`` / ``bias`` alone; pass ``{}`` for a
    network without BatchNorm). A conv without ``b`` has no bias. Arrays at
    the tree's root (the UDA encoder's ``linear_w`` / ``linear_b``) keep
    their name and layout. The modules that keep JAX's names, the transpose
    convs named ``*convt`` (pix2pixHD's ``Encoder``, ``AutoEncoder``,
    ``FeatureEncoder``, ``TransferGenerator``, ``TransferPairG``,
    ``WDiscriminator``, the UDA modules, the discriminators), take the
    defaults with ``batch_stats=stats or {}``."""
    sd: Dict[str, torch.Tensor] = {k: _f32(v) for k, v in params.items()
                                   if not isinstance(v, Mapping)}
    for path, node in _nodes(params):
        key_ = key(path)
        if "gamma" in node:
            if batch_stats is None:
                raise ValueError(f"norm {'/'.join(path)} needs the "
                                 "generator's batch_stats")
            sd[f"{key_}.weight"] = _f32(np.asarray(node["gamma"], np.float32)
                                        + np.float32(1.0))
            sd[f"{key_}.bias"] = _f32(node["beta"])
            st = _stats_at(batch_stats, path)
            if st is not None:
                sd[f"{key_}.running_mean"] = _f32(st["mean"])
                sd[f"{key_}.running_var"] = _f32(st["var"])
            continue
        w = np.asarray(node["w"], np.float32)
        w = conv_transpose_w_from_hwio(w) if transposed(path) \
            else conv_w_from_hwio(w)
        sd[f"{key_}.weight"] = torch.from_numpy(w)
        if "b" in node:
            sd[f"{key_}.bias"] = _f32(node["b"])
    return sd


def resnet_generator_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """``ResnetGenerator`` params (``init_conv / down_i / res_i/conv{1,2} /
    up_i / out_conv``, each ``{"w", "b"}``; ``up_i`` transpose convs) → a
    ``state_dict`` for :class:`~cistar_tpu_torch.models.cyclegan.
    ResnetGenerator`."""
    return generator_from_jax(
        params, lambda path: len(path) == 1 and path[0].startswith("up_"))


def global_generator_from_jax(params: Mapping[str, Any],
                              batch_stats: Optional[Mapping[str, Any]] = None
                              ) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``GlobalGenerator`` params (``trunk/stem/conv``,
    ``trunk/down_i/conv``, ``trunk/res_i/conv{1,2}``, ``trunk/up_i/convt``
    (transpose), ``head/conv``; with ``norm="batch"`` each stage's
    ``norm`` / ``norm{1,2}`` and its ``batch_stats``) → a ``state_dict`` for
    :class:`~cistar_tpu_torch.models.pix2pixhd.GlobalGenerator`."""
    return generator_from_jax(params, batch_stats=batch_stats)


def local_enhancer_from_jax(params: Mapping[str, Any],
                            batch_stats: Optional[Mapping[str, Any]] = None
                            ) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``LocalEnhancer`` params (``global/…`` as a
    ``GlobalGeneratorTrunk``, ``enh{n}_stem/conv``, ``enh{n}_down/conv``,
    ``enh{n}_res_{i}/conv{1,2}``, ``enh{n}_up/convt`` (transpose),
    ``head/conv``; BatchNorms as in :func:`global_generator_from_jax`) → a
    ``state_dict`` for :class:`~cistar_tpu_torch.models.pix2pixhd.
    LocalEnhancer`."""
    return generator_from_jax(params, batch_stats=batch_stats)


def multiscale_global_generator_from_jax(params: Mapping[str, Any],
                                         batch_stats: Mapping[str, Any]
                                         ) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``MultiscaleGlobalGenerator`` params (``b1_stem``,
    ``b1_down``, ``feat_stem``, ``connect_b12``, ``connect_b23``, each
    ``{conv, norm}``; ``res_i/{conv1,norm1,conv2,norm2}``,
    ``up_i/{convt,norm}`` (transpose), ``head/conv``) and its
    ``batch_stats`` tree → a ``state_dict`` for :class:`~cistar_tpu_torch.
    models.pix2pixhd.MultiscaleGlobalGenerator`."""
    return generator_from_jax(params, batch_stats=batch_stats)


def unet_generator_hd_from_jax(params: Mapping[str, Any],
                               batch_stats: Optional[Mapping[str, Any]] = None
                               ) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``UNetGeneratorHD`` params (``init_block/conv``,
    ``down_i_conv``, ``msrb_i/b{00,01,10,11}_conv``, ``msrb_i/out_conv``,
    ``up_i_convt`` (transpose), ``output_layer/conv``) → a ``state_dict``
    for :class:`~cistar_tpu_torch.models.pix2pixhd.UNetGeneratorHD`. The
    network has no BatchNorm: ``batch_stats`` (the other families'
    argument) is not read."""
    return generator_from_jax(params, key=_unet_key)


def multiscale_discriminator_from_jax(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``MultiscaleDiscriminator`` params
    (``scale_k/layer{n}_conv``, each ``{"w", "b"}``) → a ``state_dict`` for
    :class:`~cistar_tpu_torch.models.pix2pixhd.MultiscaleDiscriminator`."""
    return generator_from_jax(params)


def encoder_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """pix2pixHD ``Encoder`` params (``stem/conv``, ``down_i/conv``,
    ``up_i/convt`` (transpose), ``head/conv``) → a ``state_dict`` for
    :class:`~cistar_tpu_torch.models.pix2pixhd.Encoder`."""
    return generator_from_jax(params)


def patch_discriminator_from_jax(params: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """``PatchDiscriminator`` params (``conv0`` … ``conv4``, each ``{"w",
    "b"}``) → a ``state_dict`` for :class:`~cistar_tpu_torch.models.
    cyclegan.PatchDiscriminator`."""
    return generator_from_jax(params)


def vgg_params_from_jax(params: Mapping[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """VGG params of the JAX package (``{name: {"w": HWIO, "b"}}``) →
    the port's VGG params, the same layout as fp32 tensors
    (:mod:`cistar_tpu_torch.models.vgg`): no transpose."""
    return {name: {k: _f32(v) for k, v in p.items()}
            for name, p in params.items()}


def _jax_path(module: str) -> Tuple[str, ...]:
    """Inverse of :func:`_torch_key`: ``down.i`` / ``res.i`` / ``up.i``
    become ``down_i`` / ``res_i`` / ``up_i``."""
    parts, out = module.split("."), []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("down", "res", "up") and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out)


_UNET_MODULE = re.compile(r"^(down|up)_(convt?)\.(\d+)$|^msrb\.(\d+)$")


def _unet_path(module: str) -> Tuple[str, ...]:
    """Inverse of :func:`_unet_key`: ``down_conv.i`` / ``up_convt.i`` /
    ``msrb.i`` become ``down_i_conv`` / ``up_i_convt`` / ``msrb_i``."""
    out, parts = [], module.split(".")
    i = 0
    while i < len(parts):
        m = _UNET_MODULE.match(".".join(parts[i:i + 2]))
        if m is None:
            out.append(parts[i])
            i += 1
            continue
        out.append(f"msrb_{m.group(4)}" if m.group(4) is not None
                   else f"{m.group(1)}_{m.group(3)}_{m.group(2)}")
        i += 2
    return tuple(out)


def _is_norm(sd: Mapping[str, torch.Tensor], module: str) -> bool:
    """A BatchNorm or affine instance norm: its ``weight`` is (C,)."""
    return sd[f"{module}.weight"].dim() == 1


def generator_to_jax(sd: Mapping[str, torch.Tensor],
                     transposed: Callable[[Tuple[str, ...]], bool]
                     = _named_convt,
                     path: Callable[[str], Tuple[str, ...]] = _jax_path
                     ) -> Dict[str, Any]:
    """A ``state_dict`` of convs (``<module>.weight`` / ``<module>.bias``)
    and norms (those with a (C,) ``weight``: BatchNorms and affine instance
    norms) → the JAX param tree of the same network, numpy fp32 leaves:
    the inverse of :func:`generator_from_jax`. ``transposed(path)`` says
    which nodes are transpose convs, as there; ``path(module)`` gives a
    module's JAX path. A parameter of the root module keeps its name. The
    running statistics go to :func:`batch_stats_to_jax`. The leaves are
    copies, not views of the module's tensors, which later steps change in
    place."""
    tree: Dict[str, Any] = {}
    for name, t in sd.items():
        module, _, leaf = name.rpartition(".")
        a = t.detach().cpu().float().numpy().copy()
        if not module:
            tree[leaf] = a
            continue
        p = path(module)
        if leaf in ("running_mean", "running_var"):
            continue
        if _is_norm(sd, module):
            a, leaf = ((a - np.float32(1.0), "gamma") if leaf == "weight"
                       else (a, "beta"))
        elif leaf == "weight":
            a = conv_transpose_w_from_hwio(a) if transposed(p) \
                else conv_w_to_hwio(a)
            leaf = "w"
        elif leaf == "bias":
            leaf = "b"
        else:
            raise ValueError(f"{name}: not a conv or BatchNorm parameter")
        node = tree
        for q in p:
            node = node.setdefault(q, {})
        node[leaf] = a
    return tree


def batch_stats_to_jax(sd: Mapping[str, torch.Tensor],
                       path: Callable[[str], Tuple[str, ...]] = _jax_path
                       ) -> Optional[Dict[str, Any]]:
    """The running statistics of a ``state_dict``'s BatchNorms as the JAX
    ``batch_stats`` tree (``mean`` / ``var`` at each norm's path, numpy
    fp32 copies), or ``None`` when it has no BatchNorm."""
    tree: Dict[str, Any] = {}
    for name, t in sd.items():
        module, _, leaf = name.rpartition(".")
        if leaf not in ("running_mean", "running_var"):
            continue
        node = tree
        for q in path(module):
            node = node.setdefault(q, {})
        node["mean" if leaf == "running_mean" else "var"] = \
            t.detach().cpu().float().numpy().copy()
    return tree or None


def unet_generator_hd_to_jax(sd: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Any]:
    """Inverse of :func:`unet_generator_hd_from_jax`."""
    return generator_to_jax(sd, path=_unet_path)


def resnet_generator_to_jax(sd: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Any]:
    """Inverse of :func:`resnet_generator_from_jax`: the ``up_i`` transpose
    convs' ``(in, out, kh, kw)`` weights go back to HWIO unflipped (the same
    axis swap, its own inverse)."""
    return generator_to_jax(
        sd, lambda path: len(path) == 1 and path[0].startswith("up_"))


def patch_discriminator_to_jax(sd: Mapping[str, torch.Tensor]
                               ) -> Dict[str, Any]:
    """Inverse of :func:`patch_discriminator_from_jax`."""
    return generator_to_jax(sd)
