"""The reference's PyTorch checkpoints → the JAX package's param trees and
the port's ``state_dict`` s (counterpart of
``cistar_tpu/core/convert_models.py``).

Two layers:

  * ``convert_*``: the JAX package's converters, copied. Each maps a
    reference ``state_dict`` layout (numpy leaves, :func:`~cistar_tpu_torch.
    core.torch_import.load_state_dict`) onto the JAX package's named param
    tree (NHWC / HWIO), bit for bit as JAX builds it, so
    ``apps/convert_checkpoint.py`` writes the same ``.npz`` in either
    package. Per torch module prefix each declares the ordered list of
    (param path, kind) its weights map to; within a prefix torch's numeric
    key order is construction order. The families: the CycleGAN generators
    by ``gen_type`` and D (``CycleGAN/models.py``); pix2pixHD ``global``,
    ``local``, ``UNet``, ``multiscale`` (BatchNorm, with its running
    statistics), ``AutoEncoder``, the instance ``Encoder``, the multiscale
    D, ``WDiscriminator``, the UDA encoder / decoder / feature critic,
    ``TransferGenerator`` and ``FeatureEncoder``'s numbered save format
    (``p2pHD/models/networks.py``).
  * ``*_from_pth``: one a family, the copy followed by the port's
    ``core/convert.py`` ``*_from_jax``: a ``state_dict`` that the port's
    module of that family loads with ``load_state_dict``.

The UDA encoder's optional linear head is not converted, as in JAX: a
linear encoder's ``.pth`` gives the conv trunk only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from cistar_tpu_torch.core import convert as cv
from cistar_tpu_torch.core.torch_import import (conv_transpose_w, conv_w,
                                                linear_w)

Kind = str  # "conv" | "convT" | "linear"
SD = Dict[str, np.ndarray]


def _set(tree: Dict[str, Any], path: str, w: np.ndarray, b: np.ndarray | None,
         kind: Kind) -> None:
    node = tree
    for p in path.split("/"):
        node = node.setdefault(p, {})
    if kind == "conv":
        node["w"] = conv_w(w)
    elif kind == "convT":
        node["w"] = conv_transpose_w(w)
    elif kind == "linear":
        node["w"] = linear_w(w)
    else:
        raise ValueError(kind)
    if b is not None:
        node["b"] = np.asarray(b)


def _collect(sd: SD, prefix: str) -> List[Tuple[Tuple, str]]:
    """All weight keys under ``prefix``, sorted by numeric path components."""
    out = []
    plen = len(prefix) + 1 if prefix else 0
    for key in sd:
        if prefix and not key.startswith(prefix + "."):
            continue
        if not key.endswith(".weight"):
            continue
        rest = key[plen:-len(".weight")]
        sort_key = tuple(int(p) if p.isdigit() else p for p in rest.split("."))
        out.append((sort_key, key[: -len(".weight")]))
    return sorted(out)


def _convert_by_map(sd: SD, prefix_map: Sequence[Tuple[str, Sequence[Tuple[str, Kind]]]]
                    ) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for prefix, targets in prefix_map:
        entries = _collect(sd, prefix)
        # Instance norms are affine=False (no weights); only convs appear.
        if len(entries) != len(targets):
            raise ValueError(
                f"prefix {prefix!r}: found {len(entries)} conv weights "
                f"({[e[1] for e in entries]}), expected {len(targets)} "
                f"({[t[0] for t in targets]})")
        for (_, base), (path, kind) in zip(entries, targets):
            w = sd[base + ".weight"]
            b = sd.get(base + ".bias")
            _set(params, path, w, b, kind)
    return params


# --------------------------------------------------------------------------- #
# CycleGAN
# --------------------------------------------------------------------------- #
def convert_cyclegan_resnet_generator(sd: SD, n_residual_blocks: int = 6
                                      ) -> Dict[str, Any]:
    """torch ``Generator`` (one flat Sequential ``model``)."""
    targets: List[Tuple[str, Kind]] = [("init_conv", "conv")]
    targets += [(f"down_{i}", "conv") for i in range(3)]
    for i in range(n_residual_blocks):
        targets += [(f"res_{i}/conv1", "conv"), (f"res_{i}/conv2", "conv")]
    targets += [(f"up_{i}", "convT") for i in range(3)]
    targets += [("out_conv", "conv")]
    return _convert_by_map(sd, [("model", targets)])


def _skip_decoder_maps(enc_kind: str, dec_kind: str, res_kind: str,
                       n_res: int, n_down: int = 3):
    """Prefix maps shared by GeneratorUnet / Multiscale variants."""
    maps: List[Tuple[str, Sequence[Tuple[str, Kind]]]] = [
        ("init_block", [("init_conv", "conv")]),
    ]
    for i in range(n_down):
        if enc_kind == "plain":
            maps.append((f"encoder.{i}", [(f"down_{i}/conv", "conv")]))
        else:  # atrous: 4 branches, each conv
            maps.append((f"encoder.{i}",
                         [(f"down_{i}/b{j}_conv", "conv") for j in range(4)]))
    for i in range(n_res):
        if res_kind == "plain":
            maps.append((f"res_block.{i}",
                         [(f"res_{i}/conv1", "conv"), (f"res_{i}/conv2", "conv")]))
        else:  # atrous residual: MultiAtrousConv(4 convs) + plain conv
            maps.append((f"res_block.{i}",
                         [(f"res_{i}/atrous/b{j}_conv", "conv") for j in range(4)]
                         + [(f"res_{i}/conv", "conv")]))
    for i in range(n_down):
        if dec_kind == "plain":
            maps.append((f"decoder.{i}", [(f"up_{i}/convt", "convT")]))
        elif dec_kind == "atrous":
            maps.append((f"decoder.{i}",
                         [(f"up_{i}/b{j}_convt", "convT") for j in range(4)]))
        else:  # bilinear: upsample + conv
            maps.append((f"decoder.{i}", [(f"up_{i}/conv", "conv")]))
    maps.append(("output_layer", [("out_conv", "conv")]))
    return maps


def convert_cyclegan_generator(sd: SD, gen_type: str, n_residual_blocks: int = 6,
                               dense_decoder: bool = True) -> Dict[str, Any]:
    """Dispatch by the reference CLI's ``gen_type`` prefixes."""
    if gen_type.startswith("p2p"):
        return convert_cyclegan_resnet_generator(sd, n_residual_blocks)
    if gen_type.startswith("unet"):
        maps = _skip_decoder_maps("plain", "plain", "plain", n_residual_blocks)
    elif gen_type.startswith("bilinear"):
        maps = _skip_decoder_maps("atrous", "bilinear", "atrous", n_residual_blocks)
    elif gen_type.startswith("atrous"):
        dec = "plain" if dense_decoder else "atrous"
        maps = _skip_decoder_maps("atrous", dec, "plain", n_residual_blocks)
    else:
        raise ValueError(gen_type)
    return _convert_by_map(sd, maps)


def convert_cyclegan_discriminator(sd: SD) -> Dict[str, Any]:
    targets = [(f"conv{i}", "conv") for i in range(5)]
    return _convert_by_map(sd, [("model", targets)])


# --------------------------------------------------------------------------- #
# pix2pixHD
# --------------------------------------------------------------------------- #
def _global_trunk_targets(prefix: str, n_down: int, n_blocks: int
                          ) -> List[Tuple[str, Kind]]:
    t: List[Tuple[str, Kind]] = [(f"{prefix}/stem/conv", "conv")]
    t += [(f"{prefix}/down_{i}/conv", "conv") for i in range(n_down)]
    for i in range(n_blocks):
        t += [(f"{prefix}/res_{i}/conv1", "conv"), (f"{prefix}/res_{i}/conv2", "conv")]
    t += [(f"{prefix}/up_{i}/convt", "convT") for i in range(n_down)]
    return t


def convert_global_generator(sd: SD, n_downsampling: int = 3, n_blocks: int = 9
                             ) -> Dict[str, Any]:
    """``GlobalGenerator`` — flat Sequential ``model`` incl. the output head."""
    targets = _global_trunk_targets("trunk", n_downsampling, n_blocks)
    targets += [("head/conv", "conv")]
    return _convert_by_map(sd, [("model", targets)])


def convert_local_enhancer(sd: SD, n_downsample_global: int = 3,
                           n_blocks_global: int = 9, n_local_enhancers: int = 1,
                           n_blocks_local: int = 3) -> Dict[str, Any]:
    """``LocalEnhancer``: trunk under ``model`` (head stripped), enhancer
    streams under ``model{n}_1`` / ``model{n}_2``."""
    maps = [("model", _global_trunk_targets("global", n_downsample_global,
                                            n_blocks_global))]
    for n in range(1, n_local_enhancers + 1):
        maps.append((f"model{n}_1",
                     [(f"enh{n}_stem/conv", "conv"), (f"enh{n}_down/conv", "conv")]))
        up_targets: List[Tuple[str, Kind]] = []
        for i in range(n_blocks_local):
            up_targets += [(f"enh{n}_res_{i}/conv1", "conv"),
                           (f"enh{n}_res_{i}/conv2", "conv")]
        up_targets += [(f"enh{n}_up/convt", "convT")]
        if n == n_local_enhancers:
            up_targets += [("head/conv", "conv")]
        maps.append((f"model{n}_2", up_targets))
    return _convert_by_map(sd, maps)


def convert_unet_generator_hd(sd: SD, n_residual_blocks: int = 3) -> Dict[str, Any]:
    """p2pHD ``UNetGenerator`` (the trained r2l_MSRB config)."""
    maps: List[Tuple[str, Sequence[Tuple[str, Kind]]]] = [
        ("init_block", [("init_block/conv", "conv")]),
    ]
    for i in range(3):
        maps.append((f"encoder.{i}", [(f"down_{i}_conv", "conv")]))
    for i in range(n_residual_blocks):
        maps.append((f"res_block.{i}",
                     [(f"msrb_{i}/b00_conv", "conv"), (f"msrb_{i}/b01_conv", "conv"),
                      (f"msrb_{i}/b10_conv", "conv"), (f"msrb_{i}/b11_conv", "conv"),
                      (f"msrb_{i}/out_conv", "conv")]))
    for i in range(3):
        maps.append((f"decoder.{i}", [(f"up_{i}_convt", "convT")]))
    maps.append(("output_layer", [("output_layer/conv", "conv")]))
    return _convert_by_map(sd, maps)


def convert_multiscale_discriminator(sd: SD, num_d: int = 2, n_layers: int = 3,
                                     get_interm_feat: bool = True) -> Dict[str, Any]:
    """``MultiscaleDiscriminator``: per-scale PatchGANs saved as
    ``scale{i}_layer{j}.*`` (interm-feat mode) or ``layer{i}.*``."""
    params: Dict[str, Any] = {}
    for i in range(num_d):
        targets = [(f"scale_{i}/layer{j}_conv", "conv") for j in range(n_layers + 2)]
        if get_interm_feat:
            maps = [(f"scale{i}_layer{j}", [targets[j]]) for j in range(n_layers + 2)]
        else:
            maps = [(f"layer{i}", targets)]
        params.update(_convert_by_map(sd, maps))  # each scale has a unique key
    return params


def _set_norm(tree: Dict[str, Any], path: str, w: np.ndarray,
              b: np.ndarray | None) -> None:
    """Affine norm params. Our NormLayer stores gamma as offset-from-one."""
    node = tree
    for p in path.split("/"):
        node = node.setdefault(p, {})
    node["gamma"] = np.asarray(w, np.float32) - 1.0
    node["beta"] = np.asarray(b if b is not None else np.zeros_like(w),
                              np.float32)


def _convert_with_norms(sd: SD,
                        prefix_map: Sequence[Tuple[str, Sequence[Tuple[str, Kind]]]]
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Like :func:`_convert_by_map` but handles affine-norm targets.

    Extra kinds: ``"norm_affine"`` (affine instance norm → gamma/beta) and
    ``"bn"`` (BatchNorm2d → gamma/beta in params PLUS running mean/var in the
    returned ``batch_stats`` tree). Within a prefix, torch's numeric key
    ordering interleaves conv and norm weights in construction order, which
    must match the target list order.
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for prefix, targets in prefix_map:
        entries = _collect(sd, prefix)
        if len(entries) != len(targets):
            raise ValueError(
                f"prefix {prefix!r}: found {len(entries)} weights "
                f"({[e[1] for e in entries]}), expected {len(targets)} "
                f"({[t[0] for t in targets]})")
        for (_, base), (path, kind) in zip(entries, targets):
            w = sd[base + ".weight"]
            b = sd.get(base + ".bias")
            if kind in ("conv", "convT", "linear"):
                _set(params, path, w, b, kind)
            elif kind == "norm_affine":
                _set_norm(params, path, w, b)
            elif kind == "bn":
                _set_norm(params, path, w, b)
                node = stats
                for p in path.split("/"):
                    node = node.setdefault(p, {})
                node["mean"] = np.asarray(sd[base + ".running_mean"],
                                          np.float32)
                node["var"] = np.asarray(sd[base + ".running_var"],
                                         np.float32)
            else:
                raise ValueError(kind)
    return params, stats


def convert_multiscale_global_generator(sd: SD, n_blocks: int = 9
                                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``MultiscaleGlobalGenerator`` (``networks.py:277-340``) — the shipped
    ``r2l`` experiment's netG (``checkpoints/r2l/opt.txt:51``). Two reference
    quirks reproduced: (a) ``b2Feat``/``b3Feat`` alias the SAME layers (we
    convert ``b2Feat`` into the shared ``feat_stem``); (b) ``define_G`` never
    passes ``norm_layer``, so this family uses the **BatchNorm default**
    (``networks.py:40`` vs ``:278``) — returns (params, batch_stats)."""
    maps: List[Tuple[str, Sequence[Tuple[str, Kind]]]] = [
        ("b1", [("b1_stem/conv", "conv"), ("b1_stem/norm", "bn"),
                ("b1_down/conv", "conv"), ("b1_down/norm", "bn")]),
        ("b2Feat", [("feat_stem/conv", "conv"), ("feat_stem/norm", "bn")]),
        ("connectB12", [("connect_b12/conv", "conv"),
                        ("connect_b12/norm", "bn")]),
        ("connectB23", [("connect_b23/conv", "conv"),
                        ("connect_b23/norm", "bn")]),
    ]
    tail: List[Tuple[str, Kind]] = []
    for i in range(n_blocks):
        tail += [(f"res_{i}/conv1", "conv"), (f"res_{i}/norm1", "bn"),
                 (f"res_{i}/conv2", "conv"), (f"res_{i}/norm2", "bn")]
    for i in range(3):
        tail += [(f"up_{i}/convt", "convT"), (f"up_{i}/norm", "bn")]
    tail += [("head/conv", "conv")]
    maps.append(("model", tail))
    return _convert_with_norms(sd, maps)


def convert_autoencoder(sd: SD, n_downsampling: int = 3, n_blocks: int = 9
                        ) -> Dict[str, Any]:
    """``AutoEncoder`` (``networks.py:227-273``): named init/encoder/resblock/
    decoder/output stages — the R2LTransfer frozen AEs load this format."""
    maps: List[Tuple[str, Sequence[Tuple[str, Kind]]]] = [
        ("init_layer", [("init_layer/conv", "conv")]),
        ("encoder", [(f"encoder_{i}/conv", "conv")
                     for i in range(n_downsampling)]),
    ]
    res: List[Tuple[str, Kind]] = []
    for i in range(n_blocks):
        res += [(f"resblock_{i}/conv1", "conv"), (f"resblock_{i}/conv2", "conv")]
    maps.append(("resblock", res))
    maps.append(("decoder", [(f"decoder_{i}/convt", "convT")
                             for i in range(n_downsampling)]))
    maps.append(("output_layer", [("output_layer/conv", "conv")]))
    return _convert_by_map(sd, maps)


def convert_p2phd_encoder(sd: SD, n_downsampling: int = 4) -> Dict[str, Any]:
    """Instance-feature ``Encoder`` (``networks.py:386-422``), netE in
    ``pix2pixHD_model.py:57-59``."""
    targets: List[Tuple[str, Kind]] = [("stem/conv", "conv")]
    targets += [(f"down_{i}/conv", "conv") for i in range(n_downsampling)]
    targets += [(f"up_{i}/convt", "convT") for i in range(n_downsampling)]
    targets += [("head/conv", "conv")]
    return _convert_by_map(sd, [("model", targets)])


def convert_wdiscriminator(sd: SD, n_layer: int = 5) -> Dict[str, Any]:
    """``wDiscriminator`` (``networks.py:742-779``): k4/s2/p1 convs (no bias)
    with affine instance norms interleaved."""
    targets: List[Tuple[str, Kind]] = []
    for i in range(n_layer - 1):
        targets += [(f"conv_{i}", "conv"), (f"norm_{i}", "norm_affine")]
    targets += [("conv_out", "conv")]
    params, _ = _convert_with_norms(sd, [("model", targets)])
    return params


def convert_uda_encoder(sd: SD, down_conv: int = 4, n_resblocks: int = 3
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``UDAEncoder`` (``networks.py:783-838``): instance-norm stem, BN down
    convs, instance-norm resblocks. Returns (params, batch_stats)."""
    targets: List[Tuple[str, Kind]] = [("stem/conv", "conv")]
    for i in range(down_conv):
        targets += [(f"down_{i}_conv", "conv"), (f"down_{i}_bn", "bn")]
    for i in range(n_resblocks):
        targets += [(f"res_{i}/conv1", "conv"), (f"res_{i}/conv2", "conv")]
    return _convert_with_norms(sd, [("model", targets)])


def convert_uda_decoder(sd: SD, down_conv: int = 4, n_resblocks: int = 3
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``UDADecoder`` (``networks.py:843-898``). Returns (params, batch_stats)."""
    targets: List[Tuple[str, Kind]] = []
    for i in range(n_resblocks):
        targets += [(f"res_{i}/conv1", "conv"), (f"res_{i}/conv2", "conv")]
    for i in range(down_conv):
        targets += [(f"up_{i}_convt", "convT"), (f"up_{i}_bn", "bn")]
    targets += [("head/conv", "conv")]
    return _convert_with_norms(sd, [("model", targets)])


def convert_domain_feature_discriminator(sd: SD
                                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``DomainFeatureDescriminator`` (``networks.py:905-925``). Returns
    (params, batch_stats)."""
    targets: List[Tuple[str, Kind]] = []
    for i in range(4):
        targets += [(f"conv_{i}", "conv"), (f"bn_{i}", "bn")]
    targets += [("conv_out", "conv"), ("bn_out", "bn")]
    return _convert_with_norms(sd, [("model", targets)])


def convert_p2phd_generator(sd: SD, net_g: str, **kw) -> Dict[str, Any]:
    if net_g == "global":
        return convert_global_generator(sd, kw.get("n_downsample_global", 3),
                                        kw.get("n_blocks_global", 9))
    if net_g == "local":
        return convert_local_enhancer(sd, kw.get("n_downsample_global", 3),
                                      kw.get("n_blocks_global", 9),
                                      kw.get("n_local_enhancers", 1),
                                      kw.get("n_blocks_local", 3))
    if net_g == "UNet":
        return convert_unet_generator_hd(sd, kw.get("n_blocks_global", 3))
    if net_g == "multiscale":
        return convert_multiscale_global_generator(
            sd, kw.get("n_blocks_global", 9))
    if net_g == "autoencoder":
        return convert_autoencoder(sd, kw.get("n_downsample_global", 3),
                                   kw.get("n_blocks_global", 9))
    if net_g == "encoder":
        return convert_p2phd_encoder(sd, kw.get("n_downsample_global", 4))
    raise NotImplementedError(f"converter for netG={net_g!r}")


def convert_transfer_generator(sd: SD, n_blocks: int = 9,
                               n_upsampling: int = 4) -> Dict[str, Any]:
    """``TransferGenerator`` (``networks.py:692-713``): flat ``model`` of
    resblocks (instance norm) + transpose ups + c7s1 head — the decoder half
    that pairs with FeatureEncoder in TransferModel/R2LTransfer
    (``pix2pixHD_model.py:351,643-649``)."""
    targets: List[Tuple[str, Kind]] = []
    for i in range(n_blocks):
        targets += [(f"res_{i}/conv1", "conv"), (f"res_{i}/conv2", "conv")]
    targets += [(f"up_{i}/convt", "convT") for i in range(n_upsampling)]
    targets += [("head/conv", "conv")]
    return _convert_by_map(sd, [("model", targets)])


def convert_feature_encoder(numbered_sd: Dict[str, Dict[str, np.ndarray]],
                            n_downsampling: int = 4, n_scale: int = 3
                            ) -> Dict[str, Any]:
    """``FeatureEncoder``'s bespoke save format (``networks.py:616-631``): a
    dict ``{str(i): sub_state_dict}`` — branches first (each Sequential wraps
    the SHARED first_layer, so every branch sub-dict holds identical stem
    weights), then the down_conv stages. We take the stem from branch 0 and
    map each down_conv to ``down_{i}``."""
    params: Dict[str, Any] = {}
    branch0 = numbered_sd["0"]
    entries = _collect(branch0, "")
    if len(entries) != 1:
        raise ValueError(f"branch 0 should hold exactly the stem conv, got "
                         f"{[e[1] for e in entries]}")
    base = entries[0][1]
    _set(params, "stem/conv", branch0[base + ".weight"],
         branch0.get(base + ".bias"), "conv")
    for i in range(n_downsampling):
        sub = numbered_sd[str(n_scale + i)]
        entries = _collect(sub, "")
        if len(entries) != 1:
            raise ValueError(f"down_conv {i}: expected 1 conv, got {len(entries)}")
        base = entries[0][1]
        _set(params, f"down_{i}/conv", sub[base + ".weight"],
             sub.get(base + ".bias"), "conv")
    return params


# --------------------------------------------------------------------------- #
# reference state_dict → the port's state_dict
# --------------------------------------------------------------------------- #
StateDict = Dict[str, torch.Tensor]


def cyclegan_generator_from_pth(sd: SD, gen_type: str,
                                n_residual_blocks: int = 6,
                                dense_decoder: bool = True) -> StateDict:
    """A CycleGAN generator of ``gen_type`` (``p2p*`` the ResNet
    ``Generator``; ``unet*``, ``bilinear*``, ``atrous*`` the skip-decoder
    ones) → the port's :mod:`~cistar_tpu_torch.models.cyclegan` module."""
    params = convert_cyclegan_generator(sd, gen_type, n_residual_blocks,
                                        dense_decoder)
    if gen_type.startswith("p2p"):
        return cv.resnet_generator_from_jax(params)
    return cv.generator_from_jax(params)


def cyclegan_discriminator_from_pth(sd: SD) -> StateDict:
    """CycleGAN's ``Discriminator`` → ``PatchDiscriminator``."""
    return cv.patch_discriminator_from_jax(
        convert_cyclegan_discriminator(sd))


def p2phd_generator_from_pth(sd: SD, net_g: str, **kw) -> StateDict:
    """A pix2pixHD generator by ``netG`` (``global``, ``local``, ``UNet``,
    ``multiscale`` with its running statistics, ``autoencoder``,
    ``encoder``; the keywords of :func:`convert_p2phd_generator`) → the
    port's module of :func:`~cistar_tpu_torch.models.pix2pixhd.define_g`."""
    out = convert_p2phd_generator(sd, net_g, **kw)
    params, stats = out if isinstance(out, tuple) else (out, {})
    if net_g == "UNet":
        return cv.unet_generator_hd_from_jax(params)
    return cv.generator_from_jax(params, batch_stats=stats)


def multiscale_discriminator_from_pth(sd: SD, num_d: int = 2,
                                      n_layers: int = 3,
                                      get_interm_feat: bool = True
                                      ) -> StateDict:
    """``MultiscaleDiscriminator`` → the port's."""
    return cv.multiscale_discriminator_from_jax(
        convert_multiscale_discriminator(sd, num_d, n_layers,
                                         get_interm_feat))


def wdiscriminator_from_pth(sd: SD, n_layer: int = 5) -> StateDict:
    """``wDiscriminator`` → ``WDiscriminator`` (affine instance norms)."""
    return cv.generator_from_jax(convert_wdiscriminator(sd, n_layer),
                                 batch_stats={})


def uda_encoder_from_pth(sd: SD, down_conv: int = 4, n_resblocks: int = 3
                         ) -> StateDict:
    """``UDAEncoder`` → the port's, without a linear head."""
    params, stats = convert_uda_encoder(sd, down_conv, n_resblocks)
    return cv.generator_from_jax(params, batch_stats=stats)


def uda_decoder_from_pth(sd: SD, down_conv: int = 4, n_resblocks: int = 3
                         ) -> StateDict:
    """``UDADecoder`` → the port's."""
    params, stats = convert_uda_decoder(sd, down_conv, n_resblocks)
    return cv.generator_from_jax(params, batch_stats=stats)


def domain_feature_discriminator_from_pth(sd: SD) -> StateDict:
    """``DomainFeatureDescriminator`` → ``DomainFeatureDiscriminator``."""
    params, stats = convert_domain_feature_discriminator(sd)
    return cv.generator_from_jax(params, batch_stats=stats)


def transfer_generator_from_pth(sd: SD, n_blocks: int = 9,
                                n_upsampling: int = 4) -> StateDict:
    """``TransferGenerator`` → the port's."""
    return cv.generator_from_jax(
        convert_transfer_generator(sd, n_blocks, n_upsampling))


def feature_encoder_from_pth(numbered_sd: Dict[str, SD],
                             n_downsampling: int = 4, n_scale: int = 3
                             ) -> StateDict:
    """``FeatureEncoder``'s numbered dict → the port's ``FeatureEncoder``."""
    return cv.generator_from_jax(
        convert_feature_encoder(numbered_sd, n_downsampling, n_scale))
