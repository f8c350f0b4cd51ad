"""Convert the reference's PyTorch checkpoints to the ``.npz`` param trees
that both packages load (counterpart of
``cistar_tpu/apps/convert_checkpoint.py``: the same flags, families and
files).

    python -m cistar_tpu_torch.apps.convert_checkpoint --family cyclegan-g \\
        --gen_type bilinear_content --in_pth netG_A2B.pth --out netG_A2B.npz
    python -m cistar_tpu_torch.apps.convert_checkpoint --family p2phd-g \\
        --netG UNet --n_blocks_global 3 --in_pth latest_net_G.pth \\
        --out latest_net_G.npz

It writes the JAX package's layout (``core/checkpoint.py::save_pytree``:
keys the ``/``-joined paths of the JAX param tree, HWIO weights), so a
file converted by either package loads in both, and the port's CLIs and
engines read it through ``core/convert.py``. A BatchNorm family (``p2phd-g``
with ``--netG multiscale``, the UDA modules) is written as one
``{"params", "batch_stats"}`` tree, as JAX writes it.

The conversion is host work by nature: ``torch.load`` on the CPU and numpy.
No device is asked for and none is used, which is not a fallback from one.
"""

from __future__ import annotations

import argparse

import numpy as np

FAMILIES = ["cyclegan-g", "cyclegan-d", "p2phd-g", "p2phd-d", "p2phd-wd",
            "uda-encoder", "uda-decoder", "uda-domain-d",
            "vgg19-conv", "vgg19-features", "vgg16-features"]


def convert(args) -> dict:
    """The JAX-layout tree (numpy leaves) of ``args.in_pth`` for
    ``args.family``."""
    from cistar_tpu_torch.core import convert_models as cm
    from cistar_tpu_torch.core.torch_import import load_state_dict
    from cistar_tpu_torch.models import vgg as vgg_lib

    sd = load_state_dict(args.in_pth)
    if args.family == "cyclegan-g":
        return cm.convert_cyclegan_generator(
            sd, args.gen_type, args.n_residual_blocks, args.dense_decoder)
    if args.family == "cyclegan-d":
        return cm.convert_cyclegan_discriminator(sd)
    if args.family == "p2phd-g":
        params = cm.convert_p2phd_generator(
            sd, args.netG, n_downsample_global=args.n_downsample_global,
            n_blocks_global=args.n_blocks_global,
            n_local_enhancers=args.n_local_enhancers,
            n_blocks_local=args.n_blocks_local)
        if isinstance(params, tuple):  # BN families → (params, batch_stats)
            params = {"params": params[0], "batch_stats": params[1]}
        return params
    if args.family == "p2phd-wd":
        return cm.convert_wdiscriminator(sd, args.n_layers_D + 2)
    if args.family in ("uda-encoder", "uda-decoder", "uda-domain-d"):
        if args.family == "uda-domain-d":
            p, s = cm.convert_domain_feature_discriminator(sd)
        else:
            fn = (cm.convert_uda_encoder if args.family == "uda-encoder"
                  else cm.convert_uda_decoder)
            p, s = fn(sd, args.n_downsample_global, args.n_blocks_global)
        return {"params": p, "batch_stats": s}
    if args.family == "p2phd-d":
        return cm.convert_multiscale_discriminator(
            sd, args.num_D, args.n_layers_D, args.getIntermFeat)
    if args.family == "vgg19-conv":
        params = vgg_lib.torch_vgg_conv_to_params(sd)
    else:
        convs = (vgg_lib.VGG19_CONVS if args.family == "vgg19-features"
                 else vgg_lib.VGG16_CONVS)
        params = vgg_lib.torchvision_vgg_features_to_params(sd, convs)
    return {name: {k: v.numpy() for k, v in p.items()}
            for name, p in params.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--in_pth", required=True)
    p.add_argument("--out", required=True)
    # cyclegan args
    p.add_argument("--gen_type", default="p2p")
    p.add_argument("--n_residual_blocks", type=int, default=6)
    p.add_argument("--dense_decoder", type=lambda s: s != "False", default=True)
    # p2phd args
    p.add_argument("--netG", default="global")
    p.add_argument("--n_downsample_global", type=int, default=3)
    p.add_argument("--n_blocks_global", type=int, default=9)
    p.add_argument("--n_local_enhancers", type=int, default=1)
    p.add_argument("--n_blocks_local", type=int, default=3)
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--getIntermFeat", type=lambda s: s != "False", default=True)
    args = p.parse_args(argv)

    from cistar_tpu_torch.core.checkpoint import _flatten, save_pytree

    params = convert(args)
    save_pytree(args.out, params)
    n = sum(np.asarray(x).size for x in _flatten("", params).values())
    print(f"converted {args.in_pth} -> {args.out} ({n:,} parameters)")
    return params


if __name__ == "__main__":
    main()
