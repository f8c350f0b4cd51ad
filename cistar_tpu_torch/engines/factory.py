"""The trainer factory (counterpart of ``cistar_tpu/engines/factory.py``,
parity with ``p2pHD/models/models.py:3-46``).

:func:`create_model` dispatches an options namespace (argparse or
``opt.txt``) by ``--wgan`` to :class:`~cistar_tpu_torch.engines.extended.
R2LTransfer`, by ``--transfer`` to :func:`~cistar_tpu_torch.engines.
extended.make_transfer_p2p` and otherwise to :class:`~cistar_tpu_torch.
engines.p2phd.Pix2PixHD`, computing in bf16 under ``--fp16`` or
``--data_type 16`` and in fp32 otherwise. :func:`create_uda_model`
dispatches by ``--training_module``: ``discriminator`` to the image critic,
anything else to the UDA autoencoder, in bf16 under ``--fp16`` alone. The
reference's leftover ``ipdb.set_trace()`` (``models.py:24-25``) is left
out, as in JAX. The engines run on ``--device`` (CUDA when it is empty).
:func:`pix2pixhd_from_opt` maps the options to ``Pix2PixHD`` for both
``create_model`` and ``apps/p2phd_train.py``, each with its own dtype rule;
unlike JAX's factory, it passes the feature-encoder options
(``--instance_feat``, ``--label_feat``, ``--load_features``, ``--feat_num``,
``--nef``, ``--n_downsample_E``) on, as the CLI does.
"""

from __future__ import annotations

import torch


def _device(opt):
    return getattr(opt, "device", "") or None


def pix2pixhd_from_opt(opt, size: int, compute_dtype: torch.dtype,
                       mesh=None):
    """The :class:`~cistar_tpu_torch.engines.p2phd.Pix2PixHD` train step a
    ``TrainOptions`` namespace describes, at ``size``² in
    ``compute_dtype`` (each caller keeps its own dtype rule), data-parallel
    over ``mesh`` when given."""
    from cistar_tpu_torch.engines.p2phd import Pix2PixHD
    from cistar_tpu_torch.losses.perceptual import make_vgg_loss

    return Pix2PixHD(
        net_g=opt.netG, input_nc=opt.input_nc, output_nc=opt.output_nc,
        label_nc=opt.label_nc, ngf=opt.ngf, ndf=opt.ndf,
        n_downsample_global=opt.n_downsample_global,
        n_blocks_global=opt.n_blocks_global,
        n_local_enhancers=opt.n_local_enhancers,
        n_blocks_local=opt.n_blocks_local,
        n_layers_d=opt.n_layers_D, num_d=opt.num_D, norm=opt.norm,
        no_instance=opt.no_instance, r2l=opt.r2l,
        use_lsgan=not opt.no_lsgan, lambda_feat=opt.lambda_feat,
        use_ganfeat_loss=not opt.no_ganFeat_loss,
        vgg_criterion=None if opt.no_vgg_loss else make_vgg_loss(),
        lr=opt.lr, beta1=opt.beta1, niter=opt.niter,
        niter_decay=opt.niter_decay, niter_fix_global=opt.niter_fix_global,
        pool_size=opt.pool_size, image_size=size,
        compute_dtype=compute_dtype, instance_feat=opt.instance_feat,
        label_feat=opt.label_feat, load_features=opt.load_features,
        feat_num=opt.feat_num, nef=opt.nef, n_downsample_e=opt.n_downsample_E,
        device=_device(opt) if mesh is None else mesh.device, mesh=mesh)


def create_model(opt):
    """The pix2pixHD-family trainer an options namespace describes."""
    from cistar_tpu_torch.engines.extended import (R2LTransfer,
                                                   make_transfer_p2p)
    from cistar_tpu_torch.losses.perceptual import make_vgg_loss

    size = opt.r2l_res if getattr(opt, "r2l", False) else opt.fineSize
    cdt = torch.bfloat16 if (getattr(opt, "fp16", False)
                             or getattr(opt, "data_type", 32) == 16) \
        else torch.float32
    dev = _device(opt)
    if opt.model != "pix2pixHD":
        raise ValueError(f"unknown model {opt.model!r}")
    if getattr(opt, "wgan", False):
        return R2LTransfer(
            output_nc=opt.output_nc, ngf=opt.ngf,
            n_downsampling=opt.n_downsample_global, n_scale=opt.n_scale,
            n_blocks=opt.n_blocks_global, ndf=opt.ndf,
            n_layers_d=opt.n_layers_D, num_d=opt.num_D,
            lambda_feat=opt.lambda_feat, lr=opt.lr,
            beta1=getattr(opt, "beta1", 0.5), image_size=size,
            compute_dtype=cdt, device=dev)
    if getattr(opt, "transfer", False):
        return make_transfer_p2p(
            output_nc=opt.output_nc, ngf=opt.ngf,
            n_downsampling=opt.n_downsample_global, n_scale=opt.n_scale,
            n_blocks=opt.n_blocks_global, input_nc=opt.input_nc,
            label_nc=opt.label_nc, ndf=opt.ndf, n_layers_d=opt.n_layers_D,
            num_d=opt.num_D, no_instance=opt.no_instance,
            r2l=getattr(opt, "r2l", False), use_lsgan=not opt.no_lsgan,
            lambda_feat=opt.lambda_feat,
            use_ganfeat_loss=not opt.no_ganFeat_loss,
            vgg_criterion=None if opt.no_vgg_loss else make_vgg_loss(),
            lr=opt.lr, beta1=getattr(opt, "beta1", 0.5),
            niter=getattr(opt, "niter", 50),
            niter_decay=getattr(opt, "niter_decay", 50),
            pool_size=getattr(opt, "pool_size", 0), image_size=size,
            compute_dtype=cdt, device=dev)
    return pix2pixhd_from_opt(opt, size, cdt)


def create_uda_model(opt):
    """``create_UDA_model``: the trainer of ``--training_module``."""
    from cistar_tpu_torch.engines.extended import R2LAE, R2LImageCritic

    cdt = torch.bfloat16 if getattr(opt, "fp16", False) else torch.float32
    dev = _device(opt)
    if opt.training_module == "discriminator":
        return R2LImageCritic(w_lambda=getattr(opt, "w_lambda", 10.0),
                              lr=opt.lr, compute_dtype=cdt, device=dev)
    # autoencoder, or anything else: the shared-encoder UDA trainer
    return R2LAE(input_nc=opt.input_nc, size=opt.r2l_res,
                 n_downsample=opt.n_downsample_global, ngf=opt.ngf,
                 encoder_resblock=getattr(opt, "encoder_resblock", 0),
                 max_ch=getattr(opt, "max_ch", 256),
                 wgan=getattr(opt, "wgan", False), ndf=opt.ndf,
                 n_layers_d=opt.n_layers_D, num_d=opt.num_D, lr=opt.lr,
                 beta1=getattr(opt, "beta1", 0.5), compute_dtype=cdt,
                 device=dev)
