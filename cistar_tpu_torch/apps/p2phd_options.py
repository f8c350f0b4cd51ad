"""pix2pixHD options (counterpart of ``cistar_tpu/apps/p2phd_options.py``,
parity with ``p2pHD/options/*.py``).

Class-based ``BaseOptions``/``TrainOptions``/``TestOptions`` with the same
flag names and defaults (so shipped ``opt.txt`` snapshots and muscle-memory
commands keep working), ``opt.txt`` persistence on parse
(``base_options.py:100-106``), and ingestion of legacy snapshots via
``--load_opt path/to/opt.txt``. Unknown flags are ignored, as in JAX.

Deltas from the JAX CLI: ``--platform`` becomes ``--device`` (``""``, the
default, runs on CUDA and raises without a GPU; ``cpu`` runs the plain ops
on the CPU), and ``--load_opt`` restores neither (the snapshot's machine is
not this one: the shipped ``opt.txt`` says ``platform: cpu``);
``--compile_timeout`` is parsed and does nothing; ``gpu_ids`` is accepted
and ignored; ``fp16`` maps to the bf16 policy.
"""

from __future__ import annotations

import argparse
import os

from cistar_tpu_torch.core.config import parse_opt_txt


class BaseOptions:
    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.initialized = False
        self.isTrain = False

    def initialize(self):
        p = self.parser
        # experiment specifics
        p.add_argument("--name", type=str, default="label2city")
        p.add_argument("--gpu_ids", type=str, default="0",
                       help="ignored: --device picks the device")
        p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
        p.add_argument("--model", type=str, default="pix2pixHD")
        p.add_argument("--norm", type=str, default="instance")
        p.add_argument("--use_dropout", action="store_true")
        p.add_argument("--data_type", default=32, type=int, choices=[8, 16, 32])
        p.add_argument("--fp16", action="store_true", help="bf16 compute policy")
        p.add_argument("--compute", default="bf16", choices=["bf16", "fp32"],
                       help="training compute policy (params/optimizer stay "
                            "fp32 either way). bf16 is the default; "
                            "--compute fp32 restores full-precision compute. "
                            "The reference's AMP flag (p2pHD/train.py:66-68) "
                            "maps to the same policy via --fp16.")
        p.add_argument("--local_rank", type=int, default=0, help="unused (reference parity)")
        p.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                       help="'' runs on CUDA (no GPU raises); cpu runs the "
                            "plain ops on the CPU")
        p.add_argument("--compile_timeout", type=float, default=None,
                       help="parsed and has no effect: it guards an XLA "
                            "compile in the JAX CLI, and the port compiles "
                            "nothing before its first step (opt.txt files "
                            "carry it)")
        p.add_argument("--spatial_shard", action="store_true",
                       help="run the generator with the image's H axis "
                            "split over the torchrun processes (halo-"
                            "exchange convs, instance norms summed over "
                            "ranks); the batch stays whole")

        # input/output sizes
        p.add_argument("--batchSize", type=int, default=1)
        p.add_argument("--loadSize", type=int, default=1024)
        p.add_argument("--fineSize", type=int, default=512)
        p.add_argument("--label_nc", type=int, default=35)
        p.add_argument("--input_nc", type=int, default=3)
        p.add_argument("--output_nc", type=int, default=3)

        # setting inputs
        p.add_argument("--dataroot", type=str, default="./datasets/cityscapes/")
        p.add_argument("--resize_or_crop", type=str, default="scale_width")
        p.add_argument("--serial_batches", action="store_true")
        p.add_argument("--no_flip", action="store_true")
        p.add_argument("--nThreads", default=2, type=int)
        p.add_argument("--max_dataset_size", type=float, default=float("inf"))
        p.add_argument("--inputType", type=str, default="png")

        # displays
        p.add_argument("--display_winsize", type=int, default=512)
        p.add_argument("--tf_log", action="store_true")

        # generator
        p.add_argument("--netG", type=str, default="global",
                       choices=["global", "local", "encoder", "multiscale",
                                "autoencoder", "UNet"])
        p.add_argument("--ngf", type=int, default=64)
        p.add_argument("--n_downsample_global", type=int, default=4)
        p.add_argument("--n_blocks_global", type=int, default=9)
        p.add_argument("--n_blocks_local", type=int, default=3)
        p.add_argument("--n_local_enhancers", type=int, default=1)
        p.add_argument("--niter_fix_global", type=int, default=0)

        # instance-wise features
        p.add_argument("--no_instance", action="store_true")
        p.add_argument("--instance_feat", action="store_true")
        p.add_argument("--label_feat", action="store_true")
        p.add_argument("--feat_num", type=int, default=3)
        p.add_argument("--load_features", action="store_true")
        p.add_argument("--n_downsample_E", type=int, default=4)
        p.add_argument("--nef", type=int, default=16)
        p.add_argument("--n_clusters", type=int, default=10)

        # radar2lidar extensions
        p.add_argument("--r2l", action="store_true")
        p.add_argument("--r2l_res", type=int, default=512)
        p.add_argument("--multi_scale", action="store_true")
        p.add_argument("--n_scale", type=int, default=3)
        p.add_argument("--max_ch", type=int, default=256)
        p.add_argument("--transfer", action="store_true")
        p.add_argument("--wgan", action="store_true")
        p.add_argument("--uda", action="store_true")
        p.add_argument("--w_lambda", type=float, default=10)
        p.add_argument("--n_critic", type=int, default=1)
        p.add_argument("--AE_type", type=str, default="radar")
        p.add_argument("--training_module", type=str, default="discriminator")
        p.add_argument("--encoder_resblock", type=int, default=0)
        p.add_argument("--decoder_resblock", type=int, default=0)
        p.add_argument("--load_netDF", type=str, default=" ")
        p.add_argument("--load_pretrain_radar", type=str, default="")
        p.add_argument("--load_pretrain_lidar", type=str, default="")
        p.add_argument("--fine_tune_features", action="store_true")

        p.add_argument("--verbose", action="store_true")
        p.add_argument("--load_opt", type=str, default="",
                       help="ingest a legacy opt.txt snapshot as defaults")
        self.initialized = True

    def parse(self, argv=None, save: bool = True):
        if not self.initialized:
            self.initialize()
        opt, _ = self.parser.parse_known_args(argv)
        opt.isTrain = self.isTrain

        if opt.load_opt:
            import sys

            legacy = parse_opt_txt(opt.load_opt)
            given = argv if argv is not None else sys.argv[1:]
            provided = {a.split("=")[0].lstrip("-").replace("-", "_")
                        for a in given if a.startswith("--")}
            # environment-specific keys describe the machine the snapshot was
            # WRITTEN on, not the one we run on — restoring `platform: cpu`
            # or `device: cpu` from an opt.txt would silently move training
            # off the GPU (and gpu_ids/nThreads are equally non-portable)
            env_keys = {"platform", "device", "gpu_ids", "nThreads",
                        "local_rank", "checkpoints_dir", "dataroot",
                        "compile_timeout", "spatial_shard"}
            for k, v in legacy.items():
                if hasattr(opt, k) and k not in provided and k not in env_keys:
                    if v == "inf":
                        v = float("inf")
                    setattr(opt, k, v)

        self.opt = opt
        if save and opt.isTrain:
            expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
            os.makedirs(expr_dir, exist_ok=True)
            with open(os.path.join(expr_dir, "opt.txt"), "w") as f:
                f.write("------------ Options -------------\n")
                for k, v in sorted(vars(opt).items()):
                    f.write(f"{k}: {v}\n")
                f.write("-------------- End ----------------\n")
        return opt


class TrainOptions(BaseOptions):
    def __init__(self):
        super().__init__()
        self.isTrain = True

    def initialize(self):
        super().initialize()
        p = self.parser
        p.add_argument("--display_freq", type=int, default=100)
        p.add_argument("--print_freq", type=int, default=100)
        p.add_argument("--save_latest_freq", type=int, default=1000)
        p.add_argument("--save_epoch_freq", type=int, default=10)
        p.add_argument("--no_html", action="store_true")
        p.add_argument("--debug", action="store_true")
        p.add_argument("--continue_train", action="store_true")
        p.add_argument("--load_pretrain", type=str, default="")
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--phase", type=str, default="train")
        p.add_argument("--niter", type=int, default=100)
        p.add_argument("--niter_decay", type=int, default=100)
        p.add_argument("--beta1", type=float, default=0.5)
        p.add_argument("--lr", type=float, default=0.0002)
        p.add_argument("--no_ganFeat_loss", action="store_true")
        p.add_argument("--no_vgg_loss", action="store_true")
        p.add_argument("--no_lsgan", action="store_true")
        p.add_argument("--lambda_feat", type=float, default=10.0)
        p.add_argument("--pool_size", type=int, default=0)
        p.add_argument("--use_sample_loss", action="store_true")
        p.add_argument("--ndf", type=int, default=64)
        p.add_argument("--n_layers_D", type=int, default=3)
        p.add_argument("--num_D", type=int, default=2)


class TestOptions(BaseOptions):
    def __init__(self):
        super().__init__()
        self.isTrain = False

    def initialize(self):
        super().initialize()
        p = self.parser
        p.add_argument("--ntest", type=int, default=float("inf"))
        p.add_argument("--results_dir", type=str, default="./results/")
        p.add_argument("--aspect_ratio", type=float, default=1.0)
        p.add_argument("--phase", type=str, default="test")
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--how_many", type=int, default=50)
        p.add_argument("--cluster_path", type=str, default="features_clustered_010.npy")
        p.add_argument("--use_encoded_image", action="store_true")
        p.add_argument("--export_onnx", type=str, default="",
                       help="export the generator program (.pt2) to this "
                            "path and exit")
        p.add_argument("--engine", type=str, default="",
                       help="serve and profile an exported program (.pt2)")
        p.add_argument("--onnx", type=str, default="",
                       help="same as --engine")
        p.add_argument("--ndf", type=int, default=64)
        p.add_argument("--n_layers_D", type=int, default=3)
        p.add_argument("--num_D", type=int, default=2)
