"""Base options (reference options/base_options.py), this package's copy.

Two-pass argparse: pass 1 parses the base flags, then the chosen model and
dataset classes inject their own flags (modify_commandline_options), then
the full parse runs. The parsed options are dumped to
checkpoints/{name}/opt.txt exactly like the reference.

The flag surface (names, defaults, help) is the JAX package's
``nemar_tpu/options/base_options.py``, copied verbatim, so a command line
means the same to both packages. Differences:
  * ``--model`` resolves in ``nemar_tpu_torch.models`` and
    ``--dataset_mode`` in ``nemar_tpu_torch.data``;
  * ``--gpu_ids`` picks the devices: ``-1`` is the CPU, ``k`` is ``cuda:k``
    (``models/base_model.py:resolve_device``); several ids are the world of
    a data-parallel training run, one process per device
    (``nemar_tpu_torch/parallel``), of which ``--num_devices N`` keeps the
    first N (-1: all), as the JAX package's ``make_mesh`` keeps
    ``devs[:num_devices]``; ``--gpu_ids -1 --num_devices N`` runs N ranks
    on the CPU (gloo), the counterpart of the JAX package's --num_devices on
    its virtual CPU devices;
  * ``--bf16`` runs the forward in bfloat16 with fp32 parameters, as the
    JAX package's (``models/base_model.py``, ``models/nemar_model.py``);
    the flags of the paths not ported yet are parsed and refused by the
    model by name, with the ROADMAP.md item that queues them
    (``models/nemar_model.py:_check_supported``);
  * the TPU-only flags that name a layout or an implementation of one
    function (``--warp_impl``, ``--norm_impl``,
    ``--block_impl``, ``--c7_impl``, ``--stn_head_impl``, ``--stn_up_impl``,
    ...) are accepted: every choice runs the same kernels here;
  * ``--profile_dir`` writes a ``torch.profiler`` trace of the training
    loop (``train.py``), and ``--auto_resume`` continues from
    ``checkpoint_meta.json`` when there is one (``models/base_model.py``).
"""

from __future__ import annotations

import argparse
import os


class BaseOptions:
    def __init__(self):
        self.initialized = False
        self.isTrain = False

    def initialize(self, parser: argparse.ArgumentParser):
        # -- basic --
        parser.add_argument("--dataroot", type=str, default=None,
                            help="path to images (should have subfolders trainA, trainB, etc)")
        parser.add_argument("--name", type=str, default="experiment_name",
                            help="name of the experiment; decides where checkpoints live")
        parser.add_argument("--gpu_ids", type=str, default="0",
                            help="kept for CLI compatibility; see --num_devices")
        parser.add_argument("--num_devices", type=int, default=-1,
                            help="devices in the data-parallel mesh (-1: all local)")
        parser.add_argument("--mesh_spatial", type=int, default=1,
                            help="devices along the spatial (image height) mesh axis")
        parser.add_argument("--checkpoints_dir", type=str, default="./checkpoints",
                            help="models are saved here")
        parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
        # -- model --
        parser.add_argument("--model", type=str, default="nemar",
                            help="chooses which model to use [nemar | pix2pix | cycle_gan | test]")
        parser.add_argument("--input_nc", type=int, default=3,
                            help="# of input image channels (modality A)")
        parser.add_argument("--output_nc", type=int, default=3,
                            help="# of output image channels (modality B)")
        parser.add_argument("--ngf", type=int, default=64, help="# gen filters in last conv layer")
        parser.add_argument("--ndf", type=int, default=64, help="# disc filters in first conv layer")
        parser.add_argument("--netD", type=str, default="basic",
                            help="discriminator architecture [basic | n_layers | pixel]")
        parser.add_argument("--netG", type=str, default="resnet_9blocks",
                            help="generator architecture [resnet_9blocks | resnet_6blocks | unet_256 | unet_128]")
        parser.add_argument("--n_layers_D", type=int, default=3, help="only used if netD==n_layers")
        parser.add_argument("--norm", type=str, default="instance",
                            help="normalization [instance | batch | none]")
        parser.add_argument("--init_type", type=str, default="normal",
                            help="network initialization [normal | xavier | kaiming | orthogonal]")
        parser.add_argument("--init_gain", type=float, default=0.02,
                            help="scaling factor for normal, xavier and orthogonal")
        parser.add_argument("--no_dropout", action="store_true", help="no dropout for the generator")
        # -- dataset --
        parser.add_argument("--dataset_mode", type=str, default="aligned",
                            help="[aligned | unaligned | single | synthetic | multimodal]")
        parser.add_argument("--direction", type=str, default="AtoB", help="AtoB or BtoA")
        parser.add_argument("--serial_batches", action="store_true",
                            help="take images in order instead of randomly")
        parser.add_argument("--num_threads", type=int, default=4, help="# threads for loading data")
        parser.add_argument("--loader", type=str, default="threads",
                            help="input pipeline backend [threads | grain]")
        parser.add_argument("--batch_size", type=int, default=1, help="input batch size")
        parser.add_argument("--load_size", type=int, default=286, help="scale images to this size")
        parser.add_argument("--crop_size", type=int, default=256, help="then crop to this size")
        parser.add_argument("--max_dataset_size", type=int, default=float("inf"),
                            help="maximum number of samples per epoch")
        parser.add_argument("--preprocess", type=str, default="resize_and_crop",
                            help="[resize_and_crop | crop | scale_width | scale_width_and_crop | none]")
        parser.add_argument("--no_flip", action="store_true",
                            help="do not flip the images for data augmentation")
        parser.add_argument("--display_winsize", type=int, default=256,
                            help="display window size for HTML")
        # -- additional --
        parser.add_argument("--epoch", type=str, default="latest",
                            help="which epoch to load [latest | <N>]")
        parser.add_argument("--load_iter", type=int, default=0,
                            help="load by iteration if > 0 (iter_[load_iter]), else by --epoch")
        parser.add_argument("--verbose", action="store_true", help="print more debugging info")
        parser.add_argument("--suffix", default="", type=str,
                            help="customized suffix: name = name + suffix, e.g. {model}_{netG}")
        # -- TPU-native extras --
        parser.add_argument("--bf16", action="store_true",
                            help="bfloat16 compute with fp32 params: params, "
                                 "gradients, optimizer state, EMA shadows, the "
                                 "image pool and the warp grid stay fp32")
        parser.add_argument("--remat", action="store_true",
                            help="rematerialize generator blocks (trade FLOPs for "
                                 "HBM; enables 512^2 batch-32 on one chip)")
        parser.add_argument("--warp_impl", type=str, default="auto",
                            help="grid_sample implementation [auto | xla | "
                                 "pallas | mm | shift] ('shift' arms the "
                                 "bounded-displacement roll forward, exact "
                                 "fallback for any field)")
        parser.add_argument("--norm_impl", type=str, default="xla",
                            help="instance-norm implementation [xla | pallas]")
        parser.add_argument("--block_impl", type=str, default="xla",
                            choices=["xla", "pallas", "pallas_all"],
                            help="generator conv kernels: 'pallas' fuses each "
                                 "trunk ResNet block (conv3x3+IN+ReLU x2 + "
                                 "skip) into one VMEM-resident kernel "
                                 "(ops/conv_fused.py; wins ~17%% on the trunk "
                                 "fwd+bwd); 'pallas_all' also fuses the "
                                 "ConvTranspose decoder stages (measured "
                                 "slower than XLA's lowering — kept for "
                                 "future tuning)")
        parser.add_argument("--c7_impl", type=str, default="xla",
                            choices=["xla", "s2d", "fact", "factg", "auto",
                                     "roll"],
                            help="ResnetGenerator c7s1 convs: 's2d' = EXACT "
                                 "space-to-depth(4) blocked rewrite "
                                 "(ops/conv_s2d.py); 'fact' = EXACT "
                                 "(7x1)∘(1x7) head factorization "
                                 "(ops/conv_fact.py, FLOP-preserving); "
                                 "'roll' = s2d encoder + roll-based Pallas "
                                 "head kernel (ops/conv_head_roll.py); "
                                 "'auto' = best measured per conv (s2d "
                                 "encoder + fact head). All fall back to the "
                                 "direct lowering when H or W %% 4 != 0")
        parser.add_argument("--profile_dir", type=str, default="",
                            help="if set, write a jax.profiler trace of the hot loop here")
        parser.add_argument("--data_shard_count", type=int, default=-1,
                            help="multi-host data shards for --loader grain "
                                 "(-1: jax.process_count())")
        parser.add_argument("--data_shard_index", type=int, default=0,
                            help="this host's shard (used when "
                                 "--data_shard_count >= 0)")
        self.initialized = True
        return parser

    def gather_options(self, args=None):
        """Two-pass parse with dynamic model/dataset flag injection."""
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter
        )
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(args)

        # Inject model-specific flags (reference: models.get_option_setter).
        from nemar_tpu_torch import models as models_pkg

        model_option_setter = models_pkg.get_option_setter(opt.model)
        parser = model_option_setter(parser, self.isTrain)
        opt, _ = parser.parse_known_args(args)

        # Inject dataset-specific flags.
        from nemar_tpu_torch import data as data_pkg

        dataset_option_setter = data_pkg.get_option_setter(opt.dataset_mode)
        parser = dataset_option_setter(parser, self.isTrain)

        self.parser = parser
        return parser.parse_args(args)

    def print_options(self, opt):
        """Pretty-print options and dump to checkpoints/{name}/opt.txt."""
        message = "----------------- Options ---------------\n"
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = f"\t[default: {default}]"
            message += f"{str(k):>25}: {str(v):<30}{comment}\n"
        message += "----------------- End -------------------"
        print(message)

        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        file_name = os.path.join(expr_dir, f"{opt.phase}_opt.txt" if hasattr(opt, "phase") else "opt.txt")
        with open(file_name, "w") as f:
            f.write(message + "\n")

    def parse(self, args=None):
        opt = self.gather_options(args)
        opt.isTrain = self.isTrain

        # --suffix name templating (reference behavior).
        if opt.suffix:
            suffix = ("_" + opt.suffix.format(**vars(opt))) if opt.suffix != "" else ""
            opt.name = opt.name + suffix

        if opt.dataroot is None and opt.dataset_mode != "synthetic":
            self.parser.error(
                f"--dataroot is required for --dataset_mode {opt.dataset_mode} "
                "(only the synthetic dataset runs without one)"
            )

        self.print_options(opt)

        # "-1" (or nothing) -> [] = the CPU; "k" -> [k] = cuda:k; "j,k" ->
        # [j, k], of which --num_devices N > 0 keeps the first N
        str_ids = opt.gpu_ids.split(",")
        opt.gpu_ids = [int(s) for s in str_ids if s.strip() not in ("", "-1")]
        if opt.num_devices > 0:
            opt.gpu_ids = opt.gpu_ids[:opt.num_devices]

        self.opt = opt
        return opt
