"""The port's option parsers against the JAX package's: the same command
line gives the same options (``gpu_ids`` aside: the port reads it as a
device, the JAX package as a compatibility flag) and the same flag set, for
train and test, each dataset mode and the recipe flags."""

import argparse

import pytest

from nemar_tpu.options import TestOptions as JaxTestOptions
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu_torch.options import TestOptions, TrainOptions

MODES = ["synthetic", "aligned", "unaligned", "single", "multimodal"]
RECIPES = [
    [],
    ["--stn_grad_clip", "0.001", "--stn_warmup_epochs", "1", "--stn_ramp_epochs", "2"],
    ["--recon_pyramid", "2", "--border_mask", "--lambda_recon", "50"],
    ["--freeze_g", "--stn_lr", "1e-4", "--stn_beta1", "0.9", "--lr_policy", "cosine"],
    ["--block_impl", "pallas_all", "--c7_impl", "roll", "--gan_mode", "vanilla"],
    ["--suffix", "{model}_{netG}", "--niter", "3", "--niter_decay", "2", "--gpu_ids", "-1"],
]


def _argv(mode, extra, root):
    argv = ["--dataset_mode", mode, "--name", "opts", "--checkpoints_dir", str(root), *extra]
    if mode != "synthetic":
        argv += ["--dataroot", str(root / "data")]
    return argv


def _flags(parser: argparse.ArgumentParser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def _compare(port_cls, jax_cls, argv, tmp_path):
    port, ref = port_cls(), jax_cls()
    got = vars(port.parse(argv + ["--checkpoints_dir", str(tmp_path / "port")]))
    want = vars(ref.parse(argv + ["--checkpoints_dir", str(tmp_path / "jax")]))
    for d in (got, want):
        d.pop("gpu_ids")
        d.pop("checkpoints_dir")
    assert got == want
    assert _flags(port.parser) == _flags(ref.parser)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("recipe", range(len(RECIPES)))
def test_train_options_match_jax(tmp_path, mode, recipe):
    _compare(TrainOptions, JaxTrainOptions, _argv(mode, RECIPES[recipe], tmp_path), tmp_path)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("extra", [[], ["--eval_registration", "--num_test", "3", "--eval"],
                                   ["--use_ema", "--crop_size", "128", "--gpu_ids", "0"]])
def test_test_options_match_jax(tmp_path, mode, extra):
    _compare(TestOptions, JaxTestOptions, _argv(mode, extra, tmp_path), tmp_path)


@pytest.mark.parametrize("ids,want", [("-1", []), ("0", [0]), ("1", [1]), ("0,1", [0, 1])])
def test_gpu_ids_name_devices(tmp_path, ids, want):
    opt = TestOptions().parse(_argv("synthetic", ["--gpu_ids", ids], tmp_path))
    assert opt.gpu_ids == want


def test_opt_txt_and_dataroot_check(tmp_path):
    TrainOptions().parse(_argv("synthetic", ["--ngf", "16"], tmp_path))
    lines = (tmp_path / "opts" / "train_opt.txt").read_text().splitlines()
    ngf = [ln.split() for ln in lines if ln.strip().startswith("ngf:")]
    assert ngf == [["ngf:", "16", "[default:", "64]"]]
    with pytest.raises(SystemExit):
        TrainOptions().parse(["--dataset_mode", "aligned", "--checkpoints_dir", str(tmp_path)])
