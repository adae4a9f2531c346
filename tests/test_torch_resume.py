"""``--continue_train`` restores the port's full training state.

A tiny NeMAR model (ResNet-6 G at ngf 8, depth-3 UNet STN at stn_ngf 8, ndf
8, 32^2, batch 2) on the CPU takes 2 steps on fixed synthetic batches (epoch
1), saves as ``train.py`` does at an epoch's end (``latest``, then the
epoch), steps its lr and takes 2 more steps (epoch 2). A second model built
with ``--continue_train --epoch_count 2`` takes the same 2 steps. Every
parameter, every Adam moment and step, the step count and the lr must equal
the uninterrupted run's bit for bit, as a resumed JAX run does
(``nemar_tpu/models/base_model.py``). Before the full training state, a
resume reloaded the nets alone and its Adam started afresh.
"""

import json
import os

import numpy as np
import pytest
import torch

from nemar_tpu_torch.models import create_model
from nemar_tpu_torch import options

torch.set_num_threads(2)

TINY = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "resume",
        "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf", "8",
        "--stn_ngf", "8", "--stn_depth", "3", "--batch_size", "2", "--gpu_ids", "-1"]
# linear: epoch 2 trains at 0.75 lr, so the resumed lr is re-derived
SCHEDULE = ["--n_epochs", "1", "--n_epochs_decay", "3"]


def _batches():
    rng = np.random.default_rng(0)
    return [{"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
             "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)} for _ in range(4)]


def _model(ckpt, *flags):
    opt = options.TrainOptions().parse([*TINY, *SCHEDULE, "--checkpoints_dir", str(ckpt), *flags])
    model = create_model(opt)
    model.setup(opt)
    return model


def _train(model, batches, epoch):
    model.set_epoch(epoch)
    for b in batches:
        model.set_input(b)
        model.optimize_parameters()


def _end_epoch(model, epoch):
    """What train.py does at an epoch's end."""
    model.save_networks("latest")
    model.save_networks(epoch)
    model.update_learning_rate(epoch)


def _assert_same_state(got, want):
    assert got.current_lr == want.current_lr
    for name in ("G", "D", "R"):
        for p, q in zip(got.nets()[name].parameters(), want.nets()[name].parameters()):
            assert torch.equal(p, q), name
        sg = got.optimizers[name].state_dict()["state"]
        sw = want.optimizers[name].state_dict()["state"]
        assert sg.keys() == sw.keys() and len(sg) > 0
        for k in sw:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sg[k][key], sw[k][key]), (name, k, key)
    assert got.step == want.step == 4


@pytest.mark.parametrize("policy", ["linear", "plateau"])
def test_resumed_run_equals_uninterrupted_run(tmp_path, policy):
    batches = _batches()
    run = _model(tmp_path, "--lr_policy", policy)
    _train(run, batches[:2], 1)
    _end_epoch(run, 1)
    g_epoch1 = [p.detach().clone() for p in run.netG.parameters()]
    _train(run, batches[2:], 2)

    resumed = _model(tmp_path, "--lr_policy", policy, "--continue_train", "--epoch_count", "2")
    _train(resumed, batches[2:], 2)
    _assert_same_state(resumed, run)
    if policy == "linear":
        assert run.current_lr == 0.75 * run.opt.lr
    # the per-net files are still what the test entry point loads
    saved = sorted(os.listdir(tmp_path / "resume"))
    assert {"1_state.pth", "latest_state.pth", "checkpoint_meta.json",
            *(f"{s}_net_{n}.pth" for s in ("1", "latest") for n in "GDR")} <= set(saved)
    test_opt = options.TestOptions().parse([*TINY, "--checkpoints_dir", str(tmp_path), "--epoch", "1"])
    model = create_model(test_opt)
    model.setup(test_opt)
    assert all(torch.equal(p, q) for p, q in zip(model.netG.parameters(), g_epoch1))


def test_resume_falls_back_to_the_newest_complete_state(tmp_path):
    """The meta's ``latest`` names epoch 1, whose state file is gone (as
    after a preemption): the resume takes the newest ``*_state.pth`` there
    is (``latest``, not the older ``iter_2``) with its nets."""
    batches = _batches()
    run = _model(tmp_path)
    _train(run, batches[:1], 1)
    run.save_networks("iter_2")
    _train(run, batches[1:2], 1)
    _end_epoch(run, 1)
    _train(run, batches[2:], 2)
    ckpt = tmp_path / "resume"
    os.remove(ckpt / "1_state.pth")
    older = (ckpt / "latest_state.pth").stat().st_mtime - 3600
    os.utime(ckpt / "iter_2_state.pth", (older, older))

    resumed = _model(tmp_path, "--continue_train", "--epoch_count", "2")
    _train(resumed, batches[2:], 2)
    _assert_same_state(resumed, run)


def test_resume_without_a_state_starts_fresh(tmp_path):
    fresh = _model(tmp_path)
    resumed = _model(tmp_path, "--continue_train", "--epoch_count", "3")
    assert resumed.step == 0 and not resumed.optimizers["G"].state_dict()["state"]
    for p, q in zip(resumed.netG.parameters(), fresh.netG.parameters()):
        assert torch.equal(p, q)
    # epoch 3 trains at the multiplier of epoch 2, as a resumed JAX run
    assert resumed.current_lr == 0.5 * resumed.opt.lr


def test_state_and_meta_hold_the_training_state(tmp_path):
    run = _model(tmp_path, "--lr_policy", "plateau")
    _train(run, _batches()[:1], 1)
    run.save_networks(1)
    state = torch.load(tmp_path / "resume" / "1_state.pth", weights_only=True)
    assert state["step"] == 1 and state["current_lr"] == run.current_lr
    assert set(state["optimizers"]) == {"G", "D", "R"}
    meta = json.loads((tmp_path / "resume" / "checkpoint_meta.json").read_text())
    assert meta == {"latest": "1", "step": 1,
                    "lr_state": {"current_lr": run.current_lr,
                                 "plateau": {"best": float("inf"), "bad": 0, "mult": 1.0}}}
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path / "resume"))
