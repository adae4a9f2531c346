"""Two training flags the port once parsed and ignored, where the JAX
package acts (``nemar_tpu/models/base_model.py:setup``, ``train.py``):

  * ``--auto_resume`` continues from ``checkpoint_meta.json`` when there is
    one, as ``--continue_train`` does (the nets, every Adam state, the step
    count; two more steps then equal an uninterrupted run's bit for bit),
    and starts fresh without one, as ``tests/test_checkpoint.py::
    test_auto_resume`` holds for the JAX package;
  * ``--profile_dir`` makes ``nemar_tpu_torch.train`` write a
    ``torch.profiler`` trace of its loop there, where the JAX package writes
    its ``jax.profiler`` trace.

The tiny model and its batches are ``tests/test_torch_resume.py``'s.
"""

import glob
import json
import os

import test_torch_resume as tr
import torch

from nemar_tpu_torch import train as port_train


def test_auto_resume_continues_from_the_meta(tmp_path, capsys):
    batches = tr._batches()
    run = tr._model(tmp_path)
    tr._train(run, batches[:2], 1)
    tr._end_epoch(run, 1)
    capsys.readouterr()

    resumed = tr._model(tmp_path, "--auto_resume", "--epoch_count", "2")
    assert "auto-resume: found a checkpoint" in capsys.readouterr().out
    assert resumed.opt.continue_train and resumed.step == 2
    for name in ("G", "D", "R"):
        want = run.optimizers[name].state_dict()["state"]
        got = resumed.optimizers[name].state_dict()["state"]
        assert got.keys() == want.keys() and len(got) > 0
        for k in want:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(got[k][key], want[k][key]), (name, k, key)
    tr._train(run, batches[2:], 2)
    tr._train(resumed, batches[2:], 2)
    tr._assert_same_state(resumed, run)


def test_auto_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    fresh = tr._model(tmp_path, "--auto_resume")
    assert "starting fresh" in capsys.readouterr().out
    assert not fresh.opt.continue_train and fresh.step == 0
    assert not fresh.optimizers["G"].state_dict()["state"]
    assert not os.path.exists(tmp_path / "resume" / "checkpoint_meta.json")


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    port_train.main([*tr.TINY, "--checkpoints_dir", str(tmp_path / "ckpt"), "--synthetic_size",
                     "2", "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "0",
                     "--profile_dir", str(prof)])
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(prof)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the step's ops are in it: the STN's convolutions and the optimizer's
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names) and any("Adam" in n for n in names), sorted(names)[:50]


def test_no_profile_dir_writes_no_trace(tmp_path):
    port_train.main([*tr.TINY, "--checkpoints_dir", str(tmp_path / "ckpt"), "--synthetic_size",
                     "2", "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "0"])
    assert not glob.glob(str(tmp_path / "**" / "*.pt.trace.json"), recursive=True)
