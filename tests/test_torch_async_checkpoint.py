"""``--async_checkpoint`` on the port (ROADMAP.md A12), on the CPU, no JAX.

Under the flag ``save_networks`` joins the previous save, takes host copies
of what it writes, writes the files on a background thread and returns;
``checkpoint_meta.json`` names the save only once all its files are in
place (``_flush_pending_meta``: the next save, the end of
``train.main``, or exit), as the JAX package's orbax saves
(``nemar_tpu/models/base_model.py``). Held here, on the tiny NeMAR model
of ``test_torch_resume.py``, with the writer held in flight by an event:

  * the meta stays as it was while a save is in flight, names the save once
    it has committed, and a second flush is a no-op;
  * the files hold the state at the save, not what the steps taken while
    the save was in flight wrote in place (parameters, Adam, pool, EMA);
  * a run resumed with ``--auto_resume`` from an asynchronous save equals
    the uninterrupted run bit for bit;
  * ``train.main`` publishes its last save's meta before it returns.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import test_torch_resume as tr
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import base_model

torch.set_num_threads(2)

A5 = ["--pool_size", "3", "--ema_decay", "0.9", "--async_checkpoint"]


@pytest.fixture
def held(monkeypatch):
    """The checkpoint writer, held until ``release`` is set."""
    release, started = threading.Event(), threading.Event()
    write = base_model.write_checkpoint

    def slow(files):
        started.set()
        assert release.wait(60)
        write(files)

    monkeypatch.setattr(base_model, "write_checkpoint", slow)
    return release, started


def _meta(ckpt):
    path = ckpt / "resume" / "checkpoint_meta.json"
    return json.loads(path.read_text()) if path.exists() else None


def test_meta_waits_for_the_save_in_flight(tmp_path, held):
    release, started = held
    run = tr._model(tmp_path, *A5)
    tr._train(run, tr._batches()[:1], 1)
    run.save_networks("iter_2")
    assert started.wait(60)
    ckpt = tmp_path / "resume"
    assert _meta(tmp_path) is None and not (ckpt / "iter_2_state.pth").exists()
    release.set()
    run._flush_pending_meta()
    assert _meta(tmp_path)["latest"] == "iter_2" and _meta(tmp_path)["step"] == 1
    assert {f"iter_2_net_{n}.pth" for n in ("G", "D", "R", "G_ema", "R_ema")} \
        | {"iter_2_state.pth"} <= set(os.listdir(ckpt))
    assert not [f for f in os.listdir(ckpt) if f.endswith(".tmp")]
    os.remove(ckpt / "checkpoint_meta.json")
    run._flush_pending_meta()  # nothing in flight: writes nothing
    assert _meta(tmp_path) is None


def test_a_save_snapshots_the_state_it_was_called_on(tmp_path, held):
    release, started = held
    batches = tr._batches()
    run = tr._model(tmp_path, *A5)
    tr._train(run, batches[:2], 1)
    want = {"G": {k: v.clone() for k, v in run.netG.state_dict().items()},
            "G_ema": {k: v.clone() for k, v in run.ema["G"].items()},
            "pool": run.pool[0].clone(), "exp_avg": run.optimizers["R"].state_dict()[
                "state"][0]["exp_avg"].clone(), "rng": run.rng.get_state()}
    run.save_networks("latest")
    assert started.wait(60)
    tr._train(run, batches[2:], 1)  # in place, while the save is in flight
    assert not torch.equal(run.netG.Conv_0.weight, want["G"]["Conv_0.weight"])
    release.set()
    run._flush_pending_meta()
    ckpt = tmp_path / "resume"
    for name in ("G", "G_ema"):
        saved = torch.load(ckpt / f"latest_net_{name}.pth", weights_only=True)
        assert all(torch.equal(saved[k], v) for k, v in want[name].items()), name
    state = torch.load(ckpt / "latest_state.pth", weights_only=True)
    assert state["step"] == 2 and torch.equal(state["rng"], want["rng"])
    assert torch.equal(state["pool"]["images"], want["pool"])
    assert torch.equal(state["optimizers"]["R"]["state"][0]["exp_avg"], want["exp_avg"])


def test_auto_resume_from_an_async_save_equals_uninterrupted(tmp_path):
    batches = tr._batches()
    run = tr._model(tmp_path, *A5)
    tr._train(run, batches[:2], 1)
    tr._end_epoch(run, 1)  # two saves: the second joins the first
    tr._train(run, batches[2:], 2)  # while the second is in flight
    run._flush_pending_meta()  # as at train.main's end, or at exit
    assert _meta(tmp_path)["latest"] == "1"

    resumed = tr._model(tmp_path, *A5, "--auto_resume", "--epoch_count", "2")
    assert resumed.opt.continue_train
    tr._train(resumed, batches[2:], 2)
    tr._assert_same_state(resumed, run)
    for n in ("G", "R"):
        assert all(torch.equal(v, run.ema[n][k]) for k, v in resumed.ema[n].items())
    assert torch.equal(resumed.pool[0], run.pool[0]) and int(resumed.pool[1]) == 3
    assert torch.equal(resumed.rng.get_state(), run.rng.get_state())


def test_train_main_publishes_its_last_save(tmp_path):
    args = [*tr.TINY, "--checkpoints_dir", str(tmp_path), "--synthetic_size", "4",
            "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1",
            "--async_checkpoint"]
    model = port_train.main(args)
    assert getattr(model, "_save_thread", None) is None
    meta = _meta(tmp_path)
    assert (meta["latest"], meta["step"]) == ("1", 2)
    state = torch.load(tmp_path / "resume" / "1_state.pth", weights_only=True)
    assert state["step"] == 2
    np.testing.assert_array_equal(
        torch.load(tmp_path / "resume" / "1_net_G.pth", weights_only=True)["Conv_0.weight"],
        model.netG.Conv_0.weight.detach())
