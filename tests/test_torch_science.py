"""The port's science entry point (``nemar_tpu_torch/science.py``) and the lr it
relies on, on the CPU.

  * ``model.current_lr``, assigned, sets the next step's lr in every Adam
    group, times the group's ``lr_ratio``: the step then equals, bit for
    bit, the step of a model built with that ``--lr`` (the JAX package's
    step reads ``current_lr`` at every call; the science recipe's phase 2
    assigns it). ``update_learning_rate`` and a ``--continue_train`` resume
    still set the groups from the schedule.
  * A tiny science run (32^2, 16 pairs, ``2 0 1 0 32 gate=1:2.0``): the gate
    cannot pass, so it restarts at ``seed + 100000 * restart`` until its
    8th restart is forced through; every evaluation record has the JAX
    script's keys; the held-out pack is the base seed's in every
    evaluation while the training pack follows the restarts; phase 2 moves
    R and leaves G and D bit-equal (``latest`` against ``latest_refined``).
  * ``evaluate`` on a fixed flow against the JAX script's formulas on
    ``nemar_tpu.utils.metrics``, to the last rounded digit.
  * ``run_adversarial_gate`` at a tiny size: the trail of the last epochs,
    the field at the identity through R's warm-up and moving after it.
"""

import json
import os

import numpy as np
import torch

from nemar_tpu.utils import metrics as JM
from nemar_tpu_torch import science
from nemar_tpu_torch.data.synthetic_dataset import SyntheticDataset
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions

torch.set_num_threads(2)

TINY = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "lr",
        "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf", "8",
        "--stn_ngf", "8", "--stn_depth", "3", "--batch_size", "2", "--gpu_ids", "-1",
        "--n_epochs", "1", "--n_epochs_decay", "3"]
# the keys of scripts/science_final.py's evaluation record
RECORD_KEYS = {"phase", "epoch"} | {f"{m}_{k}" for m in ("epe", "epe0", "flow", "ncc", "cos", "pcos")
                                    for k in ("tr", "ho")}


def _model(ckpt, *flags):
    opt = TrainOptions().parse([*TINY, "--checkpoints_dir", str(ckpt), *flags])
    model = create_model(opt)
    model.setup(opt)
    model.set_epoch(1)
    return model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
            "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}


def _group_lrs(model):
    return {n: [g["lr"] for g in o.param_groups] for n, o in model.optimizers.items()}


def _params(model):
    return {n: [p.detach().clone() for p in net.parameters()] for n, net in model.nets().items()}


def test_assigned_current_lr_sets_the_next_step(tmp_path):
    """R's --stn_lr ratio is 4 in both models: 8e-4 / 2e-4 and 1e-3 / 2.5e-4."""
    x = 2.5e-4
    model = _model(tmp_path, "--lr", "2e-4", "--stn_lr", "8e-4")
    want = _model(tmp_path, "--lr", str(x), "--stn_lr", "1e-3")
    model.current_lr = x
    assert model.current_lr == x
    assert _group_lrs(model) == {"G": [x], "D": [x], "R": [4 * x]} == _group_lrs(want)
    before = _params(model)
    for m in (model, want):
        m.set_input(_batch())
        m.optimize_parameters()
    got, ref = _params(model), _params(want)
    for name in ("G", "D", "R"):
        assert any(not torch.equal(p, q) for p, q in zip(got[name], before[name])), name
        for p, q in zip(got[name], ref[name]):
            assert torch.equal(p, q), name


def test_schedule_and_resume_still_set_the_groups(tmp_path):
    """update_learning_rate steps the groups by the policy (linear: epoch 2
    trains at 0.75 lr); a --continue_train resume takes its lr from
    --epoch_count, not the lr assigned before the save."""
    model = _model(tmp_path, "--stn_lr", "8e-4")
    lr = model.opt.lr
    assert _group_lrs(model) == {"G": [lr], "D": [lr], "R": [8e-4]}
    model.set_input(_batch())
    model.optimize_parameters()
    model.update_learning_rate(1)
    assert model.current_lr == 0.75 * lr
    assert _group_lrs(model) == {"G": [0.75 * lr], "D": [0.75 * lr], "R": [0.75 * lr * 4]}
    model.current_lr = 1e-5  # saved with the state, then re-derived on resume
    model.save_networks("latest")
    resumed = _model(tmp_path, "--stn_lr", "8e-4", "--continue_train", "--epoch_count", "2")
    assert resumed.current_lr == 0.75 * lr
    assert _group_lrs(resumed) == {"G": [0.75 * lr], "D": [0.75 * lr], "R": [0.75 * lr * 4]}


def test_science_run_gate_restarts_and_refinement(tmp_path, monkeypatch):
    seeds, ho_packs, tr_packs = [], [], []
    build, evaluate = science.build, science.evaluate

    def build_spy(r, seed):
        out = build(r, seed)
        seeds.append((seed, out[0].seed, out[2].opt.seed))
        return out

    def evaluate_spy(model, packs, res):
        ho_packs.append(packs["ho"])
        tr_packs.append(packs["tr"])
        return evaluate(model, packs, res)

    monkeypatch.setattr(science, "build", build_spy)
    monkeypatch.setattr(science, "evaluate", evaluate_spy)
    out, ckpt = tmp_path / "traj.jsonl", tmp_path / "ckpt"
    summary = science.main(["2", "0", "1", "0", "32", "gate=1:2.0", "--gpu_ids", "-1",
                            "--synthetic_size", "16", "--out", str(out),
                            "--checkpoints_dir", str(ckpt)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]

    # the gate: 8 restarts, each from seed + 100000 * restart, the last forced
    assert [s for s, _, _ in seeds] == [100000 * k for k in range(9)]
    assert all(a == b == c for a, b, c in seeds)
    fails = [r for r in recs if r["phase"] == "gate_fail"]
    assert [(r["restart"], r["next_seed"]) for r in fails] == [(k, 100000 * (k + 1))
                                                               for k in range(8)]
    (passed,) = [r for r in recs if r["phase"] == "gate_pass"]
    assert passed == {"phase": "gate_pass", "restart": 8, "pcos_ho": passed["pcos_ho"],
                      "forced": True}
    evals = [r for r in recs if "epoch" in r]
    assert [r["phase"] for r in evals] == [f"P1_gate{k}" for k in range(9)] + ["P1_joint",
                                                                               "P2_refine"]
    for r in evals:
        assert set(r) == RECORD_KEYS, r["phase"]
        assert all(np.isfinite(v) for k, v in r.items() if k != "phase")
    assert summary["final_epe_ho_px"] == evals[-1]["epe_ho"]
    assert summary["steps"] == {"P1": 9 * 2 + 2, "P2": 2}

    # the held-out pack is seed 1000's throughout; the training pack follows
    # the restarts
    opt = TrainOptions().parse(science.recipe_flags(science.parse_args(
        ["2", "0", "1", "0", "32", "--synthetic_size", "16", "--checkpoints_dir",
         str(tmp_path / "o")]), 1000))
    ds = SyntheticDataset(opt)
    want_a = np.stack([ds[i]["A"] for i in range(16)])
    assert len(ho_packs) == 11
    for a, b, gts in ho_packs:
        np.testing.assert_array_equal(a, want_a)
        np.testing.assert_array_equal(a, ho_packs[0][0])
        np.testing.assert_array_equal(b, ho_packs[0][1])
        for g, g0 in zip(gts, ho_packs[0][2]):
            np.testing.assert_array_equal(g, g0)
    assert not np.array_equal(tr_packs[0][0], tr_packs[1][0])

    # phase 2 trains R alone, at a real lr
    run = ckpt / "final_r32_gate"
    for name in "GDR":
        p1 = torch.load(run / f"latest_net_{name}.pth", weights_only=True)
        p2 = torch.load(run / f"latest_refined_net_{name}.pth", weights_only=True)
        same = all(torch.equal(p1[k], p2[k]) for k in p1)
        assert same == (name != "R"), name
    assert os.path.exists(run / "latest_refined_state.pth")


class _FixedFlowModel:
    """A model whose forward gives a fixed field and registered image."""

    def __init__(self, flow, reg):
        self.flow, self.reg = flow, reg

    def set_input(self, data):
        self.n = len(data["A"])

    def forward(self):
        self.last_flow = self.flow[: self.n]
        return {"reg_fakeB": torch.from_numpy(self.reg[: self.n]).permute(0, 3, 1, 2)}


def _jax_script_record(flow, reg, packs, res):
    """scripts/science_final.py's evaluate, its formulas on the JAX
    package's metrics."""
    rec = {}
    for key, (ea, eb, gts) in packs.items():
        epe = float(np.mean([JM.epe_px(flow[j], gts[j], res, res) for j in range(len(gts))]))
        epe0 = float(np.mean([JM.epe_px(np.zeros_like(g), g, res, res) for g in gts]))
        cos, pcos = [], []
        for j in range(len(gts)):
            pv, gv = flow[j].mean((0, 1)), gts[j].mean((0, 1))
            den = np.linalg.norm(pv) * np.linalg.norm(gv)
            if den > 1e-8:
                cos.append(float(pv @ gv / den))
            num = (flow[j] * gts[j]).sum(-1)
            dn = (np.linalg.norm(flow[j], axis=-1) * np.linalg.norm(gts[j], axis=-1) + 1e-8)
            pcos.append(float((num / dn).mean()))
        rec.update({
            f"epe_{key}": round(epe, 3), f"epe0_{key}": round(epe0, 3),
            f"flow_{key}": round(float(np.mean(np.abs(flow))) * res / 2, 3),
            f"ncc_{key}": round(JM.ncc(reg, eb), 4),
            f"cos_{key}": round(float(np.mean(cos)) if cos else 0.0, 3),
            f"pcos_{key}": round(float(np.mean(pcos)), 3),
        })
    return rec


def test_evaluate_matches_the_jax_metrics():
    rng = np.random.default_rng(3)
    res, n = 32, 6
    packs = {}
    for key in ("tr", "ho"):
        thetas = [np.asarray([[np.cos(t), -np.sin(t), dx], [np.sin(t), np.cos(t), dy]],
                             np.float32) for t, dx, dy in rng.uniform(-2, 2, (n, 3)) * [0.05, 1, 1]]
        packs[key] = (rng.uniform(-1, 1, (n, res, res, 1)).astype(np.float32),
                      rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32),
                      [JM.registration_gt_flow(t, res, res) for t in thetas])
    flow = 0.05 * rng.standard_normal((n, res, res, 2)).astype(np.float32)
    flow[0] = 0.0  # a zero mean vector: left out of cos, as in the script
    reg = rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    got = science.evaluate(_FixedFlowModel(flow, reg), packs, res)
    assert got == _jax_script_record(flow, reg, packs, res)
    assert set(got) == RECORD_KEYS - {"phase", "epoch"}


def test_adversarial_gate_runs_at_a_tiny_size():
    """4 epochs of 2 steps at 48^2, ngf 8: R is frozen for 3 epochs (the
    field stays the identity) and opens at 1/8 in the 4th."""
    cos, mag, trail, ms = science.run_adversarial_gate(48, 16, 4, ngf=8, device="cpu")
    assert len(trail) == 4
    assert trail[:3] == [(0.0, 0.0)] * 3
    assert trail[3][1] > 0.0 and mag == trail[3][1]
    assert np.isfinite(trail[3][0]) and cos == max(0.0, trail[3][0])
    assert ms > 0.0
