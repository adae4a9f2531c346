"""The committed registration recipe on the port: joint NeMAR training on the
synthetic dataset, then R refined against the frozen translator, with the
held-out registration error written as a trajectory.

    python -m nemar_tpu_torch.science [E1] [E1_decay] [E2] [seed] [res] [stn] [fresh] [pyr=N] [gate=E:T]
    python -m nemar_tpu_torch.science 120 20 20 0 256 unet fresh --out runs/flagship.jsonl
    python -m nemar_tpu_torch.science 2 0 1 0 32 --gpu_ids -1      # on the CPU

The counterpart of the JAX package's ``scripts/science_final.py``, argument
for argument (defaults ``45 10 15 0 64 unet``):

  * ``build``: the recipe's flags: smooth appearance, pad-crop, a recon
    pyramid of ``3 + log2(res / 64)`` octaves (``pyr=N`` overrides), the
    border mask, R at ``--stn_lr 1e-3 --stn_beta1 0.9``, G and D at ngf 32,
    R at stn_ngf 16 and depth 6 at 256^2 (4 below); ``stn unet`` is the
    damped multiscale UNet (warm-up 3, ramp 8, clip 0.5; the tanh flow
    bound and order-2 TV from 128^2), ``stn affine`` the affine STN on
    fresh per-visit misalignments. The JAX recipe's TPU-only ``--bf16`` is
    not taken: the port trains in fp32 (ROADMAP.md A7);
  * phase 1: E1 + E1_decay epochs of the joint step, the lr stepped per
    epoch; phase 2: E2 epochs with G and D frozen and R's warm-up and ramp
    off, the lr restored to ``--lr`` and decayed linearly to 0 over the
    phase by assigning ``model.current_lr``; ``latest`` and
    ``latest_refined`` saved after each;
  * ``gate=E:T``: after E epochs, restart from the seed ``seed + 100000 *
    restart`` until the held-out per-pixel direction cosine is at least T
    (at most 8 restarts); the held-out set stays the base seed's;
  * every 5th epoch of phase 1 and every 3rd of phase 2, ``evaluate``: EPE,
    identity EPE, mean |flow|, NCC and the direction cosines on 16 training
    and 16 held-out pairs (seed + 1000), one jsonl record each, in the JAX
    script's keys. The last line printed is a JSON summary with
    ``final_epe_ho_px``, ``minutes`` and the ms per step of each phase.

``--gpu_ids`` (default 0, the card; -1 the CPU), ``--synthetic_size``
(default the recipe's 192 pairs), ``--out`` (the jsonl; default
``science_final_torch{tag}.jsonl`` in the temporary directory) and
``--checkpoints_dir`` (default ``sci_final_torch{tag}`` there) may follow.

``run_adversarial_gate`` is the counterpart of ``_run_gate`` in the JAX
package's ``tests/test_adversarial_gate.py``: the joint recipe at its 64^2
operating point, shortened to the epoch where the held-out field locks its
direction.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.data.synthetic_dataset import SyntheticDataset
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.models.base_model import to_numpy_nhwc
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils import metrics as M

EVAL_PAIRS = 16
MAX_RESTARTS = 8


@dataclass
class Recipe:
    e1: int = 45
    e1d: int = 10
    e2: int = 15
    seed: int = 0
    res: int = 64
    stn: str = "unet"
    fresh: bool = False
    pyr: int = 3
    gate: tuple | None = None
    gpu_ids: str = "0"
    synthetic_size: int = 192
    out: str = ""
    checkpoints_dir: str = ""

    @property
    def tag(self) -> str:
        return ((f"_{self.stn}" if self.stn != "unet" else "")
                + (f"_s{self.seed}" if self.seed else "")
                + (f"_r{self.res}" if self.res != 64 else "")
                + ("_fresh" if self.fresh else "")
                + (f"_p{self.pyr}" if self.pyr != 3 else "")
                + ("_gate" if self.gate else ""))


def parse_args(argv=None) -> Recipe:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("args", nargs="*", help="E1 E1_decay E2 seed res stn [fresh] [pyr=N] [gate=E:T]")
    p.add_argument("--gpu_ids", default=Recipe.gpu_ids, help="the card's id, or -1 for the CPU")
    p.add_argument("--synthetic_size", type=int, default=Recipe.synthetic_size,
                   help="synthetic training pairs")
    p.add_argument("--out", default="", help="the trajectory's jsonl")
    p.add_argument("--checkpoints_dir", default="", help="where latest and latest_refined go")
    ns = p.parse_args(argv)
    extra = [t for t in ns.args if t == "fresh" or "=" in t]
    pos = [t for t in ns.args if t not in extra]
    if len(pos) > 6:
        raise SystemExit(f"unknown arguments {pos[6:]}")
    r = Recipe(gpu_ids=ns.gpu_ids, synthetic_size=ns.synthetic_size)
    for i, (name, cast) in enumerate((("e1", int), ("e1d", int), ("e2", int), ("seed", int),
                                      ("res", int), ("stn", str))):
        if i < len(pos):
            setattr(r, name, cast(pos[i]))
    r.fresh = "fresh" in extra
    # the coarsest recon-pyramid cell grows with res, as the misalignment does
    r.pyr = 3 + max(0, int(np.log2(r.res / 64)))
    for tok in extra:
        if tok.startswith("pyr="):
            r.pyr = int(tok.split("=")[1])
        elif tok.startswith("gate="):
            ge, gt = tok.split("=")[1].split(":")
            r.gate = (int(ge), float(gt))
        elif tok != "fresh":
            raise SystemExit(f"unknown argument {tok!r}")
    r.out = ns.out or os.path.join(tempfile.gettempdir(), f"science_final_torch{r.tag}.jsonl")
    r.checkpoints_dir = ns.checkpoints_dir or os.path.join(tempfile.gettempdir(),
                                                           f"sci_final_torch{r.tag}")
    return r


def recipe_flags(r: Recipe, seed: int) -> list:
    """``scripts/science_final.py``'s flags (its ``build``), without
    ``--bf16``, on ``--gpu_ids``."""
    if r.stn != "unet":
        arm = ["--synthetic_fresh_affine", "--lambda_smooth", "0.1",
               "--stn_warmup_epochs", "3", "--stn_ramp_epochs", "5", "--stn_grad_clip", "1.0"]
    elif r.res < 256:
        arm = ["--stn_multiscale", "--stn_level_scale", "0.25", "--stn_warmup_epochs", "3",
               "--stn_ramp_epochs", "8", "--stn_grad_clip", "0.5"]
        if r.res >= 128:  # the tanh bound at 2x the task's largest |flow|
            arm += ["--stn_bounded_flow", str(round(0.05 * 2 * 2.5, 3)),
                    "--stn_smooth_order", "2"]
    else:
        arm = ["--stn_multiscale", "--stn_level_scale", "0.25", "--stn_bounded_flow", "0.15",
               "--lambda_smooth", "40", "--stn_smooth_order", "2", "--stn_warmup_epochs", "3",
               "--stn_ramp_epochs", "8", "--stn_grad_clip", "0.5"]
    return [
        "--dataroot", "__synthetic__", "--dataset_mode", "synthetic",
        "--model", "nemar", "--stn_type", r.stn,
        "--name", f"final{r.tag}", "--checkpoints_dir", r.checkpoints_dir,
        "--seed", str(seed), "--gpu_ids", r.gpu_ids,
        "--crop_size", str(r.res), "--load_size", str(r.res),
        "--batch_size", "8", "--synthetic_size", str(r.synthetic_size),
        "--synthetic_pad_crop", "--synthetic_appearance", "smooth",
        "--recon_pyramid", str(r.pyr), "--border_mask",
        *(["--synthetic_fresh_affine"] if r.fresh else []), *arm,
        "--stn_lr", "1e-3", "--stn_beta1", "0.9",
        "--n_epochs", str(r.e1), "--n_epochs_decay", str(r.e1d),
        "--save_epoch_freq", "10000", "--print_freq", "100000",
        "--display_freq", "1000000", "--no_html",
        "--ngf", "32", "--ndf", "32", "--stn_ngf", "16",
        "--stn_depth", "6" if r.res >= 256 else "4",
    ]


def build(r: Recipe, seed: int) -> tuple:
    """(opt, dataset, model) of the recipe at ``seed``, set up for training."""
    opt = TrainOptions().parse(recipe_flags(r, seed))
    dataset = create_dataset(opt)
    model = create_model(opt)
    model.setup(opt)
    return opt, dataset, model


def pack(items: list, res: int) -> tuple:
    """(A, B, ground-truth fields) of dataset items, NHWC numpy."""
    return (np.stack([it["A"] for it in items]), np.stack([it["B"] for it in items]),
            [M.registration_gt_flow(it["theta_gt"], res, res) for it in items])


def heldout_pack(opt, seed: int, n: int) -> tuple:
    """n pairs of the recipe's synthetic set at ``seed``."""
    eval_opt = copy.deepcopy(opt)
    eval_opt.seed = seed
    ds = SyntheticDataset(eval_opt)
    return pack([ds[i] for i in range(n)], opt.crop_size)


def predict(model, a: np.ndarray, b: np.ndarray) -> tuple:
    """(flow (N, H, W, 2), reg_fakeB (N, H, W, C)) as numpy: one forward
    without autograd."""
    with torch.no_grad():
        model.set_input({"A": a, "B": b, "A_paths": ["e"] * len(a)})
        out = model.forward()
        return model.last_flow, to_numpy_nhwc(out["reg_fakeB"])


def direction_cos(flow: np.ndarray, gts: list) -> tuple:
    """(mean-vector cosines of the samples whose mean vectors are not ~0,
    per-pixel cosines averaged over each sample), of predicted fields
    against their ground truths."""
    cos, pcos = [], []
    for j in range(len(gts)):
        pv, gv = flow[j].mean((0, 1)), gts[j].mean((0, 1))
        den = np.linalg.norm(pv) * np.linalg.norm(gv)
        if den > 1e-8:
            cos.append(float(pv @ gv / den))
        num = (flow[j] * gts[j]).sum(-1)
        dn = np.linalg.norm(flow[j], axis=-1) * np.linalg.norm(gts[j], axis=-1) + 1e-8
        pcos.append(float((num / dn).mean()))
    return cos, pcos


def evaluate(model, packs: dict, res: int) -> dict:
    """The JAX script's evaluation record (without phase and epoch), for
    each pack ``key``: ``epe_key`` (px), ``epe0_key`` (the identity's),
    ``flow_key`` (mean |flow| in px), ``ncc_key`` (reg_fakeB against B),
    ``cos_key`` (mean-vector direction cosine) and ``pcos_key`` (per-pixel)."""
    rec = {}
    for key, (ea, eb, gts) in packs.items():
        flow, reg = predict(model, ea, eb)
        epe = float(np.mean([M.epe_px(flow[j], gts[j], res, res) for j in range(len(gts))]))
        epe0 = float(np.mean([M.epe_px(np.zeros_like(g), g, res, res) for g in gts]))
        cos, pcos = direction_cos(flow, gts)
        rec.update({
            f"epe_{key}": round(epe, 3), f"epe0_{key}": round(epe0, 3),
            f"flow_{key}": round(float(np.mean(np.abs(flow))) * res / 2, 3),
            f"ncc_{key}": round(M.ncc(reg, eb), 4),
            f"cos_{key}": round(float(np.mean(cos)) if cos else 0.0, 3),
            f"pcos_{key}": round(float(np.mean(pcos)), 3),
        })
    return rec


def fp32_convs() -> None:
    """cuDNN's convolutions in fp32: PyTorch lets them round their inputs to
    TF32 unless told not to. The recipe runs in fp32 (its hand-written
    GEMMs in 3xTF32), as ``chip_smoke.py`` runs the port."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def train_epoch(model, dataset) -> tuple:
    """One epoch of steps: (steps, seconds, the card synchronised at the end)."""
    t0 = time.perf_counter()
    steps = 0
    for data in dataset:
        model.set_input(data)
        model.optimize_parameters()
        steps += 1
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return steps, time.perf_counter() - t0


def main(argv=None) -> dict:
    r = parse_args(argv)
    fp32_convs()
    opt, dataset, model = build(r, r.seed)
    # the held-out set is the base seed's whatever the gate's restarts: the
    # task stays fixed, only the trajectory's draw changes
    packs = {"tr": pack([dataset.dataset[i] for i in range(EVAL_PAIRS)], r.res),
             "ho": heldout_pack(opt, r.seed + 1000, EVAL_PAIRS)}
    os.makedirs(os.path.dirname(os.path.abspath(r.out)), exist_ok=True)
    f = open(r.out, "w")

    def write(rec):
        f.write(json.dumps(rec) + "\n")
        f.flush()

    def log(phase, epoch):
        rec = {"phase": phase, "epoch": epoch, **evaluate(model, packs, r.res)}
        write(rec)
        print(rec, flush=True)
        return rec

    timing = {"P1": [0, 0.0], "P2": [0, 0.0]}

    def epoch_of(phase):
        n, s = train_epoch(model, dataset)
        timing[phase][0] += n
        timing[phase][1] += s

    t0 = time.time()
    start_epoch = 1
    if r.gate is not None:
        ge, gth = r.gate
        restart = 0
        while True:
            rec = None
            for epoch in range(1, ge + 1):
                model.set_epoch(epoch)
                epoch_of("P1")
                model.update_learning_rate(epoch)
                if epoch % 5 == 0 or epoch == ge:
                    rec = log(f"P1_gate{restart}", epoch)
            if rec["pcos_ho"] >= gth or restart >= MAX_RESTARTS:
                write({"phase": "gate_pass", "restart": restart, "pcos_ho": rec["pcos_ho"],
                       "forced": rec["pcos_ho"] < gth})
                start_epoch = ge + 1
                break
            restart += 1
            next_seed = r.seed + 100000 * restart
            write({"phase": "gate_fail", "restart": restart - 1, "pcos_ho": rec["pcos_ho"],
                   "next_seed": next_seed})
            print(f"gate FAIL (pcos_ho {rec['pcos_ho']}) -> restart {restart}", flush=True)
            del model
            opt, dataset, model = build(r, next_seed)
            packs["tr"] = pack([dataset.dataset[i] for i in range(EVAL_PAIRS)], r.res)
    epe = None
    for epoch in range(start_epoch, r.e1 + r.e1d + 1):
        model.set_epoch(epoch)
        epoch_of("P1")
        model.update_learning_rate(epoch)
        if epoch % 5 == 0 or epoch == r.e1 + r.e1d:
            epe = log("P1_joint", epoch)["epe_ho"]
    model.save_networks("latest")

    # Phase 2: R alone against the frozen translator. The joint schedule has
    # decayed the lr to ~0 by now, so the phase restores --lr and decays it
    # linearly to 0 over its epochs; the assignment takes effect at the next
    # step. R's warm-up and ramp are off and the epoch is pinned past them.
    model.freeze_g = True
    model.stn_warmup = 0
    model.stn_ramp = 0
    for epoch in range(1, r.e2 + 1):
        model.set_epoch(r.e1)
        model.current_lr = opt.lr * (1.0 - (epoch - 1) / max(r.e2, 1))
        epoch_of("P2")
        if epoch % 3 == 0 or epoch == r.e2:
            epe = log("P2_refine", epoch)["epe_ho"]
    model.save_networks("latest_refined")
    f.close()
    summary = {"config": f"final{r.tag}", "final_epe_ho_px": epe,
               "minutes": round((time.time() - t0) / 60, 1),
               "ms_per_step": {k: round(s / n * 1e3, 3) if n else None
                               for k, (n, s) in timing.items()},
               "steps": {k: n for k, (n, _) in timing.items()},
               "device": str(model.device), "out": r.out}
    print(json.dumps(summary), flush=True)
    return summary


def run_adversarial_gate(res: int, pairs: int, epochs: int, ngf: int = 32,
                         device: str = "cuda") -> tuple:
    """The joint recipe at ``res`` on ``pairs`` synthetic pairs for
    ``epochs`` epochs (the JAX package's ``_run_gate``: recon pyramid 3,
    border mask, the damped depth-4 multiscale UNet, G and D at ``ngf``),
    evaluated on 12 held-out pairs (seed 1000) after each of the last 6
    epochs. Returns (the best mean-vector direction cosine, the largest
    mean |flow| in px, the trail of (cos, px) per evaluated epoch, ms per
    training step). The adversarial end-game makes the cosine oscillate
    from epoch to epoch after it locks, so the gate takes the best of the
    window: a decayed, antiparallel or exploded field fails at every epoch."""
    fp32_convs()
    dev = torch.device(device)
    gpu_ids = "-1" if dev.type == "cpu" else str(dev.index or 0)
    with tempfile.TemporaryDirectory(prefix="adv_gate") as ckpt:
        opt = TrainOptions().parse([
            "--dataroot", "__synthetic__", "--dataset_mode", "synthetic",
            "--model", "nemar", "--stn_type", "unet", "--gpu_ids", gpu_ids,
            "--name", f"adv_gate{res}", "--checkpoints_dir", ckpt,
            "--crop_size", str(res), "--load_size", str(res),
            "--batch_size", "8", "--synthetic_size", str(pairs),
            "--synthetic_pad_crop", "--synthetic_appearance", "smooth",
            "--recon_pyramid", "3", "--border_mask",
            "--stn_multiscale", "--stn_level_scale", "0.25",
            "--stn_warmup_epochs", "3", "--stn_ramp_epochs", "8",
            "--stn_grad_clip", "0.5",
            "--stn_lr", "1e-3", "--stn_beta1", "0.9",
            "--n_epochs", str(epochs), "--n_epochs_decay", "0",
            "--save_epoch_freq", "10000", "--print_freq", "100000",
            "--display_freq", "1000000", "--no_html",
            "--ngf", str(ngf), "--ndf", str(ngf), "--stn_ngf", "16",
            "--stn_depth", "4",
        ])
        dataset = create_dataset(opt)
        model = create_model(opt)
        model.setup(opt)
        ea, eb, gts = heldout_pack(opt, 1000, 12)
        trail, steps, secs = [], 0, 0.0
        for epoch in range(1, epochs + 1):
            model.set_epoch(epoch)
            n, s = train_epoch(model, dataset)
            steps, secs = steps + n, secs + s
            model.update_learning_rate(epoch)
            if epoch > epochs - 6:
                flow, _ = predict(model, ea, eb)
                cos, _ = direction_cos(flow, gts)
                # an identity field has no direction: 0, as in the records
                trail.append((float(np.mean(cos)) if cos else 0.0,
                              float(np.mean(np.abs(flow))) * res / 2))
    cos = max(c for c, _ in trail)
    mag = max(m for _, m in trail)
    return cos, mag, trail, secs / max(steps, 1) * 1e3


if __name__ == "__main__":
    main()
