"""Test / inference entry point (reference ``test.py``), PyTorch.

    python -m nemar_tpu_torch.test --dataroot ./datasets/xyz --name run1 --model nemar --gpu_ids 0

Any of the four models (``--model nemar|pix2pix|cycle_gan|test``). Loads
the per-net checkpoints of the model's nets (``{epoch}_net_{G,D,R}.pth``
for NeMAR, ``_net_G`` for pix2pix, ``_net_G_A`` and ``_net_G_B`` for
cycle_gan, ``_net_G{--model_suffix}`` for test) from
``{checkpoints_dir}/{name}/``, runs the forward pass over the dataset
(batch 1, ordered, no flip — forced by TestOptions) and writes an HTML
gallery of visuals to ``{results_dir}/{name}/{phase}_{epoch}/index.html``.
With ``--eval_registration`` it also writes the registration metrics
(NCC / PSNR / L1 of reg_fakeB against real_B; flow EPE in pixels where the
dataset has ground truth) to ``eval.json``, for a model that registers
(one whose visuals hold ``reg_fakeB``; for the others it writes an empty
summary, as the JAX package's ``test.py``). With ``--use_ema`` the forward
runs through the EMA shadows of G and R that a ``--ema_decay`` training run
saved beside the nets (``{epoch}_net_{G,R}_ema.pth``). ``--gpu_ids -1`` runs
on the CPU. Under several ids (``--gpu_ids 0,1``) it serves on the first,
in one process: the JAX package's mesh replicates test.py's batch of 1,
which no data axis of two or more divides (``nemar_tpu/parallel/mesh.py:
shard_batch``), so every device computes the same outputs as one.
"""

import contextlib
import json
import os

import numpy as np
import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.utils import html as html_mod
from nemar_tpu_torch.utils import metrics as M
from nemar_tpu_torch.utils.visualizer import save_images
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TestOptions


def new_metrics() -> dict:
    return {"ncc": [], "psnr": [], "l1": [], "epe_px": []}


def accumulate_metrics(acc: dict, visuals: dict, flow, theta_gt=None) -> None:
    """Append one batch's registration metrics: NCC / PSNR / L1 of
    reg_fakeB against real_B, and the flow's end-point error in pixels
    where the ground-truth misalignment ``theta_gt`` is known."""
    reg, real = visuals["reg_fakeB"], visuals["real_B"]
    acc["ncc"].append(M.ncc(reg, real))
    acc["psnr"].append(M.psnr(reg, real))
    acc["l1"].append(M.l1(reg, real))
    if flow is not None and theta_gt is not None:
        h, w = reg.shape[1:3]
        for j in range(reg.shape[0]):
            gt = M.registration_gt_flow(np.asarray(theta_gt[j]), h, w)
            acc["epe_px"].append(M.epe_px(flow[j], gt, h, w))


def summarize(acc: dict) -> dict:
    return {k: round(float(np.mean(v)), 4) for k, v in acc.items() if v}


def main(args=None) -> dict:
    """Run the test loop; returns the registration summary (empty without
    ``--eval_registration``)."""
    opt = TestOptions().parse(args)
    s = opt.mesh_spatial
    if s > 1:
        devs = parallel.devices(opt) if opt.gpu_ids else [torch.device("cpu")] * s
        if len(devs) < s:
            raise ValueError(f"spatial={s} must divide device count {len(devs)}")
        return parallel.launch(_test_rank, devs[:s], args=(opt,))[0]
    return _test(opt)


def _test_rank(opt) -> dict:
    """One rank of a --mesh_spatial test run: its band; rank 0 prints and
    writes."""
    parallel.set_mesh(opt.mesh_spatial)
    with contextlib.ExitStack() as stack:
        if parallel.rank() != 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        return _test(opt)


def _test(opt) -> dict:
    lead = parallel.rank() == 0
    dataset = create_dataset(opt)
    model = create_model(opt)
    model.setup(opt)
    if opt.eval:
        model.eval()

    web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.epoch}")
    if opt.load_iter > 0:
        web_dir = f"{web_dir}_iter{opt.load_iter}"
    print(f"creating web directory {web_dir}")
    webpage = html_mod.HTML(
        web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, Epoch = {opt.epoch}")

    evaluating = getattr(opt, "eval_registration", False)
    metrics_acc = new_metrics()
    for i, data in enumerate(dataset):
        if i >= opt.num_test:
            break
        model.set_input(data)
        model.test()
        visuals = model.get_current_visuals()
        img_path = model.get_image_paths()
        if i % 5 == 0:
            print(f"processing ({i:04d})-th image... {img_path}")
        if lead:
            save_images(webpage, visuals, img_path, aspect_ratio=opt.aspect_ratio,
                        width=opt.display_winsize)
        if evaluating and "reg_fakeB" in visuals:  # a registration model
            accumulate_metrics(metrics_acc, visuals, getattr(model, "last_flow", None),
                               data.get("theta_gt"))
    if lead:
        webpage.save()

    summary = {}
    if evaluating:
        summary = summarize(metrics_acc)
        print(f"registration eval: {summary}")
        if lead:
            with open(os.path.join(web_dir, "eval.json"), "w") as f:
                json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
