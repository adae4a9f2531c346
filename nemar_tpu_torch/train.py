"""Training entry point (reference ``train.py``), PyTorch.

    python -m nemar_tpu_torch.train --dataroot ./datasets/xyz --name run1 --model nemar --gpu_ids 0
    python -m nemar_tpu_torch.train --dataset_mode synthetic --gpu_ids -1 ...   # on the CPU

The JAX package's loop: options -> data (``nemar_tpu_torch.data``, numpy) ->
model -> epochs from --epoch_count to --n_epochs + --n_epochs_decay, with
the display / print / save frequencies, and the lr stepped at each epoch's
end. Each step is the model's ``optimize_parameters``; under
--steps_per_execution k > 1 (the nemar model only) the loop gathers k
batches and runs them as one chunk (``optimize_parameters_scan``: on the
card one CUDA graph of the step, replayed k times), fires a periodic action
when the chunk crosses its multiple, with the chunk's mean losses, and
runs a tail shorter than k at the epoch's end, as the JAX package's loop.
Losses are pulled to the host only at --print_freq boundaries. Under
--async_checkpoint the last save is joined (and its
``checkpoint_meta.json`` published) before ``main`` returns. ``--model`` is any of
``nemar``, ``pix2pix`` and ``cycle_gan``; a model's losses are its
``loss_names``, its visuals its ``visual_names``. Checkpoints are the
per-net files ``{epoch}_net_{Name}.pth`` (``G``, ``D``, ``R`` for NeMAR;
``G_A``, ``G_B``, ``D_A``, ``D_B`` for cycle_gan; and ``latest_...``) under
``{checkpoints_dir}/{name}/``, which ``nemar_tpu_torch.test`` loads.
With --profile_dir, a ``torch.profiler`` trace of the epoch loop (host
ops, and the card's kernels on CUDA) is written there as a Chrome trace
(``*.pt.trace.json``), where the JAX package writes its ``jax.profiler``
trace.

Several devices (``--gpu_ids 0,1,...``, cut to ``--num_devices``; on the
CPU ``--gpu_ids -1 --num_devices N``) train data-parallel, as the JAX
package's mesh: ``main`` launches one rank per device
(``nemar_tpu_torch.parallel.launch``: NCCL on the cards, gloo on the CPU),
each runs this loop on the same global batch stream and keeps its rows,
and --batch_size stays the global batch. Rank 0 alone prints, displays,
profiles and writes checkpoints; every rank takes part in the
collectives of the display's forward and of the printed losses, the
global batch's means. ``main`` then returns each rank's
``state_digest``: equal digests, bit-identical parameters and optimizer
states.
    python -m nemar_tpu_torch.train --gpu_ids 0,1,2,3 --batch_size 32 ...
    python -m nemar_tpu_torch.train --gpu_ids -1 --num_devices 2 ...   # 2 CPU ranks
"""

import contextlib
import os
import time

import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.models.base_model import state_digest
from nemar_tpu_torch.utils.visualizer import Visualizer
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions


def main(args=None):
    """Train; -> the model, or over several devices each rank's
    ``state_digest`` (printed too)."""
    opt = TrainOptions().parse(args)
    devs = parallel.devices(opt)
    if len(devs) == 1:
        return _train(opt)
    digests = parallel.launch(_train_rank, devs, args=(opt,))
    print(f"the ranks' state digests: {digests}")
    return digests


def _train_rank(opt, dtype: torch.dtype | None = None):
    """One rank of a data-parallel run: the loop, with this rank's rows;
    only rank 0 prints. -> its ``state_digest``."""
    with contextlib.ExitStack() as stack:
        if parallel.rank() != 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        return state_digest(_train(opt, dtype))


def _train(opt, dtype: torch.dtype | None = None):
    """The loop; ``dtype`` runs the model in it (torch.float64 for the CPU
    tests against the JAX package; default fp32)."""
    lead = parallel.rank() == 0
    dataset = create_dataset(opt)
    dataset_size = len(dataset)
    print(f"The number of training images = {dataset_size}")
    model = create_model(opt)
    if dtype is not None:
        model.to_dtype(dtype)
    model.setup(opt)
    visualizer = Visualizer(opt) if lead else None
    with _profiler(opt.profile_dir if lead else "", model.device):
        _train_epochs(opt, dataset, dataset_size, model, visualizer)
    model._flush_pending_meta()
    return model


def _profiler(profile_dir: str, device: torch.device):
    """A torch.profiler trace written to ``profile_dir`` when it exits, or
    nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))


def _train_epochs(opt, dataset, dataset_size, model, visualizer):
    total_iters = 0
    spe = max(1, getattr(opt, "steps_per_execution", 1))
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
        model.set_epoch(epoch)
        epoch_start_time = time.time()
        iter_data_time = time.time()
        epoch_iter = 0
        if visualizer is not None:
            visualizer.reset()
        pending = []
        for data in dataset:
            iter_start_time = time.time()
            t_data = iter_start_time - iter_data_time
            total_iters += opt.batch_size
            epoch_iter += opt.batch_size
            if spe > 1:
                pending.append(data)
                if len(pending) < spe:
                    iter_data_time = time.time()
                    continue
                model.optimize_parameters_scan(pending)
                pending = []
            else:
                model.set_input(data)
                model.optimize_parameters()

            # freq <= 0 disables the periodic action; a chunk fires it when
            # it crosses the multiple
            window = opt.batch_size * spe
            # (visualizer: rank 0's; every rank runs the forward and the
            # losses' mean, which may hold collectives)
            if opt.display_freq > 0 and total_iters % opt.display_freq < window:
                model.test()
                if visualizer is not None:
                    visualizer.display_current_results(model.get_current_visuals(), epoch, True)
            if opt.print_freq > 0 and total_iters % opt.print_freq < window:
                losses = model.get_current_losses()  # device sync point
                t_comp = (time.time() - iter_start_time) / opt.batch_size
                if visualizer is not None:
                    visualizer.print_current_losses(epoch, epoch_iter, losses, t_comp, t_data)
                    visualizer.plot_current_losses(
                        epoch, float(epoch_iter) / max(dataset_size, 1), losses)
            if opt.save_latest_freq > 0 and total_iters % opt.save_latest_freq < window:
                print(f"saving the latest model (epoch {epoch}, total_iters {total_iters})")
                model.save_networks(f"iter_{total_iters}" if opt.save_by_iter else "latest")
            iter_data_time = time.time()

        if pending:
            # the tail, when spe does not divide the epoch's batches (the same
            # graph, fewer replays)
            model.optimize_parameters_scan(pending)
            pending = []
        if opt.save_epoch_freq > 0 and epoch % opt.save_epoch_freq == 0:
            print(f"saving the model at the end of epoch {epoch}, iters {total_iters}")
            model.save_networks("latest")
            model.save_networks(epoch)
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay}"
              f" \t Time Taken: {time.time() - epoch_start_time:.0f} sec")
        model.update_learning_rate(epoch)


if __name__ == "__main__":
    main()
