"""Training entry point (reference ``train.py``), PyTorch.

    python -m nemar_tpu_torch.train --dataroot ./datasets/xyz --name run1 --model nemar --gpu_ids 0
    python -m nemar_tpu_torch.train --dataset_mode synthetic --gpu_ids -1 ...   # on the CPU

The JAX package's loop: options -> data (``nemar_tpu_torch.data``, numpy) ->
model -> epochs from --epoch_count to --n_epochs + --n_epochs_decay, with
the display / print / save frequencies, and the lr stepped at each epoch's
end. Each step is the model's ``optimize_parameters``; losses are pulled to
the host only at --print_freq boundaries. Checkpoints are the per-net files
``{epoch}_net_{G,D,R}.pth`` (and ``latest_...``) under
``{checkpoints_dir}/{name}/``, which ``nemar_tpu_torch.test`` loads.
With --profile_dir, a ``torch.profiler`` trace of the epoch loop (host
ops, and the card's kernels on CUDA) is written there as a Chrome trace
(``*.pt.trace.json``), where the JAX package writes its ``jax.profiler``
trace.
"""

import contextlib
import time

import torch

from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.utils.visualizer import Visualizer
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions


def main(args=None):
    opt = TrainOptions().parse(args)
    dataset = create_dataset(opt)
    dataset_size = len(dataset)
    print(f"The number of training images = {dataset_size}")
    model = create_model(opt)
    model.setup(opt)
    visualizer = Visualizer(opt)
    with _profiler(opt.profile_dir, model.device):
        _train_epochs(opt, dataset, dataset_size, model, visualizer)
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
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
        model.set_epoch(epoch)
        epoch_start_time = time.time()
        iter_data_time = time.time()
        epoch_iter = 0
        visualizer.reset()
        for data in dataset:
            iter_start_time = time.time()
            t_data = iter_start_time - iter_data_time
            total_iters += opt.batch_size
            epoch_iter += opt.batch_size
            model.set_input(data)
            model.optimize_parameters()

            # freq <= 0 disables the periodic action
            if opt.display_freq > 0 and total_iters % opt.display_freq < opt.batch_size:
                model.test()
                visualizer.display_current_results(model.get_current_visuals(), epoch, True)
            if opt.print_freq > 0 and total_iters % opt.print_freq < opt.batch_size:
                losses = model.get_current_losses()  # device sync point
                t_comp = (time.time() - iter_start_time) / opt.batch_size
                visualizer.print_current_losses(epoch, epoch_iter, losses, t_comp, t_data)
                visualizer.plot_current_losses(
                    epoch, float(epoch_iter) / max(dataset_size, 1), losses)
            if opt.save_latest_freq > 0 and total_iters % opt.save_latest_freq < opt.batch_size:
                print(f"saving the latest model (epoch {epoch}, total_iters {total_iters})")
                model.save_networks(f"iter_{total_iters}" if opt.save_by_iter else "latest")
            iter_data_time = time.time()

        if opt.save_epoch_freq > 0 and epoch % opt.save_epoch_freq == 0:
            print(f"saving the model at the end of epoch {epoch}, iters {total_iters}")
            model.save_networks("latest")
            model.save_networks(epoch)
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay}"
              f" \t Time Taken: {time.time() - epoch_start_time:.0f} sec")
        model.update_learning_rate(epoch)


if __name__ == "__main__":
    main()
