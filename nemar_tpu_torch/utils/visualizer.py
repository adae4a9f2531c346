"""Training/test visualization + logging (reference util/visualizer.py).

The reference streams to a visdom server and writes an HTML snapshot site +
loss_log.txt. TPU-native replacement keeps the SAME artifacts a user greps
(loss_log.txt format preserved, web/index.html gallery, saved image grids)
plus a structured metrics.jsonl for machines; visdom is dropped (no display
server in a pod job) — `--display_id` style flags are accepted upstream but
unused.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from nemar_tpu_torch.utils import html as html_mod
from nemar_tpu_torch.utils.util import mkdirs, save_image, tensor2im


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.saved = False
        self.use_html = opt.isTrain and not getattr(opt, "no_html", False)
        self.win_size = getattr(opt, "display_winsize", 256)
        if self.use_html:
            self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            print(f"create web directory {self.web_dir}...")
            mkdirs([self.web_dir, self.img_dir])
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        self.jsonl_name = os.path.join(opt.checkpoints_dir, opt.name, "metrics.jsonl")
        with open(self.log_name, "a") as log_file:
            now = time.strftime("%c")
            log_file.write(f"================ Training Loss ({now}) ================\n")

    def reset(self):
        self.saved = False

    def display_current_results(self, visuals, epoch, save_result):
        """Save image grids for this epoch (reference HTML snapshot path)."""
        if not self.use_html or (not save_result and self.saved):
            return
        self.saved = True
        for label, image in visuals.items():
            image_numpy = tensor2im(image)
            img_path = os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.png")
            save_image(image_numpy, img_path)
        # rebuild the gallery page, newest epoch first
        # The training page auto-refreshes in the browser (the TPU-pod
        # replacement for the reference's live visdom panels): open
        # checkpoints/<name>/web/index.html once and it tracks training.
        webpage = html_mod.HTML(self.web_dir, f"Experiment name = {self.name}", refresh=30)
        for n in range(epoch, 0, -1):
            webpage.add_header(f"epoch [{n}]")
            ims, txts, links = [], [], []
            for label in visuals:
                fname = f"epoch{n:03d}_{label}.png"
                if os.path.exists(os.path.join(self.img_dir, fname)):
                    ims.append(fname)
                    txts.append(label)
                    links.append(fname)
            if ims:
                webpage.add_images(ims, txts, links, width=self.win_size)
        webpage.save()

    def plot_current_losses(self, epoch, counter_ratio, losses):
        """visdom line plots replaced by the structured jsonl stream."""
        with open(self.jsonl_name, "a") as f:
            f.write(json.dumps(
                {"epoch": epoch, "progress": counter_ratio, **{k: float(v) for k, v in losses.items()}}
            ) + "\n")

    def print_current_losses(self, epoch, iters, losses, t_comp, t_data):
        """Reference loss_log.txt line format, preserved for UX parity."""
        message = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        for k, v in losses.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_name, "a") as log_file:
            log_file.write(f"{message}\n")


def save_images(webpage, visuals, image_path, aspect_ratio=1.0, width=256):
    """Save test visuals into the results gallery (reference save_images)."""
    image_dir = webpage.get_image_dir()
    short_path = os.path.basename(image_path[0] if isinstance(image_path, (list, tuple)) else image_path)
    name = os.path.splitext(short_path)[0].replace("/", "_").replace(":", "_")

    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im_data in visuals.items():
        im = tensor2im(im_data)
        image_name = f"{name}_{label}.png"
        save_image(im, os.path.join(image_dir, image_name), aspect_ratio=aspect_ratio)
        ims.append(image_name)
        txts.append(label)
        links.append(image_name)
    webpage.add_images(ims, txts, links, width=width)
