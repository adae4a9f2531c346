"""Unaligned two-domain dataset (reference data/unaligned_dataset.py).

{dataroot}/{phase}A and {dataroot}/{phase}B; B index randomized unless
--serial_batches.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from nemar_tpu_torch.data.base_dataset import BaseDataset, get_params, get_transform
from nemar_tpu_torch.data.image_folder import make_dataset


class UnalignedDataset(BaseDataset):
    def __init__(self, opt):
        super().__init__(opt)
        self.dir_A = os.path.join(opt.dataroot, opt.phase + "A")
        self.dir_B = os.path.join(opt.dataroot, opt.phase + "B")
        self.A_paths = make_dataset(self.dir_A, opt.max_dataset_size)
        self.B_paths = make_dataset(self.dir_B, opt.max_dataset_size)
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        btoA = opt.direction == "BtoA"
        self.input_nc = opt.output_nc if btoA else opt.input_nc
        self.output_nc = opt.input_nc if btoA else opt.output_nc

    def __len__(self):
        return max(self.A_size, self.B_size)

    def __getitem__(self, index):
        rng = self.item_rng(index)
        A_path = self.A_paths[index % self.A_size]
        if self.opt.serial_batches:
            index_B = index % self.B_size
        else:
            index_B = int(rng.integers(0, self.B_size))
        B_path = self.B_paths[index_B]
        A_img = Image.open(A_path).convert("RGB")
        B_img = Image.open(B_path).convert("RGB")
        # Independent draws per domain (unaligned pairs share no geometry).
        pA = get_params(self.opt, A_img.size, rng)
        pB = get_params(self.opt, B_img.size, rng)
        a = get_transform(self.opt, pA, grayscale=(self.input_nc == 1))(A_img)
        b = get_transform(self.opt, pB, grayscale=(self.output_nc == 1))(B_img)
        return {"A": a, "B": b, "A_paths": A_path, "B_paths": B_path}
