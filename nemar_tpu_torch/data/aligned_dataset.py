"""Aligned AB-image dataset (reference data/aligned_dataset.py).

Loads a single image from {dataroot}/{phase} containing A|B side by side,
splits the halves, applies the SAME random crop/flip to both.
"""

from __future__ import annotations

import os

from PIL import Image

from nemar_tpu_torch.data.base_dataset import BaseDataset, get_params, get_transform
from nemar_tpu_torch.data.image_folder import make_dataset


class AlignedDataset(BaseDataset):
    def __init__(self, opt):
        super().__init__(opt)
        self.dir_AB = os.path.join(opt.dataroot, opt.phase)
        self.AB_paths = make_dataset(self.dir_AB, opt.max_dataset_size)
        assert opt.load_size >= opt.crop_size, "crop_size should be smaller than load_size"
        self.input_nc = opt.output_nc if opt.direction == "BtoA" else opt.input_nc
        self.output_nc = opt.input_nc if opt.direction == "BtoA" else opt.output_nc

    def __len__(self):
        return len(self.AB_paths)

    def __getitem__(self, index):
        AB_path = self.AB_paths[index]
        AB = Image.open(AB_path).convert("RGB")
        w, h = AB.size
        w2 = w // 2
        A = AB.crop((0, 0, w2, h))
        B = AB.crop((w2, 0, w, h))
        params = get_params(self.opt, A.size, self.item_rng(index))
        A_t = get_transform(self.opt, params, grayscale=(self.input_nc == 1))
        B_t = get_transform(self.opt, params, grayscale=(self.output_nc == 1))
        a, b = A_t(A), B_t(B)
        if self.opt.direction == "BtoA":
            a, b = b, a
        return {"A": a, "B": b, "A_paths": AB_path, "B_paths": AB_path}
