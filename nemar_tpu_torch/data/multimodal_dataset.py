"""Paired multimodal dataset (NeMAR-style IR<->RGB pairs — SURVEY.md §3.1).

The reference trained on a private ~600-pair IR/RGB set with a loader that
applies SHARED geometric augmentation to both modalities (so the synthetic
misalignment between them is preserved, not augmented away). Layout here:

    {dataroot}/{phase}A/xxx.png   modality A (e.g. IR)
    {dataroot}/{phase}B/xxx.png   modality B (e.g. RGB)

paired by sorted filename order; both receive the same crop/flip draw.
"""

from __future__ import annotations

import os

from PIL import Image

from nemar_tpu_torch.data.base_dataset import BaseDataset, get_params, get_transform
from nemar_tpu_torch.data.image_folder import make_dataset


class MultimodalDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.set_defaults(input_nc=1, output_nc=3)  # IR -> RGB
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.dir_A = os.path.join(opt.dataroot, opt.phase + "A")
        self.dir_B = os.path.join(opt.dataroot, opt.phase + "B")
        self.A_paths = make_dataset(self.dir_A, opt.max_dataset_size)
        self.B_paths = make_dataset(self.dir_B, opt.max_dataset_size)
        assert len(self.A_paths) == len(self.B_paths), (
            f"multimodal dataset needs matching pair counts: "
            f"{len(self.A_paths)} in {self.dir_A} vs {len(self.B_paths)} in {self.dir_B}"
        )
        btoA = opt.direction == "BtoA"
        self.input_nc = opt.output_nc if btoA else opt.input_nc
        self.output_nc = opt.input_nc if btoA else opt.output_nc

    def __len__(self):
        return len(self.A_paths)

    def __getitem__(self, index):
        A_path = self.A_paths[index]
        B_path = self.B_paths[index]
        A_img = Image.open(A_path)
        B_img = Image.open(B_path)
        # SHARED geometric params: the pair's relative misalignment is data.
        params = get_params(self.opt, A_img.size, self.item_rng(index))
        a = get_transform(self.opt, params, grayscale=(self.input_nc == 1))(A_img)
        b = get_transform(self.opt, params, grayscale=(self.output_nc == 1))(B_img)
        if self.opt.direction == "BtoA":
            a, b = b, a
        return {"A": a, "B": b, "A_paths": A_path, "B_paths": B_path}
