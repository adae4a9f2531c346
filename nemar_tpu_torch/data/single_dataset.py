"""Single-domain inference dataset (reference data/single_dataset.py)."""

from __future__ import annotations

from PIL import Image

from nemar_tpu_torch.data.base_dataset import BaseDataset, get_params, get_transform
from nemar_tpu_torch.data.image_folder import make_dataset


class SingleDataset(BaseDataset):
    def __init__(self, opt):
        super().__init__(opt)
        self.A_paths = make_dataset(opt.dataroot, opt.max_dataset_size)
        self.input_nc = opt.output_nc if opt.direction == "BtoA" else opt.input_nc

    def __len__(self):
        return len(self.A_paths)

    def __getitem__(self, index):
        A_path = self.A_paths[index]
        A_img = Image.open(A_path).convert("RGB")
        params = get_params(self.opt, A_img.size, self.item_rng(index))
        a = get_transform(self.opt, params, grayscale=(self.input_nc == 1))(A_img)
        return {"A": a, "A_paths": A_path}
