"""Inference with one saved generator (template lineage ``test`` model,
``nemar_tpu/models/test_model.py``), on one-domain data:

    python -m nemar_tpu_torch.test --dataroot path/to/A --model test --no_dropout --gpu_ids 0

``--model_suffix`` picks the checkpoint: its G loads
``{epoch}_net_G{suffix}.pth``, so a cycle_gan run's G_A serves as
``--model_suffix _A``. The forward has dropout off (the JAX package's
``train=False``). Visuals: ``real`` and ``fake``. It has no training step,
and a training parse refuses it. It computes in fp32 whatever --bf16 says,
as the JAX package's.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.models import networks
from nemar_tpu_torch.models.base_model import BaseModel, to_device_nchw


class TestModel(BaseModel):
    @staticmethod
    def modify_commandline_options(parser, is_train=False):
        assert not is_train, "TestModel is inference-only; use it with test.py"
        parser.set_defaults(dataset_mode="single")
        parser.add_argument("--model_suffix", type=str, default="",
                            help="load checkpoints saved as net G{suffix}")
        return parser

    def __init__(self, opt):
        assert not opt.isTrain
        super().__init__(opt)
        self.loss_names = []
        self.visual_names = ["real", "fake"]
        self.model_names = ["G" + getattr(opt, "model_suffix", "")]
        self.netG = networks.define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.netG, opt.norm,
                                      not opt.no_dropout)
        networks.init_weights(self.netG, opt.init_gain,
                              torch.Generator().manual_seed(getattr(opt, "seed", 0)),
                              opt.init_type)
        self.netG.to(self.device, memory_format=torch.channels_last).eval()
        # the checkpoint's name for netG (nets() reads net<Name>)
        setattr(self, f"net{self.model_names[0]}", self.netG)

    def set_input(self, data: dict):
        """data['A']: an NHWC float numpy batch."""
        self.real = to_device_nchw(data["A"], self.device)
        self.image_paths = data.get("A_paths", [])

    def forward(self):
        with networks.eval_mode(self.netG):
            self.fake = self.netG(self.real)
        self._visuals = {"real": self.real, "fake": self.fake}

    def optimize_parameters(self):
        raise RuntimeError("TestModel has no training step")
