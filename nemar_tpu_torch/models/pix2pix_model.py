"""pix2pix: the paired conditional GAN of the template (reference lineage,
``nemar_tpu/models/pix2pix_model.py``).

  G(A) -> B on paired data; D judges A and B stacked on channels.
  L_D = ½(GAN(D(A, B), 1) + GAN(D(A, G(A)), 0))
  L_G = GAN(D(A, G(A)), 1) + λ_L1 · ‖G(A) − B‖₁

Template defaults: ``unet_256``, batch norm, vanilla GAN, the aligned
dataset, no pool, ``--lambda_L1 100``. The step is the JAX package's
``_train_step_impl``: G runs forward once, with the graph kept; D steps on
the detached fake (Adam); G's loss then reads the UPDATED D, with D's
parameters frozen, and is backpropagated through the kept graph (Adam).
One dropout draw therefore serves D's fake and G's backward. D sees real
and fake in one pass where its norm is per sample, in two under batch
norm (``networks.d_preds``). Dropout draws from the model's generator on
its device, reseeded before each step from --seed and the step count
(``base_model.dropout_seed``), so a resumed run draws the masks of an
uninterrupted one on either device type. The visuals' forward has dropout off (the
JAX package's ``train=False``); batch norm keeps its batch statistics.

The model computes in fp32 whatever --bf16 says, as the JAX package's,
whose step never casts. In a data-parallel run each rank takes its rows
of the global batch, batch norm and dropout act on the global batch
(``models/networks.py``), and D's and G's gradients are averaged over the
ranks before each Adam step.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import networks
from nemar_tpu_torch.models.base_model import BaseModel, dropout_seed, to_device_nchw


class Pix2PixModel(BaseModel):
    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        parser.set_defaults(norm="batch", netG="unet_256", dataset_mode="aligned")
        if is_train:
            parser.set_defaults(pool_size=0, gan_mode="vanilla")
            parser.add_argument("--lambda_L1", type=float, default=100.0,
                                help="weight for L1 loss")
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.loss_names = ["G_GAN", "G_L1", "D_real", "D_fake"]
        self.visual_names = ["real_A", "fake_B", "real_B"]
        self.model_names = ["G", "D"] if self.isTrain else ["G"]
        seed = getattr(opt, "seed", 0)
        # dropout's draws, on the device (the JAX state's key is seed + 23),
        # reseeded before each step from the seed and the step count
        self.drop_seed = seed + 23
        self.drop_gen = torch.Generator(self.device).manual_seed(self.drop_seed)
        gen = torch.Generator().manual_seed(seed)
        self.netG = networks.define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.netG, opt.norm,
                                      not opt.no_dropout, getattr(opt, "remat", False),
                                      self.drop_gen)
        networks.init_weights(self.netG, opt.init_gain, gen, opt.init_type)
        if self.isTrain:
            # conditional D: A and B stacked on channels
            self.netD = networks.define_D(opt.input_nc + opt.output_nc, opt.ndf, opt.netD,
                                          opt.n_layers_D, opt.norm)
            networks.init_weights(self.netD, opt.init_gain, gen, opt.init_type)
        self.gan_mode = getattr(opt, "gan_mode", "vanilla")
        self.lambda_L1 = getattr(opt, "lambda_L1", 100.0)
        for net in self.nets().values():
            net.to(self.device, memory_format=torch.channels_last)
            net.train(self.isTrain)

    def make_optimizers(self) -> dict:
        return {"G": self.adam(self.netG.parameters(), self.opt.beta1),
                "D": self.adam(self.netD.parameters(), self.opt.beta1)}

    def optimize_parameters(self):
        """One step: the JAX package's ``_train_step_impl``."""
        a, b = self.real_A, self.real_B
        self.drop_gen.manual_seed(dropout_seed(self.drop_seed, self.step))
        fake_B = self.netG(a)  # one forward, kept for G's backward

        opt_D = self.optimizers["D"]
        opt_D.zero_grad(set_to_none=True)
        pred_real, pred_fake = networks.d_preds(self.netD, torch.cat([a, b], dim=1),
                                                torch.cat([a, fake_B.detach()], dim=1),
                                                self.opt.norm)
        l_dr = networks.gan_loss(pred_real, True, self.gan_mode)
        l_df = networks.gan_loss(pred_fake, False, self.gan_mode)
        (0.5 * (l_df + l_dr)).backward()
        parallel.all_reduce_grads(self.netD.parameters())
        opt_D.step()

        opt_G = self.optimizers["G"]
        opt_G.zero_grad(set_to_none=True)
        self.netD.requires_grad_(False)
        try:
            pred = self.netD(torch.cat([a, fake_B], dim=1))
        finally:
            self.netD.requires_grad_(True)
        l_gan = networks.gan_loss(pred, True, self.gan_mode)
        l_l1 = torch.mean(torch.abs(fake_B - b)) * self.lambda_L1
        (l_gan + l_l1).backward()
        parallel.all_reduce_grads(self.netG.parameters())
        opt_G.step()
        self._losses = {k: v.detach() for k, v in (
            ("G_GAN", l_gan), ("G_L1", l_l1), ("D_real", l_dr), ("D_fake", l_df))}
        self.step += 1

    def set_input(self, data: dict):
        """data['A'], data['B']: NHWC float numpy batches, the global batch;
        in a data-parallel run this rank keeps its rows (and the dropout
        layers draw for the global batch)."""
        n = len(data["A"])
        data = parallel.shard_rows(data)
        if parallel.world() > 1:
            networks.set_dropout_rows(self.netG, (n, parallel.rows_in(n)))
        self.real_A = to_device_nchw(data["A"], self.device, self.dtype)
        self.real_B = to_device_nchw(data["B"], self.device, self.dtype)
        self.image_paths = data.get("A_paths", [])

    def forward(self):
        with networks.eval_mode(self.netG):
            fake_B = self.netG(self.real_A)
        self._visuals = {"real_A": self.real_A, "fake_B": fake_B, "real_B": self.real_B}
