"""NeMAR model, inference (reference ``models/nemar_model.py``).

Three networks, as in the JAX package:
  T (netG)  ResNet generator translating modality A to B's appearance,
  R (netR)  UNet STN predicting the field φ that aligns A to B,
  D (netD)  70x70 PatchGAN (built and checkpointed; not run at test time).

The forward is the reference's ``_forward_parts``: φ is predicted once and
applied in both orders, warp(T(a), φ) (``reg_fakeB``) and T(warp(a, φ))
(``fake_B2``). ``forward`` exposes the same visuals and ``last_flow`` as the
JAX model, as NHWC numpy arrays.

On the card the path runs through the three hand-written kernels: K-block
for the 6 trunk blocks of each G pass, K-in for every instance norm outside
the trunk, K-warp for the one grid sample of (fake_B, real_A).

The training step (``optimize_parameters``: D loss, G+R loss, Adam) is
queued as ROADMAP.md A5.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.models import networks
from nemar_tpu_torch.models.base_model import BaseModel, to_device_nchw
from nemar_tpu_torch.models.stn import define_stn
from nemar_tpu_torch.ops.warp import grid_sample


class NEMARModel(BaseModel):
    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        """Reference flag surface: --stn_type and the λ weights."""
        parser.set_defaults(netG="resnet_6blocks", no_dropout=True, pool_size=0,
                            input_nc=1, output_nc=3)
        parser.add_argument("--stn_type", type=str, default="unet",
                            help="spatial transformer type [affine | unet]")
        parser.add_argument("--stn_ngf", type=int, default=32,
                            help="# filters in the STN's first conv layer")
        parser.add_argument("--stn_depth", type=int, default=5,
                            help="down/up levels in the UNet STN")
        parser.add_argument("--stn_flow_scale", type=float, default=1.0,
                            help="multiplier on the predicted flow field")
        parser.add_argument("--stn_affine_head", type=str, default="flatten",
                            choices=["flatten", "gap"],
                            help="affine STN head: FC over the spatial "
                                 "feature map (reference layout; preserves "
                                 "the phase a translation estimate needs) "
                                 "vs global-average-pool (round-2 arch — "
                                 "near-blind to translation without border "
                                 "cues)")
        parser.add_argument("--stn_smooth_type", type=str, default="l1",
                            help="first-difference penalty type [l1 | l2]")
        parser.add_argument("--stn_smooth_order", type=int, default=1,
                            choices=(1, 2),
                            help="TV difference order; 2 penalizes curvature "
                                 "only — zero for affine fields, so it does "
                                 "not fight field magnitude (round-3 256² "
                                 "science: order-1 TV under-scales affine "
                                 "flow to ~40%% at cos 0.998)")
        parser.add_argument("--stn_head_impl", type=str, default="xla",
                            choices=("xla", "fact"),
                            help="UNet-STN flow heads: 'fact' = exact "
                                 "(3x1)∘(1x3) factorization — the 2-channel "
                                 "heads use 2 of 128 MXU output lanes under "
                                 "the direct lowering (ops/conv_fact.py)")
        parser.add_argument("--stn_up_impl", type=str, default="xla",
                            choices=("xla", "fused", "fused_small"),
                            help="UNet-STN decoder upsample+conv: 'fused' = "
                                 "exact conv-then-depth-to-space rewrite "
                                 "(2.25x fewer MACs — ops/up_conv.py), but "
                                 "measured a wash in-step (probe r3m: XLA "
                                 "already fuses the broadcast upsample into "
                                 "the conv); 'xla' = direct lowering "
                                 "(default)")
        parser.add_argument("--stn_padding_mode", type=str, default="zeros",
                            help="grid_sample padding [zeros | border | reflection]")
        parser.add_argument("--stn_bounded_flow", type=float, default=0.0,
                            help=">0: tanh-bound flow (normalized units); "
                                 "enables the exact Pallas halo warp kernel")
        parser.add_argument("--stn_field_source", type=str, default="pair",
                            help="predict phi from [pair | fake] "
                                 "(real_A,real_B) vs (fake_B,real_B); SURVEY §8.4(b)")
        parser.add_argument("--stn_align_corners", action="store_true",
                            help="align_corners=True warp semantics (SURVEY §8.4(a))")
        parser.add_argument("--stn_level_scale", type=float, default=1.0,
                            help="damping multiplier on each multiscale "
                                 "head's residual field (0.25 keeps early "
                                 "fields sub-pixel)")
        parser.add_argument("--stn_head_min_res", type=int, default=0,
                            help="skip multiscale flow heads below this "
                                 "feature resolution: ultra-coarse heads "
                                 "(4²/8² at 256², stn_depth 6) random-walk "
                                 "under Adam with weak photometric "
                                 "anchoring and diverge even in a direct "
                                 "fit (science_256_direct)")
        parser.add_argument("--g_batch", action="store_true",
                            help="STN-first forward with ONE batched G pass "
                                 "at 2N (identical math; measured ~10% "
                                 "slower on TPU because the second warp "
                                 "re-pays tap construction — kept for "
                                 "future kernels/hardware)")
        parser.add_argument("--stn_multiscale", action="store_true",
                            help="coarse-to-fine flow heads at every decoder "
                                 "level (helps pure-registration convergence; "
                                 "needs a tame --stn_lr in the adversarial "
                                 "setting — see ROADMAP.md)")
        if is_train:
            parser.add_argument("--lambda_GAN", type=float, default=1.0,
                                help="weight of the adversarial term")
            parser.add_argument("--lambda_recon", type=float, default=100.0,
                                help="weight of the bidirectional L1 reconstruction")
            parser.add_argument("--lambda_smooth", type=float, default=10.0,
                                help="weight of the smoothness/identity regularizer")
            parser.add_argument("--stn_lr", type=float, default=None,
                                help="separate lr for the STN (default: --lr)")
            parser.add_argument("--stn_beta1", type=float, default=None,
                                help="separate Adam beta1 for the STN "
                                     "(default: --beta1; flow regression "
                                     "prefers the standard 0.9)")
            parser.add_argument("--stn_ramp_epochs", type=int, default=0,
                                help="linearly ramp R's effective lr from 0 "
                                     "over this many epochs after the "
                                     "warm-up (tames Adam's scale-free "
                                     "first steps on the zero-init heads)")
            parser.add_argument("--stn_grad_clip", type=float, default=0.0,
                                help=">0: clip R's gradient global norm")
            parser.add_argument("--stn_warmup_epochs", type=int, default=0,
                                help="epochs with R FROZEN while G learns the "
                                     "appearance mapping: until G(a) looks "
                                     "like modality B, the photometric flow "
                                     "gradient is noise and Adam blows the "
                                     "zero-init heads up (round-2 science)")
            parser.add_argument("--gan_warmup_epochs", type=int, default=0,
                                help="epochs of pure recon+smooth before GAN "
                                     "gradients reach G (R warm-up; prevents "
                                     "the generator absorbing the geometry "
                                     "early — ROADMAP round-2)")
            parser.add_argument("--gan_ramp_epochs", type=int, default=0,
                                help="epochs to linearly ramp lambda_GAN "
                                     "back in after the warm-up")
            parser.add_argument("--border_mask", action="store_true",
                                help="mask the recon L1 by the warp validity "
                                     "region (out-of-view borders give false "
                                     "photometric gradients)")
            parser.add_argument("--recon_pyramid", type=int, default=0,
                                help=">0: add K avg-pooled octaves to the "
                                     "recon L1 (coarse octaves give the flow "
                                     "a wide photometric basin — px-scale "
                                     "L1 alone is blind past ~1 px)")
            parser.add_argument("--freeze_g", action="store_true",
                                help="freeze G and D; only R trains "
                                     "(registration refinement phase — "
                                     "pair with --continue_train after a "
                                     "joint run, or use to probe R against "
                                     "a fixed translator)")
            parser.add_argument("--grad_accum", type=int, default=1,
                                help="microbatches per optimizer step; "
                                     "activation memory scales 1/N with "
                                     "IDENTICAL math (per-sample instance "
                                     "norm + mean losses) — fits 512^2 "
                                     "batch 32 on one chip")
            parser.add_argument("--ema_decay", type=float, default=0.0,
                                help=">0: keep EMA shadows of G and R "
                                     "(e.g. 0.999); evaluate with --use_ema")
        else:
            parser.add_argument("--use_ema", action="store_true",
                                help="load the EMA shadows of G and R")
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.model_names = ["G", "D", "R"]
        _check_supported(opt)
        self.field_source = getattr(opt, "stn_field_source", "pair")
        self.g_batch = getattr(opt, "g_batch", False)

        gen = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        self.netG = networks.define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.netG,
                                      opt.norm, not opt.no_dropout)
        self.netD = networks.define_D(opt.output_nc, opt.ndf, opt.netD, opt.n_layers_D, opt.norm)
        networks.init_weights(self.netG, opt.init_gain, gen)
        networks.init_weights(self.netD, opt.init_gain, gen)
        self.netR = define_stn(opt, opt.stn_type)
        # R's convs draw from the reference's normal(0.02); its flow head
        # stays zero so a fresh R warps by the identity
        networks.init_weights(self.netR, 0.02, gen)
        head = self.netR.head()
        torch.nn.init.zeros_(head.weight)
        torch.nn.init.zeros_(head.bias)
        for name, net in self.nets().items():
            net.to(self.device, memory_format=torch.channels_last)
            net.eval()

    def _forward_parts(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        """Both warp orders from one φ; NCHW tensors in and out."""
        netG, netR = self.netG, self.netR
        if self.field_source == "pair" and self.g_batch:
            # φ depends only on (a, b): R first, then ONE G pass at 2N over
            # [a; warp(a, φ)], then the warp of fake_B with the same grid
            (warped_A,), _, aux = netR(a, b, (a,), n_grad_imgs=0)
            both = netG(torch.cat([a, warped_A], dim=0))
            fake_B, fake_B2 = torch.split(both, a.shape[0], dim=0)
            reg_fakeB = networks.to_nchw(grid_sample(
                networks.to_nhwc(fake_B), aux["grid"], "bilinear",
                netR.padding_mode, netR.align_corners))
        else:
            fake_B = netG(a)
            src = (a, b) if self.field_source == "pair" else (fake_B, b)
            (reg_fakeB, warped_A), _, aux = netR(src[0], src[1], (fake_B, a), n_grad_imgs=1)
            fake_B2 = netG(warped_A)
        return {"fake_B": fake_B, "reg_fakeB": reg_fakeB, "warped_A": warped_A,
                "fake_B2": fake_B2, "flow": aux["flow"]}

    # ------------------------------------------------------------------
    # reference-API host methods
    # ------------------------------------------------------------------
    def set_input(self, data: dict):
        """data['A'], data['B']: NHWC float numpy batches."""
        self.real_A = to_device_nchw(data["A"], self.device)
        self.real_B = to_device_nchw(data["B"], self.device)
        self.image_paths = data.get("A_paths", [])

    def forward(self):
        out = self._forward_parts(self.real_A, self.real_B)
        # (N, H, W, 2) normalised field, NHWC numpy as the JAX model's
        self.last_flow = out["flow"].detach().cpu().numpy()
        self._visuals = {
            "real_A": self.real_A, "real_B": self.real_B,
            "fake_B": out["fake_B"], "reg_fakeB": out["reg_fakeB"],
            "warped_A": out["warped_A"], "fake_B2": out["fake_B2"],
        }
        return out

    def optimize_parameters(self):
        raise NotImplementedError(
            "the NeMAR training step is not ported yet (queued as ROADMAP.md A5)")


def _check_supported(opt) -> None:
    """Refuse the flags whose code paths are not ported yet, by name."""
    queued = [
        (getattr(opt, "bf16", False), "--bf16", "A7"),
        (getattr(opt, "init_type", "normal") != "normal", f"--init_type {opt.init_type}", "A5"),
        (getattr(opt, "use_ema", False), "--use_ema (EMA shadows come with training)", "A5"),
        (getattr(opt, "mesh_spatial", 1) > 1, "--mesh_spatial > 1", "A10"),
        (getattr(opt, "c7_impl", "xla") == "roll",
         "--c7_impl roll (kernel B4 of the TPU package)", "queue B"),
        (getattr(opt, "block_impl", "xla") == "pallas_all",
         "--block_impl pallas_all (kernels B5/B6 of the TPU package)", "queue B"),
    ]
    for on, flag, item in queued:
        if on:
            raise NotImplementedError(f"{flag} is not ported yet (queued as ROADMAP.md {item})")
