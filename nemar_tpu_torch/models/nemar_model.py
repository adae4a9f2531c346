"""NeMAR model, inference and the training step (reference ``models/nemar_model.py``).

Three networks, as in the JAX package:
  T (netG)  ResNet generator translating modality A to B's appearance,
  R (netR)  the STN predicting the field φ that aligns A to B: the UNet
            (``--stn_type unet``, one flow head or, with
            ``--stn_multiscale``, one per decoder level, composed coarse to
            fine) or the affine STN (``--stn_type affine``),
  D (netD)  70x70 PatchGAN.

The forward is the reference's ``_forward_parts``: φ is predicted once and
applied in both orders, warp(T(a), φ) (``reg_fakeB``) and T(warp(a, φ))
(``fake_B2``). ``forward`` exposes the same visuals and ``last_flow`` as the
JAX model, as NHWC numpy arrays.

``optimize_parameters`` is the JAX package's ``_train_step_impl`` in the
same order: one forward with the graph kept; the D step on the detached
reg_fakeB, through the image pool under --pool_size > 0 (one D pass over
[real_B; fake], two passes under --norm batch, plus the gradient penalty's
pass under --gan_mode wgangp; Adam); the G+R loss against the UPDATED D,
backpropagated through the kept graph with D's parameters frozen; R's
gradients clipped to --stn_grad_clip by global norm and then multiplied by
the R gate; Adam for G (not under --freeze_g) and for R; then the EMA
shadows of G and R under --ema_decay.
--grad_accum k > 1 is ``_train_step_accum``: the D phase over k
microbatches (a forward without autograd each, the pool threaded through
them), D's summed gradients over k, Adam; then the G+R phase over the
microbatches against the updated D (a forward with the graph and a backward
each), the summed gradients over k, the clip, the gate, the Adams, the EMA.
Activations live one microbatch at a time. The step's random draws (the
pool's, the penalty's alpha) come from a CPU ``torch.Generator`` seeded
from --seed, so the card and the CPU draw the same numbers.

On the card the path runs through ten hand-written kernels: K-block /
K-block-bwd for the 6 trunk blocks of each G pass, K-convt / K-convt-bwd
for G's 2 decoder stages, K-head / K-head-bwd for G's 7x7 output conv,
K-in / K-in-bwd for every other instance norm (G's encoder, the STN, D),
and K-warp / K-warp-bwd for the grid sample of (fake_B, real_A), the
multiscale STN's compositions of its fields and the --border_mask's
validity warp (forward only). Shapes G's kernels do not take run the stock
composition the JAX package runs there (``models/networks.py``).
``--block_impl`` and ``--c7_impl`` name the JAX package's TPU layouts of G's
convolutions; every choice runs these kernels. ``--norm batch|none`` runs
G's trunk and decoder and D's norms as plain convolutions and norms
(``models/networks.py``). ``--remat`` recomputes R's activations and
those of each of G's trunk blocks in the backward (the JAX package's
``jax.checkpoint`` of R and ``nn.remat`` of the blocks): the same
parameters after a step, less memory, more launches.

``--bf16`` follows the JAX package's ``_cast`` at its call sites: G, R and
D run on bf16 copies of their fp32 parameters (``BaseModel.compute``), the
inputs a and b and the fake fed to D are cast to bf16, every output of the
forward and D's predictions are cast back to fp32 before a loss, and the
grid stays fp32 (``models/stn``), as do the --border_mask's ones and their
warp. The WGAN-GP penalty's pass runs D on its fp32 parameters and fp32
inputs, as the JAX package's ``cal_gradient_penalty`` call does. The
parameters, the gradients Adam sees, the Adam state, the EMA shadows and
the pool stay fp32. K-block, K-convt, K-in and their backwards run their
bf16 variants; K-warp and K-head (and their backwards) their fp32 kernels
on fp32 copies (``ops/cast.py``).

In a data-parallel run (``nemar_tpu_torch.parallel``) --batch_size is the
global batch, as the JAX package's mesh takes it: each rank keeps its
rows of each microbatch (``set_input``); D's gradients are averaged over
the ranks after ``_mean_grads`` and before D's Adam, G's and R's before
R's clip (which then sees the global norm); the pool is one global pool,
queried with the gathered fakes; the step's draws are made for the
global rows (``_step_draws``); --border_mask's count is the global
microbatch's. Under ``--mesh_spatial`` (the image height over the ranks
of a spatial group, ``parallel/spatial.py``) every net runs its band form
at every height the JAX package's spatial mesh runs (any H the group
divides: the levels' bands may be uneven, one row or empty, re-cut where
two levels meet, and the pyramid's before each pool), and each loss is
the band's share; --border_mask's count is summed over
every rank; the WGAN-GP penalty differentiates D's band form twice, its
per-sample norm summed over the group, and each rank's loss takes a 1/s
share of it; --remat recomputes the band forms with their exchanges;
under --norm batch D's two passes and every batch norm take their sums
over every rank of the mesh; a chunk of --steps_per_execution runs the
band step on each batch's band, with the chunk's draws the global ones,
the same on every rank of a spatial group.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import networks, step_graph
from nemar_tpu_torch.models.base_model import BaseModel, to_device_nchw
from nemar_tpu_torch.models.stn import define_stn
from nemar_tpu_torch.ops.warp import grid_sample
from nemar_tpu_torch.parallel import spatial
from nemar_tpu_torch.utils import image_pool


class NEMARModel(BaseModel):
    spatial = True

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
        self.loss_names = ["D", "D_real", "D_fake", "G_GAN", "G_recon", "G_smooth", "G"]
        self.gan_mode = getattr(opt, "gan_mode", "lsgan")
        if self.gan_mode == "wgangp":
            self.loss_names.insert(3, "D_gp")
        self.field_source = getattr(opt, "stn_field_source", "pair")
        self.g_batch = getattr(opt, "g_batch", False)
        self.lambda_GAN = getattr(opt, "lambda_GAN", 1.0)
        self.lambda_recon = getattr(opt, "lambda_recon", 100.0)
        self.lambda_smooth = getattr(opt, "lambda_smooth", 10.0)
        stn_lr = getattr(opt, "stn_lr", None)
        self.stn_lr_ratio = 1.0 if stn_lr is None else stn_lr / getattr(opt, "lr", 2e-4)
        self.gan_warmup = getattr(opt, "gan_warmup_epochs", 0)
        self.gan_ramp = getattr(opt, "gan_ramp_epochs", 0)
        self.stn_warmup = getattr(opt, "stn_warmup_epochs", 0)
        self.stn_ramp = getattr(opt, "stn_ramp_epochs", 0)
        self.stn_grad_clip = getattr(opt, "stn_grad_clip", 0.0)
        self.border_mask = getattr(opt, "border_mask", False)
        self.recon_pyramid = getattr(opt, "recon_pyramid", 0)
        self.freeze_g = getattr(opt, "freeze_g", False)
        self.grad_accum = max(1, getattr(opt, "grad_accum", 1))
        if getattr(opt, "opt_split", False):
            # the JAX package's refusals (its two programs a step), word for word
            if getattr(opt, "steps_per_execution", 1) > 1:
                raise ValueError("--opt_split is per-step (two programs); "
                                 "incompatible with --steps_per_execution > 1")
            if self.grad_accum > 1:
                raise ValueError("--opt_split is incompatible with "
                                 "--grad_accum > 1")
        if self.isTrain and opt.batch_size % self.grad_accum:
            raise ValueError(f"--grad_accum {self.grad_accum} must divide "
                             f"--batch_size {opt.batch_size}")
        self.ema_decay = getattr(opt, "ema_decay", 0.0) if self.isTrain else 0.0
        self.use_ema = getattr(opt, "use_ema", False)
        self.pool_size = getattr(opt, "pool_size", 0) if self.isTrain else 0
        if self.g_batch and opt.norm == "batch":
            # the 2N concatenated G pass would mix batch statistics between
            # a and warped_A (the JAX package's refusal)
            raise ValueError("--g_batch requires --norm instance|none "
                             "(batch norm mixes stats across the 2N pass)")
        self.remat = getattr(opt, "remat", False)
        if not opt.no_dropout:
            # the JAX package's step passes G no dropout key either, and
            # fails at its first training forward
            raise ValueError("the nemar model's G takes no dropout: set no_dropout "
                             "(--no_dropout, the model's default)")
        if self.recon_pyramid > 0 and opt.crop_size % (2 ** self.recon_pyramid):
            raise ValueError(
                f"--recon_pyramid {self.recon_pyramid} needs --crop_size "
                f"divisible by {2 ** self.recon_pyramid}, got {opt.crop_size}")

        gen = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        self.netG = networks.define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.netG,
                                      opt.norm, not opt.no_dropout, self.remat)
        self.netD = networks.define_D(opt.output_nc, opt.ndf, opt.netD, opt.n_layers_D, opt.norm)
        networks.init_weights(self.netG, opt.init_gain, gen, opt.init_type)
        networks.init_weights(self.netD, opt.init_gain, gen, opt.init_type)
        self.netR = define_stn(opt, opt.stn_type)
        # R's layers draw from the reference's normal(0.02) whatever
        # --init_type says (the JAX define_stn takes none); its heads (every
        # flow head of the UNet, the affine STN's Dense_1) stay zero, so a
        # fresh R warps by the identity
        networks.init_weights(self.netR, 0.02, gen)
        for head in self.netR.heads():
            torch.nn.init.zeros_(head.weight)
            torch.nn.init.zeros_(head.bias)
        for net in self.nets().values():
            net.to(self.device, memory_format=torch.channels_last)
            net.train(self.isTrain)
        # the step's draws (the pool's, the penalty's alpha), on the CPU
        self.rng = torch.Generator().manual_seed(getattr(opt, "seed", 0) + 17)
        # under --mesh_spatial the pool holds this rank's band of each image
        # (and a save gathers its frames for a moment)
        self.band = None
        self._pool_frames = None
        pool_rows = opt.crop_size // parallel.spatial_size()
        self.pool = (image_pool.init_pool(self.pool_size, (opt.output_nc, pool_rows,
                                                           opt.crop_size), self.device)
                     if self.pool_size > 0 else None)
        self.ema = None  # {net: {parameter name: shadow}}, made by setup
        # --steps_per_execution: the chunk's draws while a chunk's step runs,
        # and a step_graph.StepGraph per chunk shape
        self._slots = None
        self._step_graphs: dict = {}

    def setup(self, opt):
        """BaseModel.setup, then the EMA shadows of G and R as copies of
        their parameters (a resume then loads the saved ones)."""
        if self.ema_decay > 0:
            self.ema = {n: {k: p.detach().clone() for k, p in self.nets()[n].named_parameters()}
                        for n in ("G", "R")}
        super().setup(opt)

    def to_dtype(self, dtype: torch.dtype) -> None:
        """BaseModel.to_dtype, and the pool's buffer."""
        super().to_dtype(dtype)
        if self.pool is not None:
            self.pool = (self.pool[0].to(dtype), self.pool[1])

    def make_optimizers(self) -> dict:
        """Adam per net (``BaseModel.adam``); R takes --stn_beta1 and lr *
        stn_lr / lr."""
        beta1 = self.opt.beta1
        stn_beta1 = getattr(self.opt, "stn_beta1", None)
        return {"G": self.adam(self.netG.parameters(), beta1),
                "D": self.adam(self.netD.parameters(), beta1),
                "R": self.adam(self.netR.parameters(), beta1 if stn_beta1 is None else stn_beta1,
                               self.stn_lr_ratio)}

    def _forward_parts(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        """Both warp orders from one φ; NCHW tensors in and out. With
        --border_mask, also the warp's validity mask (N, 1, H, W), detached.
        Under --bf16 the nets run in bf16 and every output is cast back to
        fp32. Under --mesh_spatial (``self.band``) every net runs its band
        form: every output is its band of the frame's, reg its share, the
        mask the warp's validity on the band's rows (the frame's ones
        sampled at the band's grid), and --remat's recomputation runs R's
        exchanges and all-gathers again."""
        band = self.band
        kw = {} if band is None else {"band": band}
        netG, netR = self.compute(self.netG), self.compute(self.netR)
        if self.remat and torch.is_grad_enabled():
            # R's activations recomputed in the backward (jax.checkpoint of
            # netR.apply); G's blocks are checkpointed by define_G
            netR = functools.partial(networks.remat, netR)
        ca, cb = self.cast(a), self.cast(b)
        if self.field_source == "pair" and self.g_batch:
            # φ depends only on (a, b): R first, then ONE G pass at 2N over
            # [a; warp(a, φ)], then the warp of fake_B with the same grid
            # (of fake_B's frame, gathered, under --mesh_spatial)
            (warped_A,), reg, aux = netR(ca, cb, (ca,), n_grad_imgs=0, **kw)
            both = netG(torch.cat([ca, warped_A], dim=0), **kw)
            fake_B, fake_B2 = torch.split(both, a.shape[0], dim=0)
            src = networks.to_nhwc(fake_B)
            if band is not None:
                src = spatial.gather_frame(src, band, dim=1)
            reg_fakeB = networks.to_nchw(grid_sample(
                src, aux["grid"], "bilinear", self.netR.padding_mode, self.netR.align_corners))
        else:
            fake_B = netG(ca, **kw)
            src = (ca, cb) if self.field_source == "pair" else (fake_B, cb)
            (reg_fakeB, warped_A), reg, aux = netR(src[0], src[1], (fake_B, ca), n_grad_imgs=1,
                                                   **kw)
            fake_B2 = netG(warped_A, **kw)
        out = {k: self.uncast(v) for k, v in (
            ("fake_B", fake_B), ("reg_fakeB", reg_fakeB), ("warped_A", warped_A),
            ("fake_B2", fake_B2), ("reg", reg), ("flow", aux["flow"]))}
        if self.border_mask:
            # validity of each output pixel under the warp; no gradient: the
            # mask must not be a lever for shrinking the loss support
            with torch.no_grad():
                out["mask"] = self._validity(a.shape[2] if band is None else band.height,
                                             aux["grid"])
        return out

    def _validity(self, height: int, grid: torch.Tensor) -> torch.Tensor:
        """--border_mask's mask (N, 1, H_grid, W): ones of a frame of
        ``height`` rows sampled at ``grid``, in the grid's type (fp32 under
        fp32 and --bf16, as the JAX package's; float64 in a float64 run,
        whose count would otherwise carry fp32 roundoff that depends on the
        order of its sum, over bands or ranks)."""
        n, _, w, _ = grid.shape
        ones = torch.ones((n, height, w, 1), dtype=grid.dtype, device=grid.device)
        return networks.to_nchw(grid_sample(ones, grid, "bilinear", "zeros",
                                            getattr(self.opt, "stn_align_corners", False)))

    # ------------------------------------------------------------------
    # the training step
    # ------------------------------------------------------------------
    def _d_loss(self, fake: torch.Tensor, b: torch.Tensor):
        """One D pass over [real; fake] (instance norm is per sample; two
        passes under --norm batch, as the JAX package's); under wgangp the
        gradient penalty adds its own pass over the mix.
        -> (loss, (l_real, l_fake, penalty or None)). Under --bf16 D's passes
        are bf16, their predictions cast back to fp32; the penalty's pass is
        fp32, as the JAX package's. Under --mesh_spatial the band's shares."""
        band = self.band
        pred_real, pred_fake, pband = networks.d_preds(
            self.compute(self.netD), self.cast(b), self.cast(fake), self.opt.norm, band)
        l_real = networks.gan_loss(self.uncast(pred_real), True, self.gan_mode, pband)
        l_fake = networks.gan_loss(self.uncast(pred_fake), False, self.gan_mode, pband)
        loss = 0.5 * (l_real + l_fake)
        gp = None
        if self.gan_mode == "wgangp":
            # the same alpha on every rank of a spatial group (its rows')
            alpha = self._gp_alpha(b.shape[0]).to(b.dtype)
            gp = networks.cal_gradient_penalty(self.netD, b, fake, alpha, band=band)
            if band is not None:
                # every rank of the group holds the whole penalty, and the
                # gradients' all-reduce sums over the group: a 1/s share each
                gp = gp / band.size
            loss = loss + gp
        return loss, (l_real, l_fake, gp)

    def _global_micro(self, m: int) -> int:
        """The global microbatch that a local one of m rows belongs to (m
        itself outside a data-parallel run)."""
        return m if parallel.data_world() == 1 else self.micro_n

    def _gp_alpha(self, n: int) -> torch.Tensor:
        """The penalty's alpha for the n rows of this microbatch (n, 1, 1,
        1), uniform in [0, 1): drawn for the global microbatch, this rank's
        rows of it (in a chunk, the next of the chunk's draws)."""
        if self._slots is not None:
            return next(self._slots)
        m = self._global_micro(n)
        return torch.rand((m, 1, 1, 1), generator=self.rng)[parallel.rows_in(m)].to(self.device)

    def _pool_draws(self, n: int) -> tuple:
        """The pool's draws for n fakes of the global microbatch
        (``utils/image_pool.draw``; in a chunk, the next of the chunk's
        draws)."""
        if self._slots is not None:
            return next(self._slots), next(self._slots)
        return tuple(t.to(self.device) for t in image_pool.draw(self.rng, n, self.pool_size))

    def _step_draws(self, n: int) -> list:
        """One step's draws from ``self.rng`` in the order the step takes
        them, per microbatch of the global batch of n rows split by
        --grad_accum: the pool's (use_old, rand_idx) for the microbatch,
        then the penalty's alpha for this rank's rows of it (CPU tensors)."""
        m = n // self.grad_accum
        out = []
        for _ in range(self.grad_accum):
            if self.pool is not None:
                out.extend(image_pool.draw(self.rng, m, self.pool_size))
            if self.gan_mode == "wgangp":
                out.append(torch.rand((m, 1, 1, 1), generator=self.rng)[parallel.rows_in(m)])
        return out

    def _query_pool(self, fake: torch.Tensor) -> torch.Tensor:
        """The batch D sees; the pool is updated in place (a CUDA graph of
        the step writes to the addresses it was captured with). In a
        data-parallel run the pool is the one global pool, the same on
        every rank: it takes the global microbatch's fakes, gathered from
        the ranks, and this rank keeps its rows of what comes out."""
        if self.pool is None:
            return fake
        m = self._global_micro(fake.shape[0])
        full = parallel.all_gather_rows(fake) if parallel.sharded(m) else fake
        images, count, out = image_pool.query_pool(*self.pool, full, *self._pool_draws(m))
        self.pool[0].copy_(images)
        self.pool[1].copy_(count)
        return out[parallel.rows_in(m)]

    def _recon_l1(self, x, y, m, band=None):
        """mean |x - y|, or under --border_mask the sum over the valid
        pixels over their count: the global microbatch's count in a
        data-parallel run or over bands (every rank's), the numerator scaled
        by the data width so that the gradient all-reduce's sum over the
        ranks over that width is the global loss. With ``band`` (x, y, m
        this rank's band of their frames) the band's share of the mean."""
        if m is None:
            if band is not None:
                return spatial.frame_mean(torch.abs(x - y), band)
            return torch.mean(torch.abs(x - y))
        num = torch.sum(torch.abs(x - y).mean(1, keepdim=True) * m)
        den = torch.sum(m)
        if band is not None or parallel.sharded(self._global_micro(x.shape[0])):
            num = num * parallel.data_world()
            den = parallel.sum_over_ranks(den)
        return num / torch.clamp_min(den, 1.0)

    def _head_loss(self, o: dict, b: torch.Tensor, gan_scale):
        """G+R loss on the forward outputs ``o`` against D as it is now (its
        pass in bf16 under --bf16, the prediction cast back to fp32);
        ``gan_scale`` is the GAN weight times --lambda_GAN. Under
        --mesh_spatial each term is the band's share of the global mean (the
        pyramid's bands re-cut to even bounds before each 2x2 pool, the
        mask's with them: ``spatial.reband``)."""
        band = self.band
        if band is not None:
            pred, pband = self.compute(self.netD)(self.cast(o["reg_fakeB"]), band)
            l_gan = networks.gan_loss(self.uncast(pred), True, self.gan_mode, pband)
        else:
            pred = self.uncast(self.compute(self.netD)(self.cast(o["reg_fakeB"])))
            l_gan = networks.gan_loss(pred, True, self.gan_mode)
        m = o.get("mask")
        rf, f2, bb = o["reg_fakeB"], o["fake_B2"], b
        l_recon = self._recon_l1(rf, bb, m, band) + self._recon_l1(f2, bb, m, band)
        # --recon_pyramid: K extra 2x2-average-pooled octaves
        pool = functools.partial(F.avg_pool2d, kernel_size=2) if band is None else spatial.pool2
        for _ in range(self.recon_pyramid):
            if band is not None:  # each pool's 2x2 blocks within one band
                even = band.aligned(2)
                rf, f2, bb = (spatial.reband(t, band, even) for t in (rf, f2, bb))
                m = spatial.reband(m, band, even) if m is not None else None
                band = even.pooled(2)
            rf, f2, bb = pool(rf), pool(f2), pool(bb)
            m = pool(m) if m is not None else None
            l_recon = l_recon + self._recon_l1(rf, bb, m, band) + self._recon_l1(f2, bb, m, band)
        l_recon = l_recon / (1 + self.recon_pyramid)
        l_smooth = o["reg"]
        total = (gan_scale * l_gan + self.lambda_recon * l_recon
                 + self.lambda_smooth * l_smooth)
        return total, (l_gan, l_recon, l_smooth)

    def _clip_r(self, grads: list) -> None:
        """--stn_grad_clip: scale R's gradients to at most that global norm
        (in place, on the device)."""
        c = self.stn_grad_clip
        if c <= 0:
            return
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = torch.clamp(c / torch.clamp_min(gnorm, 1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)

    def _gan_w_scalar(self) -> float:
        """GAN weight for the current epoch: 0 through the R warm-up, then a
        linear ramp."""
        epoch = getattr(self, "_cur_epoch", getattr(self.opt, "epoch_count", 1))
        if not self.isTrain or self.gan_warmup <= 0:
            return 1.0
        if epoch <= self.gan_warmup:
            return 0.0
        if self.gan_ramp > 0:
            return min(1.0, (epoch - self.gan_warmup) / float(self.gan_ramp))
        return 1.0

    def _r_gate_scalar(self) -> float:
        """R's gradient gate: 0 while R is frozen (--stn_warmup_epochs), then
        a linear ramp over --stn_ramp_epochs."""
        epoch = getattr(self, "_cur_epoch", getattr(self.opt, "epoch_count", 1))
        if not self.isTrain:
            return 1.0
        if epoch <= self.stn_warmup:
            return 0.0
        if self.stn_ramp > 0:
            return min(1.0, (epoch - self.stn_warmup) / float(self.stn_ramp))
        return 1.0

    def optimize_parameters(self):
        """One training step: the JAX package's ``_train_step_impl``, or
        under --grad_accum k > 1 its ``_train_step_accum``."""
        self._losses = self._train_step(self.real_A, self.real_B,
                                        self._gan_w_scalar() * self.lambda_GAN,
                                        self._r_gate_scalar())
        self.step += 1

    def _train_step(self, a: torch.Tensor, b: torch.Tensor, gan_scale, r_gate) -> dict:
        """The step on (a, b) -> its losses (detached). ``gan_scale`` (the
        GAN weight times --lambda_GAN) and ``r_gate`` are floats, or, in a
        chunk of --steps_per_execution, device scalars of the parameters'
        dtype holding the same values (a CUDA graph reads them at each
        replay): the products round alike either way, and R's gradients
        are gated by a multiply that is exact at a gate of 1."""
        k = self.grad_accum
        if k == 1:  # one forward, kept for the G+R backward
            out = self._forward_parts(a, b)
            d_micro = [(out["reg_fakeB"].detach(), b)]
            g_micro = [(out, b)]
        else:
            pairs = list(zip(torch.chunk(a, k), torch.chunk(b, k)))

            def detached_fakes():
                for ai, bi in pairs:
                    with torch.no_grad():  # not around the yield: it would hold
                        fake = self._forward_parts(ai, bi)["reg_fakeB"]
                    yield fake, bi

            d_micro = detached_fakes()
            g_micro = ((self._forward_parts(ai, bi), bi) for ai, bi in pairs)
        loss_D, l_dr, l_df, l_gp = self._d_phase(d_micro)
        loss_G, l_gan, l_rec, l_sm = self._g_phase(g_micro, gan_scale)

        grads_R = [p.grad for p in self.netR.parameters() if p.grad is not None]
        self._clip_r(grads_R)
        if isinstance(r_gate, torch.Tensor) or r_gate != 1.0:
            # zeroed grads keep the Adam moments at zero while R is frozen
            torch._foreach_mul_(grads_R, r_gate)
        self.optimizers["R"].step()
        if not self.freeze_g:
            self.optimizers["G"].step()
        self._update_ema()
        return {k: v.detach() for k, v in (
            ("D", loss_D), ("D_real", l_dr), ("D_fake", l_df), ("D_gp", l_gp),
            ("G_GAN", l_gan), ("G_recon", l_rec), ("G_smooth", l_sm), ("G", loss_G))
            if v is not None}

    # -- --steps_per_execution ---------------------------------------------
    def optimize_parameters_scan(self, batches: list):
        """--steps_per_execution: one step on each of ``batches``, the JAX
        package's ``optimize_parameters_scan``. The lr, the GAN weight and
        R's gate are read once and hold across the chunk; the losses
        reported after it are the means over its steps; real_A and real_B
        are left at its last batch (under --mesh_spatial its band, whose
        frames ``forward`` gathers); the step count advances by its length.
        The chunk's batches (this rank's rows and band of each) and draws
        (the global draws, alike on every rank) go to the device at once
        (``step_graph.Chunk``). On the card its steps are replays of one
        CUDA graph of the step (``step_graph.StepGraph``); on the CPU they
        run eagerly, through the same code."""
        self._run_chunk(batches, self.device.type == "cuda")

    def optimize_parameters_scan_eager(self, batches: list):
        """``optimize_parameters_scan`` with every step run eagerly: on the
        card, what the graph's replays are held against."""
        self._run_chunk(batches, False)

    def _run_chunk(self, batches: list, graph: bool) -> None:
        dtype = next(self.netG.parameters()).dtype
        gan_scale, r_gate = self._gan_w_scalar() * self.lambda_GAN, self._r_gate_scalar()
        n = parallel.global_rows(batches[0])
        self.micro_n = n // self.grad_accum
        # every rank of a spatial group draws the global draws, alike
        draws = [self._step_draws(n) for _ in batches]
        # the chunk is sharded as a batch is (P(None, 'data') in the JAX
        # package), and cut to this rank's band as ``set_input`` cuts
        batches = [self._band_rows(parallel.shard_rows(b, self.grad_accum)) for b in batches]
        chunk = step_graph.Chunk(batches, draws, self.device, dtype)
        key = (chunk.key(), self.band)
        if key not in self._step_graphs:
            self._step_graphs[key] = step_graph.StepGraph(self, chunk, dtype)
        runner = self._step_graphs[key]
        self._losses = runner.run(self, chunk, gan_scale, r_gate, graph)
        self.real_A, self.real_B = chunk.last()
        self.image_paths = batches[-1].get("A_paths", [])
        self.step += len(batches)

    def _d_phase(self, micro) -> list:
        """D's step over the microbatches ``micro`` of (detached fake, real):
        each through the pool, its loss (and penalty) backpropagated into
        D's .grad; the summed gradients over their number, then D's Adam (not
        under --freeze_g, where the loss is only reported). -> the mean
        losses [D, D_real, D_fake, D_gp or None]."""
        opt_D = self.optimizers["D"]
        params = list(self.netD.parameters())
        opt_D.zero_grad(set_to_none=True)
        sums, k = None, 0
        for fake, bi in micro:
            fake = self._query_pool(fake)
            if self.freeze_g:
                with torch.no_grad():
                    loss, parts = self._d_loss(fake, bi)
            else:
                loss, parts = self._d_loss(fake, bi)
                loss.backward(inputs=params)
            terms = [loss.detach(), *(t if t is None else t.detach() for t in parts)]
            sums = terms if sums is None else [t if t is None else s + t
                                               for s, t in zip(sums, terms)]
            k += 1
        if not self.freeze_g:
            _mean_grads(params, k)
            parallel.all_reduce_grads(params)
            opt_D.step()
        return [t if t is None or k == 1 else t / k for t in sums]

    def _g_phase(self, micro, gan_scale) -> list:
        """The G+R gradients over the microbatches ``micro`` of (forward
        outputs with their graph, real) against D as it is now, frozen: each
        head loss backpropagated, the summed gradients over their number.
        -> the mean losses [G, G_GAN, G_recon, G_smooth]."""
        params = list(self.netG.parameters()) + list(self.netR.parameters())
        self.optimizers["G"].zero_grad(set_to_none=True)
        self.optimizers["R"].zero_grad(set_to_none=True)
        self.netD.requires_grad_(False)
        sums, k = None, 0
        try:
            for o, bi in micro:
                loss, parts = self._head_loss(o, bi, gan_scale)
                loss.backward()
                terms = [loss.detach(), *(t.detach() for t in parts)]
                sums = terms if sums is None else [s + t for s, t in zip(sums, terms)]
                k += 1
        finally:
            self.netD.requires_grad_(True)
        _mean_grads(params, k)
        # before R's clip, which then sees the global norm
        parallel.all_reduce_grads(params)
        return [t if k == 1 else t / k for t in sums]

    def _update_ema(self) -> None:
        """e <- d * e + (1 - d) * p for G's and R's shadows (the JAX
        package's form, after the Adam steps; under --freeze_g too)."""
        if self.ema is None:
            return
        d = self.ema_decay
        for n, shadow in self.ema.items():
            params = dict(self.nets()[n].named_parameters())
            keys = list(shadow)
            # in place (a CUDA graph of the step writes to the addresses it
            # was captured with), rounded as d * e + (1 - d) * p
            shadows = [shadow[k] for k in keys]
            torch._foreach_mul_(shadows, d)
            torch._foreach_add_(shadows, torch._foreach_mul([params[k].detach() for k in keys],
                                                            1.0 - d))

    # -- the training state beyond the nets and the Adams ------------------
    def shadow_states(self) -> dict:
        """The EMA shadows as the pseudo-nets G_ema and R_ema, with netG's
        and netR's keys."""
        if self.ema is None:
            return {}
        return {f"{n}_ema": shadow for n, shadow in self.ema.items()}

    def save_networks(self, suffix):
        """BaseModel.save_networks; under --mesh_spatial every rank first
        gathers the pool's frames (rank 0 writes them), so the saved pool is
        the whole frames', which any width resumes."""
        if self.pool is not None and parallel.spatial_size() > 1:
            self._pool_frames = spatial.gather_frame(
                self.pool[0], self.band_of(self.opt.crop_size), dim=2)
        try:
            super().save_networks(suffix)
        finally:
            self._pool_frames = None

    def extra_train_state(self) -> dict:
        """The step generator's state and the pool (buffer and count)."""
        state = {"rng": self.rng.get_state()}
        if self.pool is not None:
            images = self.pool[0] if self._pool_frames is None else self._pool_frames
            state["pool"] = {"images": images.cpu(), "count": self.pool[1].cpu()}
        return state

    def load_extra_train_state(self, state: dict, suffix) -> None:
        if "rng" in state:
            self.rng.set_state(state["rng"])
        if self.pool is not None and "pool" in state:
            images = state["pool"]["images"]
            band = self.band_of(images.shape[2])
            if band is not None:
                images = images[:, :, band.r0:band.r1]
            self.pool = (images.to(self.device), state["pool"]["count"].to(self.device))
        if self.ema is not None:
            for n in self.ema:
                self.ema[n] = self._load_shadow(suffix, n)

    def _load_shadow(self, suffix, name: str) -> dict:
        path = self._net_path(suffix, f"{name}_ema")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no EMA shadow of net {name} at {path}")
        print(f"loading the EMA shadow from {path}")
        shadow = torch.load(path, map_location=self.device, weights_only=True)
        params = dict(self.nets()[name].named_parameters())
        if set(shadow) != set(params):
            raise KeyError(f"{path}: keys differ from net{name}'s")
        return {k: shadow[k].to(params[k].dtype) for k in params}

    def load_networks(self, suffix):
        """Every net; with --use_ema (test) then G's and R's EMA shadows
        into netG and netR, so the forward runs through them."""
        super().load_networks(suffix)
        if not self.isTrain and self.use_ema:
            for n in ("G", "R"):
                self.nets()[n].load_state_dict(self._load_shadow(suffix, n))

    # ------------------------------------------------------------------
    # reference-API host methods
    # ------------------------------------------------------------------
    def set_input(self, data: dict):
        """data['A'], data['B']: NHWC float numpy batches, the global batch
        (over several hosts under --loader grain, the host's rows of it:
        ``parallel.global_rows``); in a data-parallel run this rank keeps
        its rows of each microbatch (``parallel.shard_rows``), and under
        --mesh_spatial its band of their rows (``self.band``)."""
        self.micro_n = parallel.global_rows(data) // self.grad_accum
        data = self._band_rows(parallel.shard_rows(data, self.grad_accum))
        self.real_A = to_device_nchw(data["A"], self.device, self.dtype)
        self.real_B = to_device_nchw(data["B"], self.device, self.dtype)
        self.image_paths = data.get("A_paths", [])

    def _band_rows(self, data: dict) -> dict:
        """``data`` (this rank's rows) with A and B cut to this rank's band
        of their height, which becomes ``self.band`` (under --mesh_spatial;
        else ``data`` itself and no band)."""
        self.band = self.band_of(np.shape(data["A"])[1])
        if self.band is None:
            return data
        r0, r1 = self.band.r0, self.band.r1
        return {**data, "A": data["A"][:, r0:r1], "B": data["B"][:, r0:r1]}

    def forward(self):
        """The forward's visuals and ``last_flow``; under --mesh_spatial
        their whole frames, gathered on every rank."""
        out = self._forward_parts(self.real_A, self.real_B)
        visuals = {
            "real_A": self.real_A, "real_B": self.real_B,
            "fake_B": out["fake_B"], "reg_fakeB": out["reg_fakeB"],
            "warped_A": out["warped_A"], "fake_B2": out["fake_B2"],
        }
        flow = out["flow"]
        if self.band is not None:
            visuals = {k: spatial.gather_frame(v, self.band, dim=2) for k, v in visuals.items()}
            flow = spatial.gather_frame(flow, self.band, dim=1)
        # (N, H, W, 2) normalised field, NHWC numpy as the JAX model's
        self.last_flow = flow.detach().cpu().numpy()
        self._visuals = visuals
        return out



def _mean_grads(params: list, k: int) -> None:
    """Divide the gradients summed over k microbatches by k (in place)."""
    if k > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(k)

