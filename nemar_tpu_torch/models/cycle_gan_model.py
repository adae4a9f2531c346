"""CycleGAN: unpaired translation between two domains (template lineage,
``nemar_tpu/models/cycle_gan_model.py``).

  G_A: A -> B, G_B: B -> A; D_A judges domain-B images, D_B domain-A ones.
  L = GAN(G_A) + GAN(G_B)
    + λ_A ‖G_B(G_A(a)) − a‖₁ + λ_B ‖G_A(G_B(b)) − b‖₁           (cycle)
    + λ_idt (λ_B ‖G_A(b) − b‖₁ + λ_A ‖G_B(a) − a‖₁)             (identity)

Template defaults: ``resnet_9blocks``, instance norm, no dropout, lsgan, a
pool of 50, the unaligned dataset, λ_A = λ_B = 10, λ_idt = 0.5. The step is
the JAX package's ``_train_step_impl``: G_A and G_B take one joint Adam
step against D_A and D_B as they are (their parameters frozen: they take
no gradient from it); then both Ds step (one Adam) on the detached fakes
through their pools, ``pool_B`` (G_A's fakes) queried before ``pool_A``,
with draws from the model's CPU generator (``utils/image_pool.py``), so
the card and the CPU draw the same. A D sees real and fake in one pass
where its norm is per sample, in two under batch norm
(``networks.d_preds``). Six G passes and four D passes a step.

The model computes in fp32 whatever --bf16 says, as the JAX package's.
In a data-parallel run each rank takes its rows of the global batch, the
gradients are averaged over the ranks before each Adam step, and each
pool is one global pool, the same on every rank (``_query_pool``). Under
--mesh_spatial each rank also keeps its band of the rows (``band``): the
six G passes and four D passes run their band forms, the GAN, cycle and
identity terms are the band's shares of their means
(``spatial.frame_mean``), each pool holds this rank's band of each image
(the same draws on every rank, so the bands of one pool are the frames
of the one-process pool), a save gathers the pools' frames and a load cuts
them to the band, so a checkpoint is the same at any width, and the
visuals are the whole frames, gathered on every rank.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import networks
from nemar_tpu_torch.models.base_model import BaseModel, dropout_seed, to_device_nchw
from nemar_tpu_torch.parallel import spatial
from nemar_tpu_torch.utils import image_pool


class CycleGANModel(BaseModel):
    spatial = True

    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        parser.set_defaults(no_dropout=True, netG="resnet_9blocks", dataset_mode="unaligned")
        if is_train:
            parser.add_argument("--lambda_A", type=float, default=10.0,
                                help="weight for cycle loss (A -> B -> A)")
            parser.add_argument("--lambda_B", type=float, default=10.0,
                                help="weight for cycle loss (B -> A -> B)")
            parser.add_argument("--lambda_identity", type=float, default=0.5,
                                help="identity mapping loss weight scale")
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.loss_names = ["D_A", "G_A", "cycle_A", "idt_A", "D_B", "G_B", "cycle_B", "idt_B"]
        self.visual_names = ["real_A", "fake_B", "rec_A", "real_B", "fake_A", "rec_B"]
        self.model_names = ["G_A", "G_B", "D_A", "D_B"] if self.isTrain else ["G_A", "G_B"]
        if opt.input_nc != opt.output_nc:
            raise ValueError("cycle_gan requires input_nc == output_nc "
                             "(identity/cycle terms compare across domains)")
        seed = getattr(opt, "seed", 0)
        # dropout's draws (with --no_dropout off), reseeded before each step
        # from the seed and the step count, as pix2pix's
        self.drop_seed = seed + 23
        self.drop_gen = torch.Generator(self.device).manual_seed(self.drop_seed)
        gen = torch.Generator().manual_seed(seed)
        for n in ("G_A", "G_B"):
            net = networks.define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.netG, opt.norm,
                                    not opt.no_dropout, getattr(opt, "remat", False),
                                    self.drop_gen)
            networks.init_weights(net, opt.init_gain, gen, opt.init_type)
            setattr(self, f"net{n}", net)
        if self.isTrain:
            for n in ("D_A", "D_B"):
                net = networks.define_D(opt.output_nc, opt.ndf, opt.netD, opt.n_layers_D, opt.norm)
                networks.init_weights(net, opt.init_gain, gen, opt.init_type)
                setattr(self, f"net{n}", net)
        for net in self.nets().values():
            net.to(self.device, memory_format=torch.channels_last)
            net.train(self.isTrain)
        self.gan_mode = getattr(opt, "gan_mode", "lsgan")
        self.lambda_A = getattr(opt, "lambda_A", 10.0)
        self.lambda_B = getattr(opt, "lambda_B", 10.0)
        self.lambda_idt = getattr(opt, "lambda_identity", 0.5)
        self.pool_size = getattr(opt, "pool_size", 50) if self.isTrain else 0
        # the pools' draws, on the CPU (the JAX state's key is seed + 31)
        self.rng = torch.Generator().manual_seed(seed + 31)
        # under --mesh_spatial each pool holds this rank's band of each image
        # (and a save gathers their frames for a moment)
        self.band = None
        self._pool_frames = None
        shape = (opt.output_nc, opt.crop_size // parallel.spatial_size(), opt.crop_size)
        self.pools = ({k: image_pool.init_pool(self.pool_size, shape, self.device)
                       for k in ("A", "B")} if self.pool_size > 0 else None)

    def make_optimizers(self) -> dict:
        """One Adam over G_A and G_B, one over D_A and D_B, as the JAX
        package's two optax states."""
        b1 = self.opt.beta1
        return {"G": self.adam([*self.netG_A.parameters(), *self.netG_B.parameters()], b1),
                "D": self.adam([*self.netD_A.parameters(), *self.netD_B.parameters()], b1)}

    def to_dtype(self, dtype: torch.dtype) -> None:
        """BaseModel.to_dtype, and the pools' buffers."""
        super().to_dtype(dtype)
        if self.pools is not None:
            self.pools = {k: (p[0].to(dtype), p[1]) for k, p in self.pools.items()}

    def _pool_draws(self, n: int) -> tuple:
        """One pool's draws for n fakes (``utils/image_pool.draw``)."""
        return tuple(t.to(self.device) for t in image_pool.draw(self.rng, n, self.pool_size))

    def _query_pool(self, key: str, fake: torch.Tensor) -> torch.Tensor:
        """The batch D sees. In a data-parallel run each pool is one global
        pool, the same on every rank: it takes the global batch's fakes,
        gathered from the ranks, and this rank keeps its rows."""
        if self.pools is None:
            return fake
        n = fake.shape[0] if parallel.world() == 1 else self.global_n
        full = parallel.all_gather_rows(fake) if parallel.sharded(n) else fake
        images, count, out = image_pool.query_pool(*self.pools[key], full, *self._pool_draws(n))
        self.pools[key] = (images, count)
        return out[parallel.rows_in(n)]

    def _l1(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """mean |x - y|: the band's share of it under --mesh_spatial."""
        d = torch.abs(x - y)
        return torch.mean(d) if self.band is None else spatial.frame_mean(d, self.band)

    def _gan(self, net_d, fake: torch.Tensor) -> torch.Tensor:
        """The generator's GAN term of D on fake (the band's share)."""
        pred, pband = networks.d_pred(net_d, fake, self.band)
        return networks.gan_loss(pred, True, self.gan_mode, pband)

    def optimize_parameters(self):
        """One step: the JAX package's ``_train_step_impl``."""
        a, b = self.real_A, self.real_B
        opt_G, opt_D = self.optimizers["G"], self.optimizers["D"]
        self.drop_gen.manual_seed(dropout_seed(self.drop_seed, self.step))

        # G_A + G_B against the Ds as they are, the Ds frozen
        opt_G.zero_grad(set_to_none=True)
        for net in (self.netD_A, self.netD_B):
            net.requires_grad_(False)
        try:
            fake_B = self.netG_A(a, self.band)
            rec_A = self.netG_B(fake_B, self.band)
            fake_A = self.netG_B(b, self.band)
            rec_B = self.netG_A(fake_A, self.band)
            l_g_a = self._gan(self.netD_A, fake_B)
            l_g_b = self._gan(self.netD_B, fake_A)
        finally:
            for net in (self.netD_A, self.netD_B):
                net.requires_grad_(True)
        l_cyc_a = self._l1(rec_A, a) * self.lambda_A
        l_cyc_b = self._l1(rec_B, b) * self.lambda_B
        if self.lambda_idt > 0:
            l_idt_a = self._l1(self.netG_A(b, self.band), b) * self.lambda_B * self.lambda_idt
            l_idt_b = self._l1(self.netG_B(a, self.band), a) * self.lambda_A * self.lambda_idt
        else:
            l_idt_a = l_idt_b = torch.zeros((), device=a.device, dtype=a.dtype)
        (l_g_a + l_g_b + l_cyc_a + l_cyc_b + l_idt_a + l_idt_b).backward()
        parallel.all_reduce_grads([*self.netG_A.parameters(), *self.netG_B.parameters()])
        opt_G.step()

        # D_A and D_B on the pooled, detached fakes
        fake_B = self._query_pool("B", fake_B.detach())
        fake_A = self._query_pool("A", fake_A.detach())
        opt_D.zero_grad(set_to_none=True)
        norm = self.opt.norm
        pr_a, pf_a, pb_a = networks.d_preds(self.netD_A, b, fake_B, norm, self.band)
        pr_b, pf_b, pb_b = networks.d_preds(self.netD_B, a, fake_A, norm, self.band)
        l_d_a = 0.5 * (networks.gan_loss(pr_a, True, self.gan_mode, pb_a)
                       + networks.gan_loss(pf_a, False, self.gan_mode, pb_a))
        l_d_b = 0.5 * (networks.gan_loss(pr_b, True, self.gan_mode, pb_b)
                       + networks.gan_loss(pf_b, False, self.gan_mode, pb_b))
        (l_d_a + l_d_b).backward()
        parallel.all_reduce_grads([*self.netD_A.parameters(), *self.netD_B.parameters()])
        opt_D.step()
        self._losses = {k: v.detach() for k, v in (
            ("D_A", l_d_a), ("G_A", l_g_a), ("cycle_A", l_cyc_a), ("idt_A", l_idt_a),
            ("D_B", l_d_b), ("G_B", l_g_b), ("cycle_B", l_cyc_b), ("idt_B", l_idt_b))}
        self.step += 1

    def save_networks(self, suffix):
        """BaseModel.save_networks; under --mesh_spatial every rank first
        gathers the pools' frames (rank 0 writes them), so the saved pools
        are the whole frames', which any width resumes."""
        if self.pools is not None and parallel.spatial_size() > 1:
            band = self.band_of(self.opt.crop_size)
            self._pool_frames = {k: spatial.gather_frame(p[0], band)
                                 for k, p in self.pools.items()}
        try:
            super().save_networks(suffix)
        finally:
            self._pool_frames = None

    def extra_train_state(self) -> dict:
        """The pools' generator state and the pools (buffer and count)."""
        state = {"rng": self.rng.get_state()}
        if self.pools is not None:
            frames = self._pool_frames or {k: p[0] for k, p in self.pools.items()}
            state["pools"] = {k: {"images": frames[k].cpu(), "count": p[1].cpu()}
                              for k, p in self.pools.items()}
        return state

    def load_extra_train_state(self, state: dict, suffix) -> None:
        self.rng.set_state(state["rng"])
        if self.pools is not None and "pools" in state:
            pools = {}
            for k, p in state["pools"].items():
                images, band = p["images"], self.band_of(p["images"].shape[2])
                if band is not None:
                    images = images[:, :, band.r0:band.r1]
                pools[k] = (images.to(self.device), p["count"].to(self.device))
            self.pools = pools

    def set_input(self, data: dict):
        """data['A'], data['B']: NHWC float numpy batches, the global batch
        (or its host's rows: ``parallel.global_rows``); in a data-parallel
        run this rank keeps its rows (and the dropout layers draw for the
        global batch), under --mesh_spatial its band of their rows."""
        self.global_n = parallel.global_rows(data)
        data = parallel.shard_rows(data)
        if parallel.world() > 1:
            for n in ("G_A", "G_B"):
                networks.set_dropout_rows(self.nets()[n],
                                          (self.global_n, parallel.rows_in(self.global_n)))
        self.band = self.band_of(data["A"].shape[1])
        if self.band is not None:
            data = {**data, **{k: data[k][:, self.band.r0:self.band.r1] for k in ("A", "B")}}
        self.real_A = to_device_nchw(data["A"], self.device, self.dtype)
        self.real_B = to_device_nchw(data["B"], self.device, self.dtype)
        self.image_paths = data.get("A_paths", [])

    def forward(self):
        """The four translations of the visuals (the JAX package's
        ``_forward_all``; under --mesh_spatial the whole frames, gathered on
        every rank)."""
        fake_B = self.netG_A(self.real_A, self.band)
        fake_A = self.netG_B(self.real_B, self.band)
        visuals = {"real_A": self.real_A, "fake_B": fake_B,
                   "rec_A": self.netG_B(fake_B, self.band), "real_B": self.real_B,
                   "fake_A": fake_A, "rec_B": self.netG_A(fake_A, self.band)}
        if self.band is not None:
            visuals = {k: spatial.gather_frame(v, self.band) for k, v in visuals.items()}
        self._visuals = visuals
