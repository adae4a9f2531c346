"""Generators and discriminators, the GAN objective and the lr schedules.

Counterpart of ``nemar_tpu/models/networks.py`` (``ResnetBlock``,
``ResnetGenerator``, ``NLayerDiscriminator``, ``define_G``, ``define_D``,
``_make_init``, ``gan_loss``, ``cal_gradient_penalty``,
``get_lr_multiplier_fn``). Every op is differentiable: the
kernels' wrappers are ``torch.autograd.Function``s with hand-written
backwards on the card. Module attribute names are the flax parameter names
(``Conv_0``, ``ResnetBlock_3``, ``ConvTranspose_1``, ...), so a state_dict
key reads as the flax tree path it was converted from (``utils/convert.py``).

Activations are NCHW tensors in ``channels_last`` memory. In the ResNet
generator every trunk block goes through ``ops.fused_resblock`` (the CUDA
kernel K-block on the card), every decoder stage (ConvTranspose + IN +
relu) through ``ops.fused_convt_in`` (K-convt) and the 7x7 output conv
through ``ops.conv_head`` (K-head) plus its bias; every other instance norm
goes through ``ops.instance_norm_act`` (the CUDA kernel K-in). The
remaining convolutions (G's encoder, D) are ``nn.Conv2d``.

Every shape the JAX package runs goes through those kernels: K-block
masks a sample's last pixel tile (a 48^2 crop's 12^2 trunk) and its wrapper
zero-pads the trunk's channels to a multiple of 128 (``--ngf 16``'s 64);
K-convt's wrapper pads channels to multiples of 4; K-head's launches once
for each 8 output channels (``--output_nc 9``).

The JAX package's convolution rewrites for the TPU
(``--c7_impl s2d|fact|factg|auto|roll``, ``--block_impl
xla|pallas|pallas_all``) compute the same function from the same parameters
in other layouts; here every choice runs the path above.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nemar_tpu_torch.ops.conv_fused import fused_resblock
from nemar_tpu_torch.ops.conv_head import conv_head
from nemar_tpu_torch.ops.convt_fused import fused_convt_in
from nemar_tpu_torch.ops.norm import instance_norm_act
from nemar_tpu_torch.utils.convert import kernel_to_torch

_QUEUED = "queued as ROADMAP.md A9"


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view of its channels_last memory (copies only if
    the memory is not channels_last already)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last memory if x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def norm_act(x: torch.Tensor, act: str) -> torch.Tensor:
    """Instance norm + activation of an NCHW tensor (reference ``_norm_act``)."""
    return to_nchw(instance_norm_act(to_nhwc(x), act=act))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d, NCHW, built from slices, flips and concatenations:
    its backward is deterministic on CUDA, where ReflectionPad2d's scatters
    with float atomics."""
    if pad == 0:
        return x
    h, w = x.shape[2], x.shape[3]
    x = torch.cat([x[:, :, 1:pad + 1].flip(2), x, x[:, :, h - pad - 1:h - 1].flip(2)], dim=2)
    return torch.cat([x[:, :, :, 1:pad + 1].flip(3), x, x[:, :, :, w - pad - 1:w - 1].flip(3)],
                     dim=3)


def _jax_kernel_shape(m: nn.Module) -> tuple:
    """The JAX package's shape of m's kernel: HWIO for a convolution, flax's
    ConvTranspose (kh, kw, in, out), Dense (in, out)."""
    w = m.weight
    if isinstance(m, nn.Conv2d):
        return (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
    if isinstance(m, nn.ConvTranspose2d):
        return (w.shape[2], w.shape[3], w.shape[0], w.shape[1])
    return (w.shape[1], w.shape[0])


def draw_kernel(init_type: str, init_gain: float, shape: tuple,
                generator: torch.Generator) -> torch.Tensor:
    """A kernel of the JAX layout ``shape`` drawn as the JAX package's
    ``_make_init(init_type, init_gain)`` draws it (``nemar_tpu/models/
    networks.py``), the fans taken from that layout (in: all axes but the
    last, out: all but the second last):

      * xavier: flax ``variance_scaling(init_gain^2 * 2, 'fan_avg',
        'truncated_normal')``, a normal truncated at +-2 standard units whose
        stddev is divided by 0.87962566 so that the draw has variance
        2 init_gain^2 / fan_avg (twice ``nn.init.xavier_normal_``'s);
      * kaiming: ``variance_scaling(2.0, 'fan_in', 'normal')``, init_gain
        unused;
      * orthogonal: ``orthogonal(scale=init_gain)`` over the kernel viewed as
        (prod(shape[:-1]), shape[-1]), orthonormal columns (rows where there
        are fewer rows than columns), each sign taken from R's diagonal.

    The same seed draws other numbers than JAX: parity is of the
    distributions."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = receptive * shape[-2], receptive * shape[-1]
    if init_type == "xavier":
        std = math.sqrt(init_gain**2 * 2.0 / ((fan_in + fan_out) / 2)) / 0.87962566103423978
        k = torch.empty(shape)
        nn.init.trunc_normal_(k, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return k * std
    if init_type == "kaiming":
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
    if init_type == "orthogonal":
        rows, cols = math.prod(shape[:-1]), shape[-1]
        a = torch.randn((cols, rows) if rows < cols else (rows, cols), generator=generator,
                        dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (init_gain * q).reshape(shape).float()
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def init_weights(module: nn.Module, init_gain: float, generator: torch.Generator,
                 init_type: str = "normal") -> None:
    """Reference init_weights: every conv, transposed conv and dense kernel
    N(0, init_gain) ('normal', drawn in place) or drawn by ``draw_kernel``
    in the JAX layout and carried as ``utils/convert.py`` carries kernels;
    zero bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            with torch.no_grad():
                if init_type == "normal":
                    nn.init.normal_(m.weight, 0.0, init_gain, generator=generator)
                else:
                    k = draw_kernel(init_type, init_gain, _jax_kernel_shape(m), generator)
                    m.weight.copy_(torch.from_numpy(
                        np.ascontiguousarray(kernel_to_torch(m, k.numpy()))))
                m.bias.zero_()


class ResnetBlock(nn.Module):
    """Reflect-pad conv block with skip, as one fused op (K-block on the
    card). ``Conv_0``/``Conv_1`` keep the reference's parameters; their
    biases are inert through instance norm and the fused op leaves them out."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(dim, dim, 3)
        self.Conv_1 = nn.Conv2d(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # OIHW -> HWIO, the layout of the JAX op and of the kernel
        w1 = self.Conv_0.weight.permute(2, 3, 1, 0)
        w2 = self.Conv_1.weight.permute(2, 3, 1, 0)
        return to_nchw(fused_resblock(to_nhwc(x), w1, w2))


class ResnetGenerator(nn.Module):
    """c7s1-ngf, d(2ngf), d(4ngf), n x ResnetBlock, u(2ngf), u(ngf), c7s1-out, tanh."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2):
        super().__init__()
        self.n_blocks = n_blocks
        self.n_downsampling = n_downsampling
        self.Conv_0 = nn.Conv2d(input_nc, ngf, 7)
        for i in range(n_downsampling):
            mult = 2**i
            setattr(self, f"Conv_{i + 1}",
                    nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1))
        dim = ngf * 2**n_downsampling
        for i in range(n_blocks):
            setattr(self, f"ResnetBlock_{i}", ResnetBlock(dim))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            # flax ConvTranspose(k3, s2, 'SAME') == this (kernel flipped by
            # utils/convert.py) cropped to [:2H, :2W]; its bias is inert
            # through IN and the fused op leaves it out
            setattr(self, f"ConvTranspose_{i}",
                    nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=0))
        setattr(self, f"Conv_{1 + n_downsampling}", nn.Conv2d(ngf, output_nc, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = norm_act(self.Conv_0(reflect_pad(x, 3)), "relu")
        for i in range(self.n_downsampling):
            h = norm_act(getattr(self, f"Conv_{i + 1}")(h), "relu")
        for i in range(self.n_blocks):
            h = getattr(self, f"ResnetBlock_{i}")(h)
        for i in range(self.n_downsampling):
            # (in, out, kh, kw), flipped -> flax's HWIO kernel
            w = getattr(self, f"ConvTranspose_{i}").weight.permute(2, 3, 0, 1).flip(0, 1)
            h = to_nchw(fused_convt_in(to_nhwc(h), w))
        head = getattr(self, f"Conv_{1 + self.n_downsampling}")
        h = to_nchw(conv_head(to_nhwc(h), head.weight.permute(2, 3, 1, 0)))
        return torch.tanh(h + head.bias[:, None, None])


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN: C64-C128-C256-C512, k4, strides 2,2,2,1,1,
    LeakyReLU(0.2), no norm on the first layer."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.Conv_0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        nf_mult = 1
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2**n, 8)
            setattr(self, f"Conv_{n}",
                    nn.Conv2d(ndf * prev, ndf * nf_mult, 4, stride=2, padding=1))
        prev, nf_mult = nf_mult, min(2**n_layers, 8)
        setattr(self, f"Conv_{n_layers}", nn.Conv2d(ndf * prev, ndf * nf_mult, 4, padding=1))
        setattr(self, f"Conv_{n_layers + 1}", nn.Conv2d(ndf * nf_mult, 1, 4, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = norm_act(getattr(self, f"Conv_{n}")(h), "leaky_relu")
        return getattr(self, f"Conv_{self.n_layers + 1}")(h)


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "instance",
             use_dropout: bool = False) -> nn.Module:
    if norm != "instance" or use_dropout:
        raise NotImplementedError(f"generator with norm {norm!r}, dropout {use_dropout}: "
                                  f"not ported yet ({_QUEUED})")
    if netG == "resnet_9blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, 9)
    if netG == "resnet_6blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, 6)
    if netG in ("unet_128", "unet_256"):
        raise NotImplementedError(f"Generator model name [{netG}] is not ported yet "
                                  f"({_QUEUED})")
    raise NotImplementedError(f"Generator model name [{netG}] is not recognized")


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3,
             norm: str = "instance") -> nn.Module:
    if norm != "instance":
        raise NotImplementedError(f"discriminator with norm {norm!r}: not ported yet "
                                  f"({_QUEUED})")
    if netD == "basic":
        return NLayerDiscriminator(input_nc, ndf, 3)
    if netD == "n_layers":
        return NLayerDiscriminator(input_nc, ndf, n_layers_D)
    if netD == "pixel":
        raise NotImplementedError(f"Discriminator model name [{netD}] is not ported yet "
                                  f"({_QUEUED})")
    raise NotImplementedError(f"Discriminator model name [{netD}] is not recognized")


# ---------------------------------------------------------------------------
# GAN objective (reference GANLoss) and per-epoch lr schedules (get_scheduler)
# ---------------------------------------------------------------------------


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_mode: str) -> torch.Tensor:
    """Reference GANLoss: lsgan = MSE against 1/0, vanilla = BCE with logits,
    wgangp = -mean for real, mean for fake."""
    if gan_mode == "lsgan":
        return torch.mean(torch.square(pred - (1.0 if target_is_real else 0.0)))
    if gan_mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return torch.mean(torch.clamp_min(pred, 0.0) - pred * target
                          + torch.log1p(torch.exp(-torch.abs(pred))))
    if gan_mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode!r}")


def cal_gradient_penalty(net_d: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                         alpha: torch.Tensor, constant: float = 1.0,
                         lambda_gp: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty, gp_type 'mixed' (the JAX package's
    ``cal_gradient_penalty``): D's input gradient at interp = alpha * real +
    (1 - alpha) * fake, alpha (n, 1, 1, 1) drawn by the caller; returns
    mean((sqrt(sum(grad^2) + 1e-16) - constant)^2) * lambda_gp per sample.

    Under autograd the gradient keeps its graph (``create_graph``), so the
    penalty's backward is a double backward through D: cuDNN's convolutions,
    the leaky ReLUs and K-in's backward (``ops/norm.py``). Without autograd
    it is only a value."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_()
        (grad,) = torch.autograd.grad(net_d(interp).sum(), interp, create_graph=create_graph)
    gnorm = torch.sqrt(torch.sum(torch.square(grad.reshape(real.shape[0], -1)), dim=1) + 1e-16)
    return torch.mean(torch.square(gnorm - constant)) * lambda_gp


def get_lr_multiplier_fn(opt) -> Callable[[int, float], float]:
    """fn(epoch, metric) -> lr multiplier, stepped once per epoch; the four
    policies of ``nemar_tpu/models/networks.py:get_lr_multiplier_fn``.

    ``epoch`` is the absolute epoch number (it starts at ``epoch_count``),
    which makes 'linear' right for fresh and resumed runs alike. 'plateau'
    keeps ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
    patience=5) state in ``fn.state``.
    """
    policy = getattr(opt, "lr_policy", "linear")
    if policy == "linear":
        n_epochs = getattr(opt, "n_epochs", 100)
        n_decay = getattr(opt, "n_epochs_decay", 100)
        return lambda epoch, metric=None: 1.0 - max(0, epoch + 1 - n_epochs) / float(n_decay + 1)
    if policy == "step":
        iters = getattr(opt, "lr_decay_iters", 50)
        return lambda epoch, metric=None: 0.1 ** (epoch // iters)
    if policy == "cosine":
        total = getattr(opt, "n_epochs", 100) + getattr(opt, "n_epochs_decay", 100)
        return lambda epoch, metric=None: 0.5 * (1.0 + math.cos(math.pi * epoch / total))
    if policy == "plateau":
        state = {"best": float("inf"), "bad": 0, "mult": 1.0}

        def fn(epoch, metric=None):
            if metric is not None:
                if metric < state["best"] * (1 - 0.01):
                    state["best"] = metric
                    state["bad"] = 0
                else:
                    state["bad"] += 1
                    if state["bad"] > 5:
                        state["mult"] *= 0.2
                        state["bad"] = 0
            return state["mult"]

        fn.state = state
        return fn
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
