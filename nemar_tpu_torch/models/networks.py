"""Generators and discriminators: the ResNet translator T and the PatchGAN D.

Counterpart of ``nemar_tpu/models/networks.py`` (``ResnetBlock``,
``ResnetGenerator``, ``NLayerDiscriminator``, ``define_G``, ``define_D``),
forward only. Module attribute names are the flax parameter names
(``Conv_0``, ``ResnetBlock_3``, ``ConvTranspose_1``, ...), so a state_dict
key reads as the flax tree path it was converted from (``utils/convert.py``).

Activations are NCHW tensors in ``channels_last`` memory. Every instance
norm goes through ``ops.instance_norm_act`` (the Triton kernel K-in on the
card) and every trunk block through ``ops.fused_resblock`` (the CUDA kernel
K-block); plain convolutions outside those are ``nn.Conv2d``.

The JAX package's convolution rewrites for the TPU's lane width
(``--c7_impl s2d|fact|factg|auto``, ``--block_impl xla|pallas``) compute the
same function from the same parameters; here each is the direct convolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nemar_tpu_torch.ops.conv_fused import fused_resblock
from nemar_tpu_torch.ops.norm import instance_norm_act

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
    """ReflectionPad2d, NCHW."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def init_weights(module: nn.Module, init_gain: float, generator: torch.Generator) -> None:
    """Reference init_weights 'normal': conv kernels N(0, init_gain), zero bias.

    The same seed draws other numbers than the JAX package; a trained model
    comes from a checkpoint. (The other init types come with training,
    ROADMAP.md A5.)
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            with torch.no_grad():
                nn.init.normal_(m.weight, 0.0, init_gain, generator=generator)
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
            # utils/convert.py) cropped to [:2H, :2W]
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
            hh, ww = h.shape[2], h.shape[3]
            h = getattr(self, f"ConvTranspose_{i}")(h)[:, :, :2 * hh, :2 * ww]
            h = norm_act(h, "relu")
        h = getattr(self, f"Conv_{1 + self.n_downsampling}")(reflect_pad(h, 3))
        return torch.tanh(h)


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
