"""Generators and discriminators, the GAN objective and the lr schedules.

Counterpart of ``nemar_tpu/models/networks.py`` (``_norm_act``,
``ResnetBlock``, ``ResnetGenerator``, ``UnetGenerator``,
``NLayerDiscriminator``, ``PixelDiscriminator``, ``define_G``,
``define_D``, ``_make_init``, ``gan_loss``, ``cal_gradient_penalty``,
``get_lr_multiplier_fn``). Every op is differentiable: the kernels'
wrappers are ``torch.autograd.Function``s with hand-written backwards on
the card. Module attribute names are the flax parameter names (``Conv_0``,
``ResnetBlock_3``, ``ConvTranspose_1``, ...), so a state_dict key reads as
the flax tree path it was converted from (``utils/convert.py``).

Activations are NCHW tensors in ``channels_last`` memory. ``--norm`` is the
JAX package's: ``instance`` (the kernel K-in, ``ops.instance_norm_act``),
``batch`` (per-batch statistics over (N, H, W), eps 1e-5, no affine and no
running statistics, the same in training and at test: the JAX package's
stateless branch, not ``nn.BatchNorm2d``) or ``none`` (the activation
alone). Under instance norm the ResNet generator runs its trunk blocks
through ``ops.fused_resblock`` (K-block on the card) unless it has dropout,
its decoder stages (ConvTranspose + IN + relu) through
``ops.fused_convt_in`` (K-convt); those routes are the JAX package's
predicates on the norm and dropout, so under ``batch`` or ``none`` or with
dropout the block and the decoder are the plain convolutions (cuDNN), with
live biases. The 7x7 output conv runs ``ops.conv_head`` (K-head) plus its
bias whatever the norm. The other convolutions (G's encoder, the UNet, D)
are ``nn.Conv2d`` / ``nn.ConvTranspose2d``.

In a data-parallel run (``nemar_tpu_torch.parallel``) batch norm
normalises over the global batch (``batch_norm_global``: its sums
all-reduced, differentiably) and each dropout layer draws the global
batch's mask and keeps its rank's rows (``set_dropout_rows``), as the JAX
package's SPMD program does, so a run over W ranks computes the
one-process run's function.

Dropout (``Dropout``) draws from a ``torch.Generator`` the model owns,
never from the global one, and is off in eval mode. ``--remat`` checkpoints
each trunk block (``remat``), the counterpart of ``nn.remat(ResnetBlock)``.

Every shape the JAX package runs goes through the kernels: K-block
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

import contextlib
import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nemar_tpu_torch import parallel
from nemar_tpu_torch.ops.conv_fused import fused_resblock
from nemar_tpu_torch.ops.conv_head import conv_head
from nemar_tpu_torch.ops.convt_fused import fused_convt_in
from nemar_tpu_torch.ops.norm import instance_norm_act
from nemar_tpu_torch.utils.convert import kernel_to_torch

def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view of its channels_last memory (copies only if
    the memory is not channels_last already)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last memory if x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, 0.2)
    return x


def batch_norm_local(x: torch.Tensor) -> torch.Tensor:
    """The stateless batch norm over (N, H, W) of this process's rows, in
    the JAX package's two passes (the mean, then the mean squared
    deviation)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def batch_norm_global(x: torch.Tensor) -> torch.Tensor:
    """The same batch norm over the GLOBAL batch of a data-parallel run,
    as the JAX package's mean over a batch sharded on 'data': the two
    passes' sums (and the rows' count, so that a batch replicated on every
    rank normalises as well) summed over the ranks, differentiably
    (``parallel.sum_over_ranks``), so the backward's sums are global too."""
    count = torch.full((1,), x.shape[0] * x.shape[2] * x.shape[3], dtype=x.dtype,
                       device=x.device)
    sums = parallel.sum_over_ranks(torch.cat([x.sum(dim=(0, 2, 3)), count]))
    n = sums[-1]
    mean = (sums[:-1] / n)[None, :, None, None]
    dev = x - mean
    var = parallel.sum_over_ranks(torch.square(dev).sum(dim=(0, 2, 3))) / n
    return dev * torch.rsqrt(var[None, :, None, None] + 1e-5)


def norm_act(x: torch.Tensor, act: str, norm: str = "instance") -> torch.Tensor:
    """Norm + activation of an NCHW tensor (reference ``_norm_act``):
    instance norm through K-in, the stateless batch norm (over the global
    batch when the rows are spread over several ranks), or none."""
    if norm == "instance":
        return to_nchw(instance_norm_act(to_nhwc(x), act=act))
    if norm == "batch":
        x = batch_norm_global(x) if parallel.world() > 1 else batch_norm_local(x)
    elif norm != "none":
        raise NotImplementedError(f"norm {norm!r}")
    return _act(x, act)


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


class Dropout(nn.Module):
    """flax ``nn.Dropout(p)``: in training each value is kept with
    probability 1 - p and scaled by 1 / (1 - p), else 0; the draw comes
    from ``generator`` (on the activations' device), which the model
    sets; in eval mode the identity. ``rows`` (set by the model through
    ``set_dropout_rows`` in a data-parallel run): (n, slice) when x holds
    the rows ``slice`` of a global batch of n; the mask is then drawn for
    the global batch and sliced, so it is the one-process run's."""

    def __init__(self, p: float = 0.5, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.rows: tuple | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training draws from the model's generator; none is set")
        if self.rows is None:
            # drawn in x's memory layout, so the result keeps it
            u = torch.empty_like(x)
        else:
            n, rows = self.rows
            layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                      and not x.is_contiguous() else torch.contiguous_format)
            u = torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device,
                            memory_format=layout)
        keep = u.uniform_(generator=self.generator) >= self.p
        if self.rows is not None:
            keep = keep[self.rows[1]]
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def set_dropout_rows(module: nn.Module, rows: tuple | None) -> None:
    """Give each Dropout under ``module`` the rows its input holds of the
    global batch ((n, slice); None: all of them)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.rows = rows


def dropout_generators(module: nn.Module) -> list:
    """The generators of ``module``'s Dropout layers (one each)."""
    return [m.generator for m in module.modules() if isinstance(m, Dropout)]


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode (dropout off) inside, its mode restored after."""
    was = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was)


def remat(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant), as
    ``nn.remat`` / ``jax.checkpoint``: the forward keeps only the inputs.
    The recomputation draws the same dropout masks: each Dropout generator
    under ``fn`` (when it is a module) is set back to its state at the
    forward and then forward again to where it was. A module is recomputed
    on the tensors its forward read: inside ``torch.func.functional_call``
    (``BaseModel.compute`` under --bf16: the bf16 copies) the backward runs
    after the call has put the module's own parameters back."""
    is_module = isinstance(fn, nn.Module)
    gens = dropout_generators(fn) if is_module else []
    start = [g.get_state() for g in gens]
    tensors = {**dict(fn.named_parameters()), **dict(fn.named_buffers())} if is_module else {}
    calls = [0]

    def again(*a, **k):
        return torch.func.functional_call(fn, tensors, a, k) if is_module else fn(*a, **k)

    def run(*a, **k):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a, **k)
        if not gens:
            return again(*a, **k)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return again(*a, **k)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


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
    """Reflect-pad conv block with skip. Under instance norm without dropout
    it is one fused op (K-block on the card), whose ``Conv_0``/``Conv_1``
    biases are inert through the norm and left out; otherwise the reference's
    reflect-pad conv, norm, relu, dropout, reflect-pad conv, norm and the
    skip, biases live, as the JAX package's XLA branch."""

    def __init__(self, dim: int, norm: str = "instance", use_dropout: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm = norm
        self.fused = norm == "instance" and not use_dropout
        self.Conv_0 = nn.Conv2d(dim, dim, 3)
        self.Conv_1 = nn.Conv2d(dim, dim, 3)
        self.dropout = Dropout(0.5, generator) if use_dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            # OIHW -> HWIO, the layout of the JAX op and of the kernel
            w1 = self.Conv_0.weight.permute(2, 3, 1, 0)
            w2 = self.Conv_1.weight.permute(2, 3, 1, 0)
            return to_nchw(fused_resblock(to_nhwc(x), w1, w2))
        h = norm_act(self.Conv_0(reflect_pad(x, 1)), "relu", self.norm)
        if self.dropout is not None:
            h = self.dropout(h)
        return x + norm_act(self.Conv_1(reflect_pad(h, 1)), "none", self.norm)


class ResnetGenerator(nn.Module):
    """c7s1-ngf, d(2ngf), d(4ngf), n x ResnetBlock, u(2ngf), u(ngf), c7s1-out, tanh."""

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64, n_blocks: int = 9,
                 n_downsampling: int = 2, norm: str = "instance", use_dropout: bool = False,
                 use_remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.n_blocks = n_blocks
        self.n_downsampling = n_downsampling
        self.norm = norm
        self.use_remat = use_remat
        self.Conv_0 = nn.Conv2d(input_nc, ngf, 7)
        for i in range(n_downsampling):
            mult = 2**i
            setattr(self, f"Conv_{i + 1}",
                    nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1))
        dim = ngf * 2**n_downsampling
        for i in range(n_blocks):
            setattr(self, f"ResnetBlock_{i}", ResnetBlock(dim, norm, use_dropout, generator))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            # flax ConvTranspose(k3, s2, 'SAME') == this (kernel flipped by
            # utils/convert.py) cropped to [:2H, :2W]; under instance norm
            # its bias is inert and the fused op leaves it out
            setattr(self, f"ConvTranspose_{i}",
                    nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=0))
        setattr(self, f"Conv_{1 + n_downsampling}", nn.Conv2d(ngf, output_nc, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = norm_act(self.Conv_0(reflect_pad(x, 3)), "relu", self.norm)
        for i in range(self.n_downsampling):
            h = norm_act(getattr(self, f"Conv_{i + 1}")(h), "relu", self.norm)
        for i in range(self.n_blocks):
            block = getattr(self, f"ResnetBlock_{i}")
            h = remat(block, h) if self.use_remat and torch.is_grad_enabled() else block(h)
        for i in range(self.n_downsampling):
            convt = getattr(self, f"ConvTranspose_{i}")
            if self.norm == "instance":
                # (in, out, kh, kw), flipped -> flax's HWIO kernel
                w = convt.weight.permute(2, 3, 0, 1).flip(0, 1)
                h = to_nchw(fused_convt_in(to_nhwc(h), w))
            else:  # flax's 3x3 'SAME' transposed conv: padding 0, cropped
                h = norm_act(convt(h)[:, :, :2 * h.shape[2], :2 * h.shape[3]], "relu", self.norm)
        head = getattr(self, f"Conv_{1 + self.n_downsampling}")
        h = to_nchw(conv_head(to_nhwc(h), head.weight.permute(2, 3, 1, 0)))
        return torch.tanh(h + head.bias[:, None, None])


class UnetGenerator(nn.Module):
    """The reference's UNet (``UnetSkipConnectionBlock`` nest) as the JAX
    package's flat form: ``num_downs`` k4 s2 p1 convs down (``Conv_i``;
    LeakyReLU(0.2) before each but the first, norm after each but the first
    and the innermost; channels ngf * 2^i capped at 8 ngf), then back up
    (``ConvTranspose_j``, j = 0 the innermost): ReLU, ConvTranspose k4 s2,
    and at every level but the outermost norm, dropout on the three
    innermost levels, and the concatenation [skip, h]; tanh at the end."""

    def __init__(self, input_nc: int, output_nc: int = 3, num_downs: int = 8, ngf: int = 64,
                 norm: str = "instance", use_dropout: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_downs = num_downs
        self.norm = norm
        chans = [min(ngf * 2**i, ngf * 8) for i in range(num_downs)]
        prev = input_nc
        for i, ch in enumerate(chans):
            setattr(self, f"Conv_{i}", nn.Conv2d(prev, ch, 4, stride=2, padding=1))
            prev = ch
        # level i's transposed conv reads the inner level's output (with its
        # skip concatenated below the innermost)
        for j, i in enumerate(reversed(range(num_downs))):
            cin = chans[i] if i == num_downs - 1 else 2 * chans[i]
            cout = output_nc if i == 0 else chans[i - 1]
            setattr(self, f"ConvTranspose_{j}", nn.ConvTranspose2d(cin, cout, 4, stride=2,
                                                                   padding=1))
        self.dropouts = nn.ModuleList(Dropout(0.5, generator) for _ in range(3)) \
            if use_dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        need = 2**self.num_downs
        if x.shape[2] % need or x.shape[3] % need or min(x.shape[2], x.shape[3]) < need:
            raise ValueError(
                f"UnetGenerator with num_downs={self.num_downs} needs input "
                f"H/W divisible by and >= {need}, got {x.shape[2]}x{x.shape[3]} "
                f"(use --netG unet_128/unet_256 to match --crop_size)")
        skips, h = [], x
        for i in range(self.num_downs):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"Conv_{i}")(h)
            if 0 < i < self.num_downs - 1:
                h = norm_act(h, "none", self.norm)
            skips.append(h)
        for j, i in enumerate(reversed(range(self.num_downs))):
            h = getattr(self, f"ConvTranspose_{j}")(F.relu(h))
            if i > 0:
                h = norm_act(h, "none", self.norm)
                if self.dropouts is not None and i >= self.num_downs - 3:
                    h = self.dropouts[self.num_downs - 1 - i](h)
                h = torch.cat([skips[i - 1], h], dim=1)
        return torch.tanh(h)


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN: C64-C128-C256-C512, k4, strides 2,2,2,1,1,
    LeakyReLU(0.2), no norm on the first layer."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, norm: str = "instance"):
        super().__init__()
        self.n_layers = n_layers
        self.norm = norm
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
            h = norm_act(getattr(self, f"Conv_{n}")(h), "leaky_relu", self.norm)
        return getattr(self, f"Conv_{self.n_layers + 1}")(h)


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN: 1x1 convs ndf, 2 ndf (normed), 1; LeakyReLU(0.2)."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.Conv_0 = nn.Conv2d(input_nc, ndf, 1)
        self.Conv_1 = nn.Conv2d(ndf, ndf * 2, 1)
        self.Conv_2 = nn.Conv2d(ndf * 2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Conv_0(x), 0.2)
        h = norm_act(self.Conv_1(h), "leaky_relu", self.norm)
        return self.Conv_2(h)


def _check_norm(norm: str) -> None:
    if norm not in ("instance", "batch", "none"):
        raise NotImplementedError(f"norm {norm!r}")


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "instance",
             use_dropout: bool = False, use_remat: bool = False,
             generator: torch.Generator | None = None) -> nn.Module:
    """The JAX package's ``define_G``; ``generator`` feeds the dropout
    layers (``use_dropout``), ``use_remat`` checkpoints the ResNet trunk's
    blocks (the UNet takes none, as in JAX)."""
    _check_norm(norm)
    if netG == "resnet_9blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, 9, 2, norm, use_dropout, use_remat,
                               generator)
    if netG == "resnet_6blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, 6, 2, norm, use_dropout, use_remat,
                               generator)
    if netG == "unet_128":
        return UnetGenerator(input_nc, output_nc, 7, ngf, norm, use_dropout, generator)
    if netG == "unet_256":
        return UnetGenerator(input_nc, output_nc, 8, ngf, norm, use_dropout, generator)
    raise NotImplementedError(f"Generator model name [{netG}] is not recognized")


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3,
             norm: str = "instance") -> nn.Module:
    _check_norm(norm)
    if netD == "basic":
        return NLayerDiscriminator(input_nc, ndf, 3, norm)
    if netD == "n_layers":
        return NLayerDiscriminator(input_nc, ndf, n_layers_D, norm)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm)
    raise NotImplementedError(f"Discriminator model name [{netD}] is not recognized")


def d_preds(net_d: Callable, real: torch.Tensor, fake: torch.Tensor, norm: str) -> tuple:
    """D's predictions (on real, on fake): one pass over [real; fake] where
    D's norm is per sample, two passes under batch norm, whose statistics
    would otherwise mix real and fake (the JAX NeMAR model's ``_d_loss``)."""
    if norm == "batch":
        return net_d(real), net_d(fake)
    return torch.chunk(net_d(torch.cat([real, fake], dim=0)), 2, dim=0)


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
