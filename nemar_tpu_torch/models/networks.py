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

Under --mesh_spatial (``parallel/spatial.py``) every generator and
discriminator takes a ``band`` (``spatial.Band``: this rank's rows of the
frame, uneven, one row or empty) and runs its band form: every
convolution over the band with its halo rows (``conv_band``: the rows of
whichever ranks hold them, the layer's padding at the frame's edges;
``conv_band_reflect`` for the ResNet block's reflect-padded ones), every
transposed convolution over the band with a zero halo row above (and
below, the UNet's k4: ``conv_transpose_band``), every norm with the
frame's statistics (``norm_act_band``: K-in's band form on the card, or
batch norm's sums over every rank of the mesh), each dropout mask drawn
for the frame and cut to the band (``Dropout``), the UNet's skips re-cut
to their level's bands (``spatial.reband``); under instance norm without
dropout the ResNet trunk blocks and decoder stages through K-block's and
K-convt's band forms, the head through K-head's whatever the norm, each
trunk block checkpointed under ``--remat`` as in one process. ``gan_loss``
and ``cal_gradient_penalty`` take the band too: the losses' means are the
band's shares, and the penalty differentiates D's band form twice
(``parallel/spatial.py``'s primitives, batch norm's sums and K-in's band
backward are differentiable twice). ``band=None`` is the one-process path,
unchanged.

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
from nemar_tpu_torch.ops.conv_fused import fused_resblock, fused_resblock_band
from nemar_tpu_torch.ops.conv_head import conv_head, conv_head_band
from nemar_tpu_torch.ops.convt_fused import fused_convt_in, fused_convt_in_band
from nemar_tpu_torch.ops.norm import instance_norm_act, instance_norm_act_band
from nemar_tpu_torch.parallel import spatial
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
    (``parallel.sum_over_ranks``), so the backward's sums are global too.
    Under bf16 the sums and the count are taken and summed in fp32, and the
    mean and the variance cast to bf16 once, as the JAX package's
    ``jnp.mean`` reduces (a count such as 2 x 31 x 31 = 1922 is not a bf16
    number); fp32 and float64 sum in their own type."""
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    count = torch.full((1,), x.shape[0] * x.shape[2] * x.shape[3], dtype=acc, device=x.device)
    sums = parallel.sum_over_ranks(torch.cat([x.sum(dim=(0, 2, 3), dtype=acc), count]))
    n = sums[-1]
    mean = (sums[:-1] / n).to(x.dtype)[None, :, None, None]
    dev = x - mean
    var = parallel.sum_over_ranks(torch.square(dev).sum(dim=(0, 2, 3), dtype=acc)) / n
    return dev * torch.rsqrt(var.to(x.dtype)[None, :, None, None] + 1e-5)


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


def norm_act_band(x: torch.Tensor, band, act: str, norm: str = "instance") -> torch.Tensor:
    """``norm_act`` of the frame of which the NCHW x is this rank's band:
    instance norm with the frame's statistics (``instance_norm_act_band``);
    batch norm with the frame's and the global batch's (``batch_norm_global``:
    the sums over every rank of the mesh, each rank's count its band's
    pixels, so an empty band adds nothing and a batch replicated over the
    data ranks counts each copy once a rank, which cancels in the mean);
    or the activation alone."""
    if norm == "instance":
        return to_nchw(instance_norm_act_band(to_nhwc(x), band, act=act))
    if norm == "batch":
        x = batch_norm_global(x)
    elif norm != "none":
        raise NotImplementedError(f"norm {norm!r}")
    return _act(x, act)


def conv_band(conv: nn.Conv2d, x: torch.Tensor, band) -> tuple:
    """``conv`` (zero-padded, square kernel) of the frame of which the NCHW
    x is this rank's band -> (its output band, the output's ``Band``): the
    band with the rows its output band reads above and below, from
    whichever ranks hold them (``Band.conv``; zeros past the frame's
    edges), convolved with the layer's padding in W only. An empty output
    band convolves the rows of the one it would hold next and keeps none
    of it: the rank stays in the graph of its exchange and of the weights,
    so its backward makes the same collectives as the other ranks' and
    gives the weights a gradient (of zeros)."""
    out, tops, bottoms = band.conv(conv.kernel_size[0], conv.stride[0], conv.padding[0])
    xp = spatial.exchange_rows(x, band, tops, bottoms, dim=2, mode="zeros")
    y = F.conv2d(xp, conv.weight, conv.bias, stride=conv.stride, padding=(0, conv.padding[1]))
    return (y if out.rows else y[:, :, :0]), out


def conv_band_reflect(conv: nn.Conv2d, x: torch.Tensor, band, pad: int) -> torch.Tensor:
    """``conv(reflect_pad(x, pad))`` (stride 1, a kernel of 2 pad + 1, no
    padding of its own: the ResNet block's) of the frame of which the NCHW
    x is this rank's band -> its band, the same rows as x's: the band with
    ``pad`` rows above and below from whichever ranks hold them (reflected
    at the frame's edges), reflect-padded in W. An empty band convolves the
    rows of the one it would hold next and keeps none of it, as
    ``conv_band``."""
    out, tops, bottoms = band.conv(conv.kernel_size[0], 1, pad)
    xp = spatial.exchange_rows(x, band, tops, bottoms, dim=2, mode="reflect")
    y = conv(reflect_pad_w(xp, pad).contiguous(memory_format=torch.channels_last))
    return y if out.rows else y[:, :, :0]


def conv_transpose_band(convt: nn.ConvTranspose2d, x: torch.Tensor, band) -> tuple:
    """``convt`` (stride 2: kernel 3 without padding cropped to 2H x 2W, flax's
    'SAME' ConvTranspose, or the UNet's kernel 4 padding 1) of the frame of
    which the NCHW x is this rank's band -> (its output band, ``Band.up``):
    the band with the rows its output reads above (one) and below (none,
    kernel 3; one, kernel 4), zeros past the frame's edges, transposed-
    convolved, and the band's 2 rows an input row kept. Each output row is
    computed once, by its owner, from the rows it reads (no overlapping
    outputs added across ranks); an empty band convolves its halo rows and
    keeps none, so the rank stays in the graph of the exchange."""
    k, p = convt.kernel_size[0], convt.padding[0]
    if convt.stride[0] != 2:
        raise ValueError(f"conv_transpose_band: stride {convt.stride[0]}")
    top, bottom = (k - 1 - p) // 2, (1 + p) // 2
    h, w = x.shape[2], x.shape[3]
    xp = spatial.exchange_rows(x, band, (top,) * band.size, (bottom,) * band.size, dim=2,
                               mode="zeros")
    y = convt(xp.contiguous(memory_format=torch.channels_last))
    # dense, in the one-process output's layout (a dropout draws in it)
    y = y[:, :, 2 * top:2 * top + 2 * h, :2 * w].contiguous(memory_format=torch.channels_last)
    return y, band.up(2)


def _conv1x1_band(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``conv`` of a band, an empty band's too (PyTorch refuses a
    convolution of a tensor without rows: one zero row convolved and
    dropped), in the graph."""
    return conv(x) if x.shape[2] else conv(F.pad(x, (0, 0, 0, 1)))[:, :, :0]


def reflect_pad_w(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``reflect_pad`` in W only (the band forms' H padding is the
    exchange's)."""
    w = x.shape[3]
    return torch.cat([x[:, :, :, 1:pad + 1].flip(3), x, x[:, :, :, w - pad - 1:w - 1].flip(3)],
                     dim=3)


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
    the global batch and sliced, so it is the one-process run's. With
    ``band`` (--mesh_spatial) x is this rank's band of the level's frame:
    the mask is drawn for the whole frame (of the global batch), in the
    one-process layout, and cut to the band's rows, so every rank draws
    the same numbers and advances its generator alike, an empty band too,
    and keeps the one-process mask's rows."""

    def __init__(self, p: float = 0.5, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.rows: tuple | None = None

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        if not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training draws from the model's generator; none is set")
        if self.rows is None and band is None:
            # drawn in x's memory layout, so the result keeps it
            u = torch.empty_like(x)
        else:
            n = x.shape[0] if self.rows is None else self.rows[0]
            h = x.shape[2] if band is None else band.height
            layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                      and not x.is_contiguous() else torch.contiguous_format)
            u = torch.empty((n, x.shape[1], h, x.shape[3]), dtype=x.dtype, device=x.device,
                            memory_format=layout)
        keep = u.uniform_(generator=self.generator) >= self.p
        if self.rows is not None:
            keep = keep[self.rows[1]]
        if band is not None:
            keep = keep[:, :, band.r0:band.r1]
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

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        """The block; with ``band`` that of the frame of which x is this
        rank's band: K-block's band form, or the plain block's (each conv
        over the band with its reflected halo rows, the norms with the
        frame's statistics, the dropout mask the frame's rows)."""
        if self.fused:
            # OIHW -> HWIO, the layout of the JAX op and of the kernel
            w1 = self.Conv_0.weight.permute(2, 3, 1, 0)
            w2 = self.Conv_1.weight.permute(2, 3, 1, 0)
            if band is not None:
                return to_nchw(fused_resblock_band(to_nhwc(x), w1, w2, band))
            return to_nchw(fused_resblock(to_nhwc(x), w1, w2))
        if band is not None:
            h = norm_act_band(conv_band_reflect(self.Conv_0, x, band, 1), band, "relu", self.norm)
            if self.dropout is not None:
                h = self.dropout(h, band)
            return x + norm_act_band(conv_band_reflect(self.Conv_1, h, band, 1), band, "none",
                                     self.norm)
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

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        if band is not None:
            return self._forward_band(x, band)
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

    def _forward_band(self, x: torch.Tensor, band) -> torch.Tensor:
        """The forward of the frame of which x is this rank's band: the same
        layers in band form, each on the band its own geometry gives (the
        stride-2 convs' ``Band.conv``, the decoder's ``Band.up``), the
        decoder's stages K-convt's band form under instance norm, else the
        transposed conv's (``conv_transpose_band``) and the norm's; the
        output re-cut to the input's band (``spatial.reband``: where the
        levels split unevenly the up-sampled bands are not the input's,
        36^2 at s = 2 gives 20 | 16 for 18 | 18)."""
        three = (3,) * band.size
        xp = reflect_pad_w(spatial.exchange_rows(x, band, three, three, dim=2, mode="reflect"), 3)
        h = norm_act_band(self.Conv_0(xp), band, "relu", self.norm)
        b = band
        for i in range(self.n_downsampling):
            h, b = conv_band(getattr(self, f"Conv_{i + 1}"), h, b)
            h = norm_act_band(h, b, "relu", self.norm)
        for i in range(self.n_blocks):
            block = getattr(self, f"ResnetBlock_{i}")
            # --remat: the block's band form run again in the backward, its
            # exchanges and all-gathers with it, in the same order on every
            # rank
            h = (remat(block, h, band=b) if self.use_remat and torch.is_grad_enabled()
                 else block(h, b))
        for i in range(self.n_downsampling):
            convt = getattr(self, f"ConvTranspose_{i}")
            if self.norm == "instance":
                w = convt.weight.permute(2, 3, 0, 1).flip(0, 1)
                h, b = to_nchw(fused_convt_in_band(to_nhwc(h), w, b)), b.up(2)
            else:
                h, b = conv_transpose_band(convt, h, b)
                h = norm_act_band(h, b, "relu", self.norm)
        head = getattr(self, f"Conv_{1 + self.n_downsampling}")
        h = to_nchw(conv_head_band(to_nhwc(h), head.weight.permute(2, 3, 1, 0), b))
        return torch.tanh(spatial.reband(h, b, band) + head.bias[:, None, None])


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

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        """G(x); with ``band`` that of the frame of which x is this rank's
        band (``_forward_band``)."""
        need = 2**self.num_downs
        height = x.shape[2] if band is None else band.height
        if height % need or x.shape[3] % need or min(height, x.shape[3]) < need:
            raise ValueError(
                f"UnetGenerator with num_downs={self.num_downs} needs input "
                f"H/W divisible by and >= {need}, got {height}x{x.shape[3]} "
                f"(use --netG unet_128/unet_256 to match --crop_size)")
        if band is not None:
            return self._forward_band(x, band)
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

    def _forward_band(self, x: torch.Tensor, band) -> torch.Tensor:
        """The forward of the frame of which x is this rank's band: the k4
        s2 p1 convs through ``conv_band``, the transposed ones through
        ``conv_transpose_band`` (each level's bands ``Band.up`` of its
        input's), the norms with the frame's statistics, each dropout mask
        the frame's cut to the band, and before each concatenation the
        up-sampled band re-cut to its skip's (``spatial.reband``: unet_256
        at 256^2 over 2 ranks ends in a level of one row in bands of 1 and
        none, whose up-sampling of 2 | 0 rows meets a skip of 1 | 1); the
        output re-cut to the input's band."""
        skips, h, b = [], x, band
        for i in range(self.num_downs):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            h, b = conv_band(getattr(self, f"Conv_{i}"), h, b)
            if 0 < i < self.num_downs - 1:
                h = norm_act_band(h, b, "none", self.norm)
            skips.append((h, b))
        for j, i in enumerate(reversed(range(self.num_downs))):
            h, b = conv_transpose_band(getattr(self, f"ConvTranspose_{j}"), F.relu(h), b)
            if i > 0:
                h = norm_act_band(h, b, "none", self.norm)
                if self.dropouts is not None and i >= self.num_downs - 3:
                    h = self.dropouts[self.num_downs - 1 - i](h, b)
                skip, sb = skips[i - 1]
                h, b = torch.cat([skip, spatial.reband(h, b, sb)], dim=1), sb
        return torch.tanh(spatial.reband(h, b, band))


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

    def forward(self, x: torch.Tensor, band=None):
        """The patch predictions; with ``band`` those of the frame of which
        x is this rank's band, and their ``Band``: (pred, band) (D's
        stride-1 layers give uneven bands, at 32^2 over 2 ranks bands of 2
        and 1 rows, then 2 and none: ``Band.conv``)."""
        if band is not None:
            h, b = conv_band(self.Conv_0, x, band)
            h = F.leaky_relu(h, 0.2)
            for n in range(1, self.n_layers + 1):
                h, b = conv_band(getattr(self, f"Conv_{n}"), h, b)
                h = norm_act_band(h, b, "leaky_relu", self.norm)
            return conv_band(getattr(self, f"Conv_{self.n_layers + 1}"), h, b)
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

    def forward(self, x: torch.Tensor, band=None):
        """The pixel predictions; with ``band`` those of the frame of which
        x is this rank's band and their ``Band`` (its own: 1x1 convs read no
        halo), (pred, band), as the n-layer D's."""
        if band is not None:
            h = F.leaky_relu(_conv1x1_band(self.Conv_0, x), 0.2)
            h = norm_act_band(_conv1x1_band(self.Conv_1, h), band, "leaky_relu", self.norm)
            return _conv1x1_band(self.Conv_2, h), band
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


def d_pred(net_d: Callable, x: torch.Tensor, band=None) -> tuple:
    """(D's predictions on x, their ``Band``): with ``band`` D's band form
    on this rank's band of x's frame, else D on x and None."""
    return (net_d(x), None) if band is None else net_d(x, band)


def d_preds(net_d: Callable, real: torch.Tensor, fake: torch.Tensor, norm: str,
            band=None) -> tuple:
    """D's predictions (on real, on fake, their ``Band`` or None): one pass
    over [real; fake] where D's norm is per sample, two passes under batch
    norm, whose statistics would otherwise mix real and fake (the JAX NeMAR
    model's ``_d_loss``); with ``band`` D's band passes (``d_pred``)."""
    if norm == "batch":
        (pred_real, pband), (pred_fake, _) = d_pred(net_d, real, band), d_pred(net_d, fake, band)
        return pred_real, pred_fake, pband
    pred, pband = d_pred(net_d, torch.cat([real, fake], dim=0), band)
    return (*torch.chunk(pred, 2, dim=0), pband)


# ---------------------------------------------------------------------------
# GAN objective (reference GANLoss) and per-epoch lr schedules (get_scheduler)
# ---------------------------------------------------------------------------


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_mode: str,
             band=None) -> torch.Tensor:
    """Reference GANLoss: lsgan = MSE against 1/0, vanilla = BCE with logits,
    wgangp = -mean for real, mean for fake. With ``band`` the NCHW pred is
    this rank's band of the frame's predictions: each mean is the band's
    share of the mean over the frame's patches (``spatial.frame_mean``)."""
    def mean(t):
        return torch.mean(t) if band is None else spatial.frame_mean(t, band)

    if gan_mode == "lsgan":
        return mean(torch.square(pred - (1.0 if target_is_real else 0.0)))
    if gan_mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return mean(torch.clamp_min(pred, 0.0) - pred * target
                    + torch.log1p(torch.exp(-torch.abs(pred))))
    if gan_mode == "wgangp":
        return -mean(pred) if target_is_real else mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode!r}")


def cal_gradient_penalty(net_d: nn.Module, real: torch.Tensor, fake: torch.Tensor,
                         alpha: torch.Tensor, constant: float = 1.0,
                         lambda_gp: float = 10.0, band=None) -> torch.Tensor:
    """WGAN-GP penalty, gp_type 'mixed' (the JAX package's
    ``cal_gradient_penalty``): D's input gradient at interp = alpha * real +
    (1 - alpha) * fake, alpha (n, 1, 1, 1) drawn by the caller; returns
    mean((sqrt(sum(grad^2) + 1e-16) - constant)^2) * lambda_gp per sample.

    Under autograd the gradient keeps its graph (``create_graph``), so the
    penalty's backward is a double backward through D: cuDNN's convolutions,
    the leaky ReLUs and K-in's backward (``ops/norm.py``). Without autograd
    it is only a value.

    With ``band`` (--mesh_spatial) real and fake are this rank's band of
    their frames and D runs its band form: the gradient of the band's
    summed predictions reaches every rank's band through the exchanges'
    adjoints (every rank takes it at the same point, so their collectives
    line up), which gives this rank its band of the frame's input gradient;
    the per-sample squared norm is summed over the spatial group
    (``spatial.group_sum``, differentiable), so every rank holds the whole
    penalty."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_()
        pred = d_pred(net_d, interp, band)[0]
        (grad,) = torch.autograd.grad(pred.sum(), interp, create_graph=create_graph)
    sq = torch.sum(torch.square(grad.reshape(real.shape[0], -1)), dim=1)
    if band is not None:
        sq = spatial.group_sum(sq)
    gnorm = torch.sqrt(sq + 1e-16)
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
