"""The fused ResNet trunk block, forward:

    out = x + IN(conv3x3_reflect(relu(IN(conv3x3_reflect(x, W1))), W2))

NHWC activations and HWIO weights, as ``nemar_tpu/ops/conv_fused.py:
fused_resblock``. Instance norm per (n, c), biased variance, no affine; the
conv biases are left out because IN makes them inert (the model keeps them
as parameters, for checkpoint compatibility).

``fused_resblock`` is a ``torch.autograd.Function`` that dispatches on the
device. A CPU tensor takes ``resblock_plain`` (reflect pad + ``F.conv2d`` +
IN, the math of the JAX package's ``resblock_reference``) forward and
``resblock_bwd_plain`` (the VJP written out, as the JAX kernels compute
it) backward. A CUDA tensor launches the CUDA kernels K-block
(``csrc/resblock_fwd.cu``, replacing the TPU kernel ``_fwd_pallas``) and
K-block-bwd (``csrc/resblock_bwd.cu``, replacing ``_bwd_pallas_kstack`` and
``_bwd_pallas``); the forward saves y1, y2 and the IN statistics the
backward needs. The kernels compute the convolutions in their own bodies:
no cuDNN, cuBLAS or ``F.conv2d`` on that path. The conv biases get no
gradient (they are inert through IN and no inputs here).

The kernels take any H, W >= 2 (a sample's last pixel tile is masked) and
C a multiple of 128, their GEMM tiles' width. Other channel counts (the
64-channel trunk of ``--ngf 16``) are zero-padded to the next multiple of
128 around the launch (``block_fwd_padded``, ``block_bwd_padded``): a zero
channel stays zero through both convs and both instance norms, and its
gradient is dropped.

Under ``--bf16`` x, w1 and w2 are bfloat16, as the JAX kernels take them
(``nemar_tpu/ops/conv_fused.py:_fwd_kernel``, ``_bwd2_kernel_kstack``,
``_bwd1_kernel_kstack``), and every sum is fp32. The bf16 variants of
K-block and K-block-bwd (one bf16 MMA a product on the bf16 core,
``csrc/gemm_tc.cuh``: warp-specialised, persistent, an mbarrier ring fed
by TMA boxes of reflect-padded copies of their sources, one slice's MMAs in
flight) and the plain versions at bf16 round where the JAX
kernels round: forward, y1hat and h1 = relu(y1hat) (conv2's operand) and
out to bf16, the statistics fp32; backward, dz2, dh1 = fold(dpad2), dz1 and
dx to bf16 and dw1, dw2 to the weights' type. The plain versions upcast the
bf16 operands to fp32 (exact), convolve, accumulate and normalise in fp32,
and round at those points. The forward saves (y1hat, h1, y2, stats), y2 in
fp32 (the JAX kernel's stage B2 recomputes y2hat from its bf16 out and x
instead; from y2 the backward keeps IN2's input exact). One wrapper
launches either variant by x's type (``fused_resblock_cuda``,
``resblock_bwd_cuda``) and counts each on its own (``.launches``,
``.launches_bf16``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.norm import instance_norm_stats, normalise

# K-block-bwd's instance-norm partials (pixels of one sample), and the
# GEMM tiles' width in channels, which C must fill
_BM, _BN = 64, 128
# K-block-bwd's weight gradients are split-K GEMMs of (9C / 128) x (C / 128)
# tiles: split into as many pixel ranges as fill three waves of one block
# (its shared memory's and registers' budget) on each of the H100's 132 SMs
_WGRAD_SLOTS = 3 * 132


def wgrad_splits(n: int, h: int, w: int, c: int, bk: int = 32) -> int:
    """Pixel ranges K-block-bwd splits each weight gradient's reduction into
    (K slices of ``bk`` pixels, 32 in fp32 and 64 in the bf16 variant, at
    least one per range)."""
    tiles = (9 * c // 128) * (c // 128)
    return max(1, min(n * -(-h * w // bk), _WGRAD_SLOTS // tiles))


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC conv over a reflect-padded x, no bias."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def resblock_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``fused_resblock`` (any device)."""
    return resblock_fwd_plain(x, w1, w2, eps)[0]


def _in_bwd(g: torch.Tensor, yhat: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """d z of z -> IN(z): rstd * (g - mean(g) - yhat * mean(g * yhat))."""
    m1 = g.mean(dim=(1, 2), keepdim=True)
    m2 = (g * yhat).mean(dim=(1, 2), keepdim=True)
    return rstd * (g - m1 - yhat * m2)


def conv_wgrad_plain(src: torch.Tensor, dz: torch.Tensor, k: int = 3) -> torch.Tensor:
    """dW[dy, dx] = pad(src)[p + (dy, dx)]^T @ dz[p], summed over pixels, for
    a k x k conv over the reflect-padded NHWC src; HWIO."""
    n, h, w, c = src.shape
    sp = F.pad(src.permute(0, 3, 1, 2), (k // 2,) * 4, mode="reflect").permute(0, 2, 3, 1)
    dzf = dz.reshape(-1, dz.shape[-1])
    return torch.stack([torch.stack([
        sp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c).T @ dzf for dx in range(k)])
        for dy in range(k)])


def conv_adjoint_plain(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gradient of the padded input (N, H+k-1, W+k-1, C_in) of a k x k conv
    with HWIO w: each tap scatters dz @ W[dy, dx]^T back to the rows and
    columns it read."""
    k = w.shape[0]
    n, h, wd, _ = dz.shape
    dpad = dz.new_zeros((n, h + k - 1, wd + k - 1, w.shape[2]))
    for dy in range(k):
        for dx in range(k):
            dpad[:, dy:dy + h, dx:dx + wd, :] += dz @ w[dy, dx].T
    return dpad


def reflect_pad_adjoint(dpad: torch.Tensor, pad: int) -> torch.Tensor:
    """Gradient of x from the gradient of reflect_pad(x, pad), NHWC: each
    padded row, then each padded column, is added to the one it reflects
    (padded index a < pad copies source pad - a; index pad + H + k copies
    H - 2 - k), as ``nemar_tpu/ops/conv_fused.py:_pad_adjoint`` folds pad 1."""
    d = dpad.clone()
    h, w = d.shape[1] - 2 * pad, d.shape[2] - 2 * pad
    for a in range(pad):
        d[:, 2 * pad - a] += d[:, a]
        d[:, pad + h - 2 - a] += d[:, pad + h + a]
    d = d[:, pad:pad + h]
    for a in range(pad):
        d[:, :, 2 * pad - a] += d[:, :, a]
        d[:, :, pad + w - 2 - a] += d[:, :, pad + w + a]
    return d[:, :, pad:pad + w]


def resblock_fwd_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       eps: float = 1e-5, work: torch.dtype = torch.float32) -> tuple:
    """Plain version of everything K-block returns: (out, y1, y2, stats),
    the conv outputs before IN and stats (N, 4, C) = (mu1, rstd1, mu2, rstd2);
    for bf16 x, w1, w2 that of the bf16 variant, (out, y1hat, h1, y2, stats),
    computed in ``work`` (float64: a reference with the variant's roundings)."""
    if x.dtype == torch.bfloat16:
        return _resblock_fwd_plain_bf16(x, w1, w2, eps, work)
    y1 = conv3x3_reflect(x, w1)
    st1 = instance_norm_stats(y1, eps)
    y2 = conv3x3_reflect(torch.clamp_min(normalise(y1, st1), 0.0), w2)
    st2 = instance_norm_stats(y2, eps)
    # y1, y2 NHWC-contiguous, as K-block writes them
    return x + normalise(y2, st2), y1.contiguous(), y2.contiguous(), torch.cat([st1, st2], dim=1)


def _resblock_fwd_plain_bf16(x, w1, w2, eps, work):
    """``resblock_fwd_plain`` at bf16: convolutions of the exact ``work``
    (fp32) copies, statistics in ``work``, bf16 y1hat, h1 and out."""
    xf = x.to(work)
    y1 = conv3x3_reflect(xf, w1.to(work))
    st1 = instance_norm_stats(y1, eps)
    y1hat = normalise(y1, st1)
    h1 = torch.clamp_min(y1hat, 0.0).to(torch.bfloat16)
    y2 = conv3x3_reflect(h1.to(work), w2.to(work))
    st2 = instance_norm_stats(y2, eps)
    out = (xf + normalise(y2, st2)).to(torch.bfloat16)
    return (out, y1hat.to(torch.bfloat16).contiguous(), h1.contiguous(), y2.contiguous(),
            torch.cat([st1, st2], dim=1))


def _resblock_bwd_plain_bf16(x, w1, w2, g, y1hat, h1, y2, stats, work):
    """``resblock_bwd_plain`` at bf16, in ``work`` (fp32) from the exact
    copies, rounding dz2, dh1, dz1, dx, dw1 and dw2 to bf16 where K-block-bwd's
    bf16 variant stores them."""
    bf = torch.bfloat16
    y2, stats = y2.to(work), stats.to(work)
    dz2 = _in_bwd(g.to(work), normalise(y2, stats[:, 2:4]), stats[:, None, None, 3]).to(bf)
    dw2 = conv_wgrad_plain(h1.to(work), dz2.to(work))
    dh1 = reflect_pad_adjoint(conv_adjoint_plain(dz2.to(work), w2.to(work)), 1).to(bf)
    y1h = y1hat.to(work)
    dz1 = _in_bwd(torch.where(y1h > 0, dh1.to(work), 0.0), y1h, stats[:, None, None, 1]).to(bf)
    dw1 = conv_wgrad_plain(x.to(work), dz1.to(work))
    dx = g.to(work) + reflect_pad_adjoint(conv_adjoint_plain(dz1.to(work), w1.to(work)), 1)
    return dx.to(bf), dw1.to(w1.dtype), dw2.to(w2.dtype)


def resblock_bwd_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-5, saved: tuple | None = None,
                       work: torch.dtype = torch.float32) -> tuple:
    """Plain version of K-block-bwd: (dx, dw1, dw2) of ``fused_resblock``
    given g = d out, written out (no autograd): IN2's backward, conv2's
    weight gradient and input adjoint with the reflect-pad fold, relu, IN1's
    backward, and conv1's. ``saved`` = (y1, y2, stats) of the forward, as
    K-block-bwd takes them ((y1hat, h1, y2, stats) at bf16, the backward
    then computed in ``work``); recomputed when None."""
    if saved is None:
        saved = resblock_fwd_plain(x, w1, w2, eps, work)[1:]
    if x.dtype == torch.bfloat16:
        return _resblock_bwd_plain_bf16(x, w1, w2, g, *saved, work)
    y1, y2, stats = saved
    y1h = normalise(y1, stats[:, 0:2])
    h1 = torch.clamp_min(y1h, 0.0)
    dz2 = _in_bwd(g, normalise(y2, stats[:, 2:4]), stats[:, None, None, 3])
    dw2 = conv_wgrad_plain(h1, dz2)
    dh1 = reflect_pad_adjoint(conv_adjoint_plain(dz2, w2), 1)
    dz1 = _in_bwd(torch.where(y1h > 0, dh1, 0.0), y1h, stats[:, None, None, 1])
    dw1 = conv_wgrad_plain(x, dz1)
    dx = g + reflect_pad_adjoint(conv_adjoint_plain(dz1, w1), 1)
    return dx, dw1, dw2


def block_kernel_supported(shape) -> bool:
    """Shapes K-block and K-block-bwd take: C % 128 == 0, H and W >= 2."""
    n, h, w, c = shape
    return c % _BN == 0 and h >= 2 and w >= 2


def _check_cuda(what: str, x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                band: bool = False) -> None:
    """``band``: x is a band (--mesh_spatial) of any rows, one or none
    included, its H padding the exchange's."""
    if not (x.is_cuda and w1.device == x.device and w2.device == x.device):
        raise ValueError(f"{what}: x, w1, w2 must be on one CUDA device")
    if not (x.dtype == w1.dtype == w2.dtype and x.dtype in (torch.float32, torch.bfloat16)):
        raise TypeError(f"{what}: x, w1, w2 are {x.dtype}, {w1.dtype}, {w2.dtype}; the kernel "
                        f"takes float32 (bfloat16: its bf16 variant) for all three")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be NHWC-contiguous")
    n, h, w, c = x.shape
    if tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"{what}: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not (3, 3, {c}, {c})")
    if not block_kernel_supported((n, 2, w, c) if band else x.shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)} not supported "
                         f"(needs C % {_BN} == 0, H, W >= 2)")


def _aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")


def fused_resblock_cuda(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        eps: float = 1e-5) -> tuple:
    """Launch K-block, or its bf16 variant for bf16 x, w1, w2 (each counted
    on its own: ``.launches``, ``.launches_bf16``). x (N, H, W, C)
    NHWC-contiguous on a CUDA device; w1, w2 (3, 3, C, C) HWIO (made
    contiguous here). Returns (out, *saved), out of x's type, saved what
    K-block-bwd takes: fp32, (y1, y2, stats), the conv outputs before IN and
    stats (N, 4, C) = (mu1, rstd1, mu2, rstd2); bf16, (y1hat, h1, y2,
    stats), y1hat and h1 = relu(y1hat) bf16, y2 and stats fp32."""
    _check_cuda("fused_resblock_cuda", x, w1, w2)
    w1, w2 = w1.contiguous(), w2.contiguous()
    _aligned("fused_resblock_cuda", x, w1, w2)
    n, h, w, c = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    y1, y2 = torch.empty((n, h, w, c), **f32), torch.empty((n, h, w, c), **f32)
    out = torch.empty_like(x)
    # per 128-pixel tile of a sample, its per-channel (mean, M2)
    part = torch.empty((n * -(-h * w // 128), 2, c), **f32)
    stats = torch.empty((n, 4, c), **f32)
    if x.dtype == torch.bfloat16:
        # W1^T, W2^T per tap (tap, C_out, C_in); x's and h1's reflect-padded
        # copies, the convolutions' TMA sources
        wt = torch.empty((2, 9, c, c), dtype=torch.bfloat16, device=x.device)
        pads = torch.empty((2, n, h + 2, w + 2, c), dtype=torch.bfloat16, device=x.device)
        y1hat, h1 = torch.empty_like(x), torch.empty_like(x)
        _build.op("resblock_fwd_bf16")(x, w1, w2, wt, pads, y1, y1hat, h1, y2, part, stats, out,
                                       eps)
        fused_resblock_cuda.launches_bf16 += 1
        return out, y1hat, h1, y2, stats
    # W1^T, W2^T per tap, split into TF32 big and small parts
    wsplit = torch.empty((4, 9, c, c), **f32)
    _build.op("resblock_fwd")(x, w1, w2, wsplit, y1, y2, part, stats, out, eps)
    fused_resblock_cuda.launches += 1
    return out, y1, y2, stats


fused_resblock_cuda.launches = 0
fused_resblock_cuda.launches_bf16 = 0


def resblock_bwd_cuda(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *saved_g) -> tuple:
    """Launch K-block-bwd, or its bf16 variant for bf16 x (counted as
    ``fused_resblock_cuda``'s): (dx, dw1, dw2), of x's type, of
    ``fused_resblock`` given K-block's saved values as
    ``fused_resblock_cuda`` returns them, then g = d out (x's type). Same
    layouts and shape rules as ``fused_resblock_cuda``; dw1, dw2 are HWIO."""
    _check_cuda("resblock_bwd_cuda", x, w1, w2)
    *saved, g = saved_g
    n, h, w, c = x.shape
    bf = x.dtype == torch.bfloat16
    names = ("y1hat", "h1", "y2") if bf else ("y1", "y2")
    if len(saved) != len(names) + 1:
        raise TypeError(f"resblock_bwd_cuda: takes x, w1, w2, {', '.join(names)}, stats, g "
                        f"for {x.dtype} x")
    *acts, stats = saved
    for name, t in (*zip(names, acts), ("g", g)):
        dt = torch.float32 if name in ("y1", "y2") else x.dtype
        if t.shape != x.shape or t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"resblock_bwd_cuda: {name} must be a contiguous {dt} tensor of "
                             f"x's shape {tuple(x.shape)} and device")
    if tuple(stats.shape) != (n, 4, c) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError(f"resblock_bwd_cuda: stats {tuple(stats.shape)} {stats.dtype} is not "
                         f"fp32 ({n}, 4, {c})")
    if n * (h + 2) * (w + 2) * c >= 2**31:
        raise ValueError(f"resblock_bwd_cuda: {tuple(x.shape)} is too large for 32-bit offsets")
    # HWIO as they are: the dgrads read W[tap][ci][co] K-major (along co)
    w1, w2 = w1.contiguous(), w2.contiguous()
    # the bf16 variant's weight gradients take K slices of 64 pixels
    splits = wgrad_splits(n, h, w, c, 64 if bf else 32)
    f32 = dict(dtype=torch.float32, device=x.device)
    dz = torch.empty_like(x)
    # the gradient of the reflect-padded input, written by each dgrad
    dpad = torch.empty((n, h + 2, w + 2, c), **f32)
    dx = torch.empty_like(x)
    part_in = torch.empty((n * -(-h * w // _BM), 2, c), **f32)
    means = torch.empty((n, 2, c), **f32)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    _aligned("resblock_bwd_cuda", x, *saved, g, w1, w2)
    if bf:
        # x's and h1's reflect-padded copies, the weight gradients' TMA
        # sources; dW1's and dW2's partials, summed in one last launch
        pads = torch.empty((2, n, h + 2, w + 2, c), dtype=torch.bfloat16, device=x.device)
        part_w = torch.empty((2, splits, 9 * c, c), **f32)
        _build.op("resblock_bwd_bf16")(x, *saved, g, w1, w2, pads, dz, dpad, part_in, means,
                                       part_w, dw1, dw2, dx, splits)
        resblock_bwd_cuda.launches_bf16 += 1
    else:
        # W1, W2 split into TF32 big and small parts for the dgrads
        wsplit = torch.empty((4, 9 * c, c), **f32)
        part_w = torch.empty((splits, 9 * c, c), **f32)
        _build.op("resblock_bwd")(x, *saved, g, w1, w2, wsplit, dz, dpad, part_in, means,
                                  part_w, dw1, dw2, dx, splits)
        resblock_bwd_cuda.launches += 1
    return dx, dw1, dw2


resblock_bwd_cuda.launches = 0
resblock_bwd_cuda.launches_bf16 = 0


def block_fwd_padded(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     eps: float = 1e-5) -> tuple:
    """K-block at any channel count: C zero-padded to a multiple of 128 (x's
    channels, both weights' in and out), the output cut back to C. Returns
    (out, saved): saved = the padded (x, w1, w2) and K-block's (y1, y2,
    stats), or the bf16 variant's (y1hat, h1, y2, stats) for bf16 x, which
    ``block_bwd_padded`` takes."""
    c = x.shape[3]
    pad = -c % _BN
    if pad:
        x = F.pad(x, (0, pad))
        w1, w2 = F.pad(w1, (0, pad, 0, pad)), F.pad(w2, (0, pad, 0, pad))
    out, *saved = fused_resblock_cuda(x, w1, w2, eps)
    return (out[..., :c].contiguous() if pad else out), (x, w1, w2, *saved)


def block_bwd_padded(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *saved_g) -> tuple:
    """K-block-bwd (its bf16 variant for bf16 x) on ``block_fwd_padded``'s
    saved values, then g = d out of the C channels the caller sees, last:
    (dx, dw1, dw2) cut back to C."""
    *saved, g = saved_g
    c = g.shape[3]
    pad = x.shape[3] - c
    if pad:
        g = F.pad(g, (0, pad))
    dx, dw1, dw2 = resblock_bwd_cuda(x, w1, w2, *saved, g.contiguous())
    if pad:
        dx, dw1, dw2 = dx[..., :c], dw1[:, :, :c, :c], dw2[:, :, :c, :c]
    return dx, dw1, dw2


class _FusedResblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, eps):
        ctx.eps = eps
        if not x.dtype == w1.dtype == w2.dtype:
            raise TypeError(f"fused_resblock: x, w1, w2 are {x.dtype}, {w1.dtype}, "
                            f"{w2.dtype}: one type for all three")
        if x.is_cuda:
            out, saved = block_fwd_padded(x, w1, w2, eps)
            ctx.save_for_backward(*saved)
        else:
            out = resblock_plain(x, w1, w2, eps)
            ctx.save_for_backward(x, w1, w2)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if g.is_cuda:
            dx, dw1, dw2 = block_bwd_padded(*ctx.saved_tensors, g)
        else:
            x, w1, w2 = ctx.saved_tensors
            dx, dw1, dw2 = resblock_bwd_plain(x, w1, w2, g, ctx.eps)
        return dx, dw1, dw2, None


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """out = x + IN(conv3x3r(relu(IN(conv3x3r(x, w1))), w2)); NHWC x, HWIO w.
    Differentiable in x, w1 and w2, which are fp32 (float64 on the CPU) or
    all three bf16."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    return _FusedResblock.apply(x, w1, w2, eps)


# ---------------------------------------------------------------------------
# band form (--mesh_spatial): the block over the rows of the frame that this
# rank holds (``parallel/spatial.py``), the frame's statistics and the
# reflection at the frame's edges
# ---------------------------------------------------------------------------
def pad_tiles(part: torch.Tensor, groups: int, most: int) -> torch.Tensor:
    """A band form's tile partials (groups * tiles, 2, C), each group's tiles
    padded with zeros to ``most`` (the largest band's count), so that every
    rank's partials all-gather in one shape (uneven, one-row and empty
    bands); unchanged when they already have it."""
    tiles = part.shape[0] // groups
    if tiles == most:
        return part
    out = part.new_zeros((groups, most) + tuple(part.shape[1:]))
    out[:, :tiles] = part.view((groups, tiles) + tuple(part.shape[1:]))
    return out.view((groups * most,) + tuple(part.shape[1:]))


def conv3x3_wreflect(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC xp whose H rows are already padded (by 1 each side), HWIO w ->
    the 3x3 conv over xp reflect-padded in W only: H - 2 output rows (an
    empty band's none: a zero row's output, dropped, which keeps it in the
    graph)."""
    xq = F.pad(xp.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="reflect")
    rows = xq.shape[2] - 2
    if rows == 0:
        xq = F.pad(xq, (0, 0, 0, 1))
    return F.conv2d(xq, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)[:, :rows]


def resblock_band_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, band,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``fused_resblock_band`` (any device, differentiable):
    the halo row of x above and below (the frame's reflection at its
    edges), conv1, the frame's IN + relu, the halo rows of h1, conv2, the
    frame's IN, the residual; by autograd, or at bf16 the bf16 variant's
    roundings forward and backward (``_ResblockBandBf16``)."""
    from nemar_tpu_torch.ops.norm import instance_norm_act_band
    from nemar_tpu_torch.parallel import spatial

    if x.dtype == torch.bfloat16:
        return _ResblockBandBf16.apply(x, w1, w2, band, eps)
    one = (1,) * band.size
    xp = spatial.exchange_rows(x, band, one, one, dim=1, mode="reflect")
    h1 = instance_norm_act_band(conv3x3_wreflect(xp, w1), band, "relu", eps, plain=True)
    hp = spatial.exchange_rows(h1, band, one, one, dim=1, mode="reflect")
    return x + instance_norm_act_band(conv3x3_wreflect(hp, w2), band, "none", eps, plain=True)


def resblock_band_saved_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, band,
                              eps: float = 1e-5) -> tuple:
    """Plain version of what K-block's band form saves for its backward,
    (xp, y1, y1p, y2, stats), or at bf16 (xp, y1hat, h1p, y2, stats), from
    ``resblock_band_plain``'s values (no gradient): a check feeds them to
    K-block-bwd's band form, so that the kernel and the plain backward take
    the same relu masks."""
    from nemar_tpu_torch.ops.norm import in_band_stats
    from nemar_tpu_torch.parallel import spatial

    if x.dtype == torch.bfloat16:
        return resblock_band_fwd_plain_bf16(x, w1, w2, band, eps)[1]
    one = (1,) * band.size
    with torch.no_grad():
        xp = spatial.exchange_rows(x, band, one, one, dim=1, mode="reflect")
        y1 = conv3x3_wreflect(xp, w1).contiguous()
        st1 = in_band_stats(y1, eps)
        y1p = spatial.exchange_rows(y1, band, one, one, dim=1, mode="reflect").contiguous()
        y2 = conv3x3_wreflect(torch.clamp_min(normalise(y1p, st1), 0.0), w2).contiguous()
        return xp.contiguous(), y1, y1p, y2, torch.cat([st1, in_band_stats(y2, eps)], dim=1)


def resblock_band_fwd_plain_bf16(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, band,
                                 eps: float = 1e-5) -> tuple:
    """Plain version of K-block's bf16 band form, rounded where
    ``_resblock_fwd_plain_bf16`` rounds (y1hat, h1, out bf16; the
    convolutions of the exact fp32 copies, the frame's statistics fp32):
    -> (out, (xp, y1hat, h1p, y2, stats)), h1p h1 with its halo rows (the
    bf16 rows the ranks exchange), what ``resblock_band_bwd_plain_bf16``
    and K-block-bwd's bf16 band form take."""
    from nemar_tpu_torch.ops.norm import in_band_stats
    from nemar_tpu_torch.parallel import spatial

    one = (1,) * band.size
    with torch.no_grad():
        xp = spatial.exchange_rows(x, band, one, one, dim=1, mode="reflect").contiguous()
        y1 = conv3x3_wreflect(xp.float(), w1.float())
        st1 = in_band_stats(y1, eps)
        y1hat = normalise(y1, st1).to(torch.bfloat16).contiguous()
        h1 = torch.clamp_min(y1hat, 0.0)
        h1p = spatial.exchange_rows(h1, band, one, one, dim=1, mode="reflect").contiguous()
        y2 = conv3x3_wreflect(h1p.float(), w2.float()).contiguous()
        st2 = in_band_stats(y2, eps)
        out = (x.float() + normalise(y2, st2)).to(torch.bfloat16)
    return out, (xp, y1hat, h1p, y2, torch.cat([st1, st2], dim=1))


def _wgrad_hp(srcp: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """``conv_wgrad_plain`` over a source whose H rows are already padded
    (N, H + 2, W, C): only W reflected; HWIO."""
    n, hp, w, c = srcp.shape
    sp = F.pad(srcp.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="reflect").permute(0, 2, 3, 1)
    dzf = dz.reshape(-1, dz.shape[-1])
    return torch.stack([torch.stack([
        sp[:, dy:dy + hp - 2, dx:dx + w, :].reshape(-1, c).T @ dzf for dx in range(3)])
        for dy in range(3)])


def _in_bwd_band(g: torch.Tensor, yhat: torch.Tensor, rstd: torch.Tensor, band) -> torch.Tensor:
    """``_in_bwd`` over the frame of which g and yhat are this rank's band:
    the means from every rank's fp64 sums, in rank order."""
    from nemar_tpu_torch.parallel import spatial

    sums = torch.stack([g.double().sum(dim=(1, 2)), (g * yhat).double().sum(dim=(1, 2))])
    m = (spatial.gather_parts(sums).sum(dim=0) / (band.height * g.shape[2])).to(g.dtype)
    return rstd * (g - m[0][:, None, None] - yhat * m[1][:, None, None])


def resblock_band_bwd_plain_bf16(w1: torch.Tensor, w2: torch.Tensor, xp: torch.Tensor,
                                 y1hat: torch.Tensor, h1p: torch.Tensor, y2: torch.Tensor,
                                 stats: torch.Tensor, g: torch.Tensor, band) -> tuple:
    """Plain version of K-block-bwd's bf16 band form: (dx, dw1, dw2) of this
    rank's band (dw1, dw2 its shares), rounded where
    ``_resblock_bwd_plain_bf16`` rounds (dz2, dh1, dz1, dx, dw1, dw2 bf16;
    the arithmetic fp32), each dgrad's halo rows sent to their owners
    (``spatial.fold_halo_rows``) before the fold of the frame's reflection."""
    from nemar_tpu_torch.parallel import spatial

    bf, f = torch.bfloat16, torch.float32
    dz2 = _in_bwd_band(g.to(f), normalise(y2, stats[:, 2:4]), stats[:, None, None, 3],
                       band).to(bf)
    dw2 = _wgrad_hp(h1p.to(f), dz2.to(f)).to(bf)
    dpad = spatial.fold_halo_rows(conv_adjoint_plain(dz2.to(f), w2.to(f)), band)
    dh1 = reflect_pad_adjoint(dpad, 1).to(bf)
    y1h = y1hat.to(f)
    dz1 = _in_bwd_band(torch.where(y1h > 0, dh1.to(f), 0.0), y1h, stats[:, None, None, 1],
                       band).to(bf)
    dw1 = _wgrad_hp(xp.to(f), dz1.to(f)).to(bf)
    dpad = spatial.fold_halo_rows(conv_adjoint_plain(dz1.to(f), w1.to(f)), band)
    dx = g.to(f) + reflect_pad_adjoint(dpad, 1)
    return dx.to(bf), dw1, dw2


class _ResblockBandBf16(torch.autograd.Function):
    """The plain bf16 band form, its backward written out as the kernel
    computes it (autograd through the roundings would round elsewhere)."""

    @staticmethod
    def forward(ctx, x, w1, w2, band, eps):
        out, saved = resblock_band_fwd_plain_bf16(x, w1, w2, band, eps)
        ctx.band = band
        ctx.save_for_backward(w1, w2, *saved)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dx, dw1, dw2 = resblock_band_bwd_plain_bf16(*ctx.saved_tensors, g, ctx.band)
        return dx, dw1, dw2, None, None


def block_band_fwd_cuda(x: torch.Tensor, xp: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        band, eps: float = 1e-5) -> tuple:
    """K-block in band form on the card: x (N, H, W, C) this rank's band,
    xp the band with its halo rows (N, H + 2, W, C). Four launches, with an
    all-gather of the tile statistics after the first and the third and an
    exchange of y1's halo rows after the second: (1) W1, W2 split and conv1
    over xp (H pre-padded), (2) the frame's (mu1, rstd1) from every rank's
    tiles, (3) conv2 over y1's padded band with IN + relu on the fly, (4)
    the frame's (mu2, rstd2) and the residual. -> (out, (xp, y1, y1p, y2,
    stats)), what ``block_band_bwd_cuda`` takes. bf16 x, w1, w2 launch the
    bf16 variant's stages (``_block_band_fwd_bf16``), counted on
    ``.launches_bf16`` and ``.stages_bf16``."""
    from nemar_tpu_torch.parallel import spatial

    _check_cuda("block_band_fwd_cuda", x, w1, w2, band=True)
    if x.dtype == torch.bfloat16:
        return _block_band_fwd_bf16(x, xp, w1, w2, band, eps)
    n, h, w, c = x.shape
    w1, w2 = w1.contiguous(), w2.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    tiles, most = -(-h * w // 128), -(-band.most * w // 128)
    hw_all = spatial.band_pixels(band, w)
    wsplit = torch.empty((4, 9, c, c), **f32)
    y1, y2 = torch.empty((n, h, w, c), **f32), torch.empty((n, h, w, c), **f32)
    part = torch.empty((n * tiles, 2, c), **f32)
    stats = torch.empty((n, 4, c), **f32)
    out = torch.empty_like(x)
    xp = xp.contiguous()
    _aligned("block_band_fwd_cuda", x, xp, w1, w2)
    _build.launch("nemar_resblock_band_conv1", "ppppppiiii", xp, w1, w2, wsplit, y1, part,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part, n, most))
    _build.launch("nemar_resblock_band_stats", "pppiiiiif", parts, stats, hw_all, band.size, 0,
                  n, most, c, eps)
    one = (1,) * band.size
    y1p = spatial.exchange_rows(y1, band, one, one, dim=1, mode="reflect").contiguous()
    _build.launch("nemar_resblock_band_conv2", "pppppiiii", y1p, stats, wsplit, y2, part,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part, n, most))
    _build.launch("nemar_resblock_band_residual", "ppppppiiiiif", parts, stats, hw_all, x, y2,
                  out, band.size, n, h * w, most, c, eps)
    block_band_fwd_cuda.launches += 1
    block_band_fwd_cuda.stages += 4
    return out, (xp, y1, y1p, y2, stats)


block_band_fwd_cuda.launches = 0
block_band_fwd_cuda.stages = 0
block_band_fwd_cuda.launches_bf16 = 0
block_band_fwd_cuda.stages_bf16 = 0


def _block_band_fwd_bf16(x, xp, w1, w2, band, eps):
    """K-block's bf16 band form: (1) W^T per tap and conv1 over xp, (2) the
    frame's (mu1, rstd1) from every rank's tiles, y1hat and h1 (bf16), then
    h1's halo rows exchanged, (3) conv2 over h1p, (4) the frame's (mu2,
    rstd2) and the residual. -> (out, (xp, y1hat, h1p, y2, stats))."""
    from nemar_tpu_torch.parallel import spatial

    n, h, w, c = x.shape
    w1, w2 = w1.contiguous(), w2.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    tiles, most = -(-h * w // 128), -(-band.most * w // 128)
    hw_all = spatial.band_pixels(band, w)
    wt = torch.empty((2, 9, c, c), dtype=torch.bfloat16, device=x.device)
    y1, y2 = torch.empty((n, h, w, c), **f32), torch.empty((n, h, w, c), **f32)
    y1hat, h1 = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty((n * tiles, 2, c), **f32)
    stats = torch.empty((n, 4, c), **f32)
    out = torch.empty_like(x)
    xp = xp.contiguous()
    _aligned("block_band_fwd_cuda", x, xp, w1, w2)
    _build.launch("nemar_resblock_band_conv1_bf16", "ppppppiiii", xp, w1, w2, wt, y1, part,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part, n, most))
    _build.launch("nemar_resblock_band_norm_relu_bf16", "ppppppiiiiif", parts, stats, hw_all, y1,
                  y1hat, h1, band.size, n, h * w, most, c, eps)
    one = (1,) * band.size
    h1p = spatial.exchange_rows(h1, band, one, one, dim=1, mode="reflect").contiguous()
    _build.launch("nemar_resblock_band_conv2_bf16", "ppppiiii", h1p, wt, y2, part, n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part, n, most))
    _build.launch("nemar_resblock_band_residual_bf16", "ppppppiiiiif", parts, stats, hw_all, x,
                  y2, out, band.size, n, h * w, most, c, eps)
    block_band_fwd_cuda.launches_bf16 += 1
    block_band_fwd_cuda.stages_bf16 += 4
    return out, (xp, y1hat, h1p, y2, stats)


def block_band_bwd_cuda(w1: torch.Tensor, w2: torch.Tensor, xp: torch.Tensor, y1: torch.Tensor,
                        y1p: torch.Tensor, y2: torch.Tensor, stats: torch.Tensor,
                        g: torch.Tensor, band) -> tuple:
    """K-block-bwd in band form on the card: (dx, dw1, dw2) of this rank's
    band, dw1 and dw2 the band's shares (the gradient all-reduce sums
    them). Five launches, with an all-gather of the IN backward's partials
    before each merge and the halo rows of each dgrad's padded gradient
    sent to their owners (``spatial.fold_halo_rows``): (1) IN2's partials;
    (2) their merge over every rank (and W's split), dz2, dW2, dpad2; (3)
    IN1's partials from fold(dpad2); (4) their merge, dz1, dW1's partials,
    dpad1; (5) dx = g + fold(dpad1) and dW1. bf16 values (K-block's bf16
    band form's (xp, y1hat, h1p, y2, stats), g bf16) launch the bf16
    variant's five stages (``_block_band_bwd_bf16``)."""
    from nemar_tpu_torch.parallel import spatial

    if g.shape[1] == 0:
        return _block_band_bwd_empty(w1, w2, g, band)
    if g.dtype == torch.bfloat16:
        return _block_band_bwd_bf16(w1, w2, xp, y1, y1p, y2, stats, g, band)
    n, h, w, c = g.shape
    w1, w2 = w1.contiguous(), w2.contiguous()
    g = g.contiguous()
    f32 = dict(dtype=torch.float32, device=g.device)
    splits = wgrad_splits(n, h, w, c)
    most, pixels = -(-band.most * w // _BM), band.height * w
    part_in = torch.empty((n * -(-h * w // _BM), 2, c), **f32)
    means = torch.empty((n, 2, c), **f32)
    wsplit = torch.empty((4, 9 * c, c), **f32)
    dz = torch.empty_like(g)
    dpad = torch.empty((n, h + 2, w + 2, c), **f32)
    part_w = torch.empty((splits, 9 * c, c), **f32)
    dw1, dw2, dx = torch.empty_like(w1), torch.empty_like(w2), torch.empty_like(g)
    _aligned("block_band_bwd_cuda", xp, y1, y1p, y2, g, w1, w2)
    _build.launch("nemar_resblock_band_bwd_part", "ppppiiiii", g, y2, stats, part_in, 2,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part_in, n, most))
    _build.launch("nemar_resblock_band_bwd_dz2", "pppppppppppppiiliiiii", parts, means, w1, w2,
                  wsplit, g, y2, stats, dz, y1p, part_w, dw2, dpad, band.size, most, pixels, n,
                  h, w, c, splits)
    spatial.fold_halo_rows(dpad, band)
    _build.launch("nemar_resblock_band_bwd_part", "ppppiiiii", dpad, y1, stats, part_in, 1,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part_in, n, most))
    _build.launch("nemar_resblock_band_bwd_dz1", "pppppppppiiliiiii", parts, means, wsplit, dpad,
                  y1, stats, dz, xp, part_w, band.size, most, pixels, n, h, w, c, splits)
    spatial.fold_halo_rows(dpad, band)
    _build.launch("nemar_resblock_band_bwd_dx", "pppppiiiii", g, dpad, dx, part_w, dw1,
                  n, h, w, c, splits)
    block_band_bwd_cuda.launches += 1
    block_band_bwd_cuda.stages += 5
    return dx, dw1, dw2


block_band_bwd_cuda.launches = 0
block_band_bwd_cuda.stages = 0
block_band_bwd_cuda.launches_bf16 = 0
block_band_bwd_cuda.stages_bf16 = 0


def _block_band_bwd_bf16(w1, w2, xp, y1hat, h1p, y2, stats, g, band):
    """K-block-bwd's bf16 band form: the fp32 band form's five stages on the
    bf16 backward's operands (no W split: the dgrads read W as it lies)."""
    from nemar_tpu_torch.parallel import spatial

    n, h, w, c = g.shape
    w1, w2 = w1.contiguous(), w2.contiguous()
    g = g.contiguous()
    f32 = dict(dtype=torch.float32, device=g.device)
    splits = wgrad_splits(n, h, w, c, 64)
    most, pixels = -(-band.most * w // _BM), band.height * w
    part_in = torch.empty((n * -(-h * w // _BM), 2, c), **f32)
    means = torch.empty((n, 2, c), **f32)
    dz = torch.empty_like(g)
    dpad = torch.empty((n, h + 2, w + 2, c), **f32)
    part_w = torch.empty((splits, 9 * c, c), **f32)
    dw1, dw2, dx = torch.empty_like(w1), torch.empty_like(w2), torch.empty_like(g)
    _aligned("block_band_bwd_cuda", xp, y1hat, h1p, y2, g, w1, w2)
    _build.launch("nemar_resblock_band_bwd_part_bf16", "ppppiiiii", g, y2, stats, part_in, 2,
                  n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part_in, n, most))
    _build.launch("nemar_resblock_band_bwd_dz2_bf16", "pppppppppppiiliiiii", parts, means, g, y2,
                  stats, dz, h1p, w2, part_w, dw2, dpad, band.size, most, pixels, n, h, w, c,
                  splits)
    spatial.fold_halo_rows(dpad, band)
    _build.launch("nemar_resblock_band_bwd_part_bf16", "ppppiiiii", dpad, y1hat, stats, part_in,
                  1, n, h, w, c)
    parts = spatial.gather_parts(pad_tiles(part_in, n, most))
    _build.launch("nemar_resblock_band_bwd_dz1_bf16", "pppppppppiiliiiii", parts, means, dpad,
                  y1hat, stats, dz, xp, w1, part_w, band.size, most, pixels, n, h, w, c, splits)
    spatial.fold_halo_rows(dpad, band)
    _build.launch("nemar_resblock_band_bwd_dx_bf16", "pppppiiiii", g, dpad, dx, part_w, dw1,
                  n, h, w, c, splits)
    block_band_bwd_cuda.launches_bf16 += 1
    block_band_bwd_cuda.stages_bf16 += 5
    return dx, dw1, dw2


def _block_band_bwd_empty(w1, w2, g, band) -> tuple:
    """K-block-bwd's band form on an empty band: no launch, this rank's
    share of the collectives (zero partials, zero halo gradients) in the
    order the other ranks make them; dw1 and dw2 its shares, zeros."""
    from nemar_tpu_torch.parallel import spatial

    n, _, w, c = g.shape
    part = torch.zeros((n * -(-band.most * w // _BM), 2, c), dtype=torch.float32,
                       device=g.device)
    dpad = torch.zeros((n, 2, w + 2, c), dtype=torch.float32, device=g.device)
    for _ in range(2):
        spatial.gather_parts(part)
        spatial.fold_halo_rows(dpad, band)
    return torch.empty_like(g), torch.zeros_like(w1), torch.zeros_like(w2)


class _FusedResblockBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, band, eps):
        from nemar_tpu_torch.parallel import spatial

        c = x.shape[3]
        pad = -c % _BN
        if pad:
            x = F.pad(x, (0, pad))
            w1, w2 = F.pad(w1, (0, pad, 0, pad)), F.pad(w2, (0, pad, 0, pad))
        one = (1,) * band.size
        x = x.contiguous()
        xp = spatial.exchange_rows(x, band, one, one, dim=1, mode="reflect")
        out, saved = block_band_fwd_cuda(x, xp, w1, w2, band, eps)
        ctx.band, ctx.c = band, c
        ctx.save_for_backward(w1, w2, *saved)
        return out[..., :c].contiguous() if pad else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        c = ctx.c
        w1, w2, *saved = ctx.saved_tensors
        if w1.shape[2] != c:
            g = F.pad(g, (0, w1.shape[2] - c))
        dx, dw1, dw2 = block_band_bwd_cuda(w1, w2, *saved, g, ctx.band)
        return dx[..., :c], dw1[:, :, :c, :c], dw2[:, :, :c, :c], None, None


def fused_resblock_band(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, band,
                        eps: float = 1e-5) -> torch.Tensor:
    """``fused_resblock`` of the frame of which the NHWC x is this rank's
    band (``parallel.spatial.Band``): K-block's and K-block-bwd's band forms
    on the card (their bf16 variants' for bf16 x, w1, w2),
    ``resblock_band_plain`` on the CPU."""
    if x.is_cuda:
        return _FusedResblockBand.apply(x, w1, w2, band, eps)
    return resblock_band_plain(x, w1, w2, band, eps)
