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


def wgrad_splits(n: int, h: int, w: int, c: int) -> int:
    """Pixel ranges K-block-bwd splits each weight gradient's reduction into
    (K slices of 32 pixels, at least one per range)."""
    tiles = (9 * c // 128) * (c // 128)
    return max(1, min(n * -(-h * w // 32), _WGRAD_SLOTS // tiles))


def _conv3x3_reflect(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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
                       eps: float = 1e-5) -> tuple:
    """Plain version of everything K-block returns: (out, y1, y2, stats),
    the conv outputs before IN and stats (N, 4, C) = (mu1, rstd1, mu2, rstd2)."""
    y1 = _conv3x3_reflect(x, w1)
    st1 = instance_norm_stats(y1, eps)
    y2 = _conv3x3_reflect(torch.clamp_min(normalise(y1, st1), 0.0), w2)
    st2 = instance_norm_stats(y2, eps)
    # y1, y2 NHWC-contiguous, as K-block writes them
    return x + normalise(y2, st2), y1.contiguous(), y2.contiguous(), torch.cat([st1, st2], dim=1)


def resblock_bwd_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-5, saved: tuple | None = None) -> tuple:
    """Plain version of K-block-bwd: (dx, dw1, dw2) of ``fused_resblock``
    given g = d out, written out (no autograd): IN2's backward, conv2's
    weight gradient and input adjoint with the reflect-pad fold, relu, IN1's
    backward, and conv1's. ``saved`` = (y1, y2, stats) of the forward, as
    K-block-bwd takes them; recomputed when None."""
    _, y1, y2, stats = resblock_fwd_plain(x, w1, w2, eps) if saved is None else (None, *saved)
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


def _check_cuda(what: str, x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> None:
    if not (x.is_cuda and w1.device == x.device and w2.device == x.device):
        raise ValueError(f"{what}: x, w1, w2 must be on one CUDA device")
    if not (x.dtype == w1.dtype == w2.dtype == torch.float32):
        raise TypeError(f"{what}: the kernel takes float32 x, w1, w2")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be NHWC-contiguous")
    n, h, w, c = x.shape
    if tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"{what}: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not (3, 3, {c}, {c})")
    if not block_kernel_supported(x.shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)} not supported "
                         f"(needs C % {_BN} == 0, H, W >= 2)")


def _aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")


def fused_resblock_cuda(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        eps: float = 1e-5) -> tuple:
    """Launch K-block. x (N, H, W, C) fp32 NHWC-contiguous on a CUDA device;
    w1, w2 (3, 3, C, C) HWIO fp32 (made contiguous here). Returns (out, y1,
    y2, stats): the conv outputs before IN and stats (N, 4, C) = (mu1,
    rstd1, mu2, rstd2), which K-block-bwd takes."""
    _check_cuda("fused_resblock_cuda", x, w1, w2)
    w1, w2 = w1.contiguous(), w2.contiguous()
    _aligned("fused_resblock_cuda", x, w1, w2)
    n, h, w, c = x.shape
    dev = x.device
    # W1^T, W2^T per tap, split into TF32 big and small parts
    wsplit = torch.empty((4, 9, c, c), dtype=torch.float32, device=dev)
    y1 = torch.empty_like(x)
    y2 = torch.empty_like(x)
    out = torch.empty_like(x)
    # per 128-pixel tile of a sample, its per-channel (mean, M2)
    part = torch.empty((n * -(-h * w // 128), 2, c), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 4, c), dtype=torch.float32, device=dev)
    _build.op("resblock_fwd")(x, w1, w2, wsplit, y1, y2, part, stats, out, eps)
    fused_resblock_cuda.launches += 1
    return out, y1, y2, stats


fused_resblock_cuda.launches = 0


def resblock_bwd_cuda(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, y1: torch.Tensor,
                      y2: torch.Tensor, stats: torch.Tensor, g: torch.Tensor) -> tuple:
    """Launch K-block-bwd: (dx, dw1, dw2) of ``fused_resblock`` given g = d
    out and K-block's saved (y1, y2, stats). Same layouts and shape rules
    as ``fused_resblock_cuda``; dw1, dw2 are HWIO."""
    _check_cuda("resblock_bwd_cuda", x, w1, w2)
    n, h, w, c = x.shape
    for name, t in (("y1", y1), ("y2", y2), ("g", g)):
        if t.shape != x.shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"resblock_bwd_cuda: {name} must be a contiguous fp32 tensor "
                             f"of x's shape {tuple(x.shape)} and device")
    if tuple(stats.shape) != (n, 4, c) or not stats.is_contiguous():
        raise ValueError(f"resblock_bwd_cuda: stats {tuple(stats.shape)} is not ({n}, 4, {c})")
    if n * (h + 2) * (w + 2) * c >= 2**31:
        raise ValueError(f"resblock_bwd_cuda: {tuple(x.shape)} is too large for 32-bit offsets")
    # HWIO as they are: the dgrads read W[tap][ci][co] K-major (along co)
    w1, w2 = w1.contiguous(), w2.contiguous()
    splits = wgrad_splits(n, h, w, c)
    dev = x.device
    wsplit = torch.empty((4, 9 * c, c), dtype=torch.float32, device=dev)
    dz = torch.empty_like(x)
    # the gradient of the reflect-padded input, written by each dgrad
    dpad = torch.empty((n, h + 2, w + 2, c), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    part_in = torch.empty((n * -(-h * w // _BM), 2, c), dtype=torch.float32, device=dev)
    means = torch.empty((n, 2, c), dtype=torch.float32, device=dev)
    part_w = torch.empty((splits, 9 * c, c), dtype=torch.float32, device=dev)
    dw1 = torch.empty((3, 3, c, c), dtype=torch.float32, device=dev)
    dw2 = torch.empty((3, 3, c, c), dtype=torch.float32, device=dev)
    _aligned("resblock_bwd_cuda", x, y1, y2, stats, g, w1, w2)
    _build.op("resblock_bwd")(x, y1, y2, stats, g, w1, w2, wsplit, dz, dpad, part_in, means,
                              part_w, dw1, dw2, dx, splits)
    resblock_bwd_cuda.launches += 1
    return dx, dw1, dw2


resblock_bwd_cuda.launches = 0


def block_fwd_padded(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     eps: float = 1e-5) -> tuple:
    """K-block at any channel count: C zero-padded to a multiple of 128 (x's
    channels, both weights' in and out), the output cut back to C. Returns
    (out, saved): saved = the padded (x, w1, w2) and K-block's (y1, y2,
    stats), which ``block_bwd_padded`` takes."""
    c = x.shape[3]
    pad = -c % _BN
    if pad:
        x = F.pad(x, (0, pad))
        w1, w2 = F.pad(w1, (0, pad, 0, pad)), F.pad(w2, (0, pad, 0, pad))
    out, y1, y2, stats = fused_resblock_cuda(x, w1, w2, eps)
    return (out[..., :c].contiguous() if pad else out), (x, w1, w2, y1, y2, stats)


def block_bwd_padded(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, y1: torch.Tensor,
                     y2: torch.Tensor, stats: torch.Tensor, g: torch.Tensor) -> tuple:
    """K-block-bwd on ``block_fwd_padded``'s saved values, given g = d out
    of the C channels the caller sees: (dx, dw1, dw2) cut back to C."""
    c = g.shape[3]
    pad = x.shape[3] - c
    if pad:
        g = F.pad(g, (0, pad))
    dx, dw1, dw2 = resblock_bwd_cuda(x, w1, w2, y1, y2, stats, g.contiguous())
    if pad:
        dx, dw1, dw2 = dx[..., :c], dw1[:, :, :c, :c], dw2[:, :, :c, :c]
    return dx, dw1, dw2


class _FusedResblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, eps):
        ctx.eps = eps
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
    Differentiable in x, w1 and w2."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    return _FusedResblock.apply(x, w1, w2, eps)
