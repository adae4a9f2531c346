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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.norm import instance_norm_stats, normalise

_P = ctypes.c_void_p
_I = ctypes.c_int
# tile sizes of csrc/resblock_{fwd,bwd}.cu: a pixel tile must not straddle samples
_BM, _BN = 64, 128
# pixel ranges K-block-bwd splits each weight gradient's reduction into
_WGRAD_SPLITS = 8


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


def _conv_wgrad(src: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """dW[dy, dx] = pad(src)[p + (dy, dx)]^T @ dz[p], summed over pixels; HWIO."""
    n, h, w, c = src.shape
    sp = F.pad(src.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    dzf = dz.reshape(-1, dz.shape[-1])
    return torch.stack([torch.stack([
        sp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c).T @ dzf for dx in range(3)])
        for dy in range(3)])


def _conv_adjoint(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gradient of the padded input (N, H+2, W+2, C_in): each tap scatters
    dz @ W[dy, dx]^T back to the rows and columns it read."""
    n, h, wd, _ = dz.shape
    dpad = dz.new_zeros((n, h + 2, wd + 2, w.shape[2]))
    for dy in range(3):
        for dx in range(3):
            dpad[:, dy:dy + h, dx:dx + wd, :] += dz @ w[dy, dx].T
    return dpad


def _pad_adjoint(dpad: torch.Tensor) -> torch.Tensor:
    """Fold the reflect padding's gradient back into the interior: the
    reverse of the padding's construction order (columns were filled last,
    from the padded array's columns 2 and W-1; rows from interior rows 1
    and H-2), as ``nemar_tpu/ops/conv_fused.py:_pad_adjoint``."""
    d = dpad.clone()
    h, w = d.shape[1] - 2, d.shape[2] - 2
    d[:, :, 2] += d[:, :, 0]
    d[:, :, w - 1] += d[:, :, w + 1]
    d[:, 2, 1:w + 1] += d[:, 0, 1:w + 1]
    d[:, h - 1, 1:w + 1] += d[:, h + 1, 1:w + 1]
    return d[:, 1:h + 1, 1:w + 1]


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
    dw2 = _conv_wgrad(h1, dz2)
    dh1 = _pad_adjoint(_conv_adjoint(dz2, w2))
    dz1 = _in_bwd(torch.where(y1h > 0, dh1, 0.0), y1h, stats[:, None, None, 1])
    dw1 = _conv_wgrad(x, dz1)
    dx = g + _pad_adjoint(_conv_adjoint(dz1, w1))
    return dx, dw1, dw2


def block_kernel_supported(shape) -> bool:
    """Shapes K-block takes: C % 128 == 0, H*W % 64 == 0, H and W >= 2."""
    n, h, w, c = shape
    return c % _BN == 0 and (h * w) % _BM == 0 and h >= 2 and w >= 2


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
                         f"(needs C % {_BN} == 0, H*W % {_BM} == 0, H, W >= 2)")


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
    y1 = torch.empty_like(x)
    y2 = torch.empty_like(x)
    out = torch.empty_like(x)
    part = torch.empty((n * h * w // _BM, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, 4, c), dtype=torch.float32, device=x.device)
    fn = _build.c_function("nemar_resblock_fwd",
                           [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                  part.data_ptr(), stats.data_ptr(), out.data_ptr(), n, h, w, c, eps, stream)
    _build.check(code, "fused_resblock_cuda")
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
    # the dgrads contract over output channels: W[dy, dx]^T, as (9C, C) rows (tap, co)
    w1t = w1.transpose(2, 3).contiguous()
    w2t = w2.transpose(2, 3).contiguous()
    splits = _WGRAD_SPLITS
    dev = x.device
    dz = torch.empty_like(x)
    dh1 = torch.empty_like(x)
    dx = torch.empty_like(x)
    part_in = torch.empty((n * h * w // 64, 2, c), dtype=torch.float32, device=dev)
    means = torch.empty((n, 2, c), dtype=torch.float32, device=dev)
    part_w = torch.empty((splits, 9 * c, c), dtype=torch.float32, device=dev)
    dw1 = torch.empty((3, 3, c, c), dtype=torch.float32, device=dev)
    dw2 = torch.empty((3, 3, c, c), dtype=torch.float32, device=dev)
    _aligned("resblock_bwd_cuda", x, y1, y2, stats, g, w1t, w2t)
    fn = _build.c_function("nemar_resblock_bwd", [_P] * 15 + [_I] * 5 + [_P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), y1.data_ptr(), y2.data_ptr(), stats.data_ptr(), g.data_ptr(),
                  w1t.data_ptr(), w2t.data_ptr(), dz.data_ptr(), dh1.data_ptr(),
                  part_in.data_ptr(), means.data_ptr(), part_w.data_ptr(), dw1.data_ptr(),
                  dw2.data_ptr(), dx.data_ptr(), n, h, w, c, splits, stream)
    _build.check(code, "resblock_bwd_cuda")
    resblock_bwd_cuda.launches += 1
    return dx, dw1, dw2


resblock_bwd_cuda.launches = 0


class _FusedResblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, eps):
        ctx.eps = eps
        if x.is_cuda:
            out, y1, y2, stats = fused_resblock_cuda(x, w1, w2, eps)
            ctx.save_for_backward(x, w1, w2, y1, y2, stats)
        else:
            out = resblock_plain(x, w1, w2, eps)
            ctx.save_for_backward(x, w1, w2)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            x, w1, w2, y1, y2, stats = ctx.saved_tensors
            dx, dw1, dw2 = resblock_bwd_cuda(x, w1, w2, y1, y2, stats, g.contiguous())
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
