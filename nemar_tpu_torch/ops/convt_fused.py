"""One stage of the ResNet generator's decoder, fused:

    out = relu(IN(convT(x, W))),   convT = flax ConvTranspose(3x3, stride 2, 'SAME')

NHWC x (N, H, W, Ci) -> (N, 2H, 2W, Co); W (3, 3, Ci, Co) is flax's
ConvTranspose kernel (HWIO, not flipped); instance norm per (n, c) over the
2H x 2W output, biased variance, eps 1e-5, no affine. The conv bias is
inert through IN: it is left out and gets no gradient (the model keeps it
as a parameter, for checkpoint compatibility). Counterpart of
``nemar_tpu/ops/attic/convt_fused.py:fused_convt_in`` (``--block_impl
pallas_all``; its ``convt_in_reference`` below 128 channels) and of the
JAX generator's ``nn.ConvTranspose`` + instance norm + relu otherwise.

The contribution of x[i, j] * W[ky, kx] lands at out[2i + 2 - ky, 2j + 2 - kx]
(the TPU kernel's ``_AX`` table), so each output parity plane (py, px) is a
small convolution of x with 1, 2, 2 or 4 taps and no inserted zeros.

``fused_convt_in`` is a ``torch.autograd.Function`` that dispatches on the
device. A CPU tensor takes ``convt_in_fwd_plain`` (``F.conv_transpose2d``
cropped to 2H x 2W, the model's former path, + IN + relu) forward and
``convt_in_bwd_plain`` (the VJP written out over the parity planes)
backward. A CUDA tensor launches the CUDA kernels K-convt
(``csrc/convt_fwd.cu``, replacing the TPU kernel ``_fwd_kernel`` of B5) and
K-convt-bwd (``csrc/convt_bwd.cu``, replacing its ``_bwd_kernel``), whose
GEMMs run in 3xTF32 on the tensor cores (``csrc/gemm_tc.cuh``); the
forward saves yhat = IN(convT(x, W)) and (mu, rstd) for the backward, as
the TPU kernel does.

The kernels copy 16 bytes at a time, so they take Ci and Co multiples of
4. Other channel counts (``--ngf 6``'s last stage, 12 -> 6) are zero-padded
to the next multiple of 4 around the launch (``convt_fwd_padded``,
``convt_bwd_padded``): a zero output channel stays zero through the
instance norm and the relu, a zero input channel adds nothing, and the
padding's gradients are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.norm import instance_norm_stats, normalise

# tile of K-convt's GEMM (pixels of one plane) and of K-convt-bwd's
# instance-norm partials (output pixels), csrc/gemm_tc.cuh and convt_bwd.cu
_BM = 128
_IN_TILE = 64
# K-convt-bwd's weight gradient is a split-K GEMM of 9 ceil(Ci / 128) x
# ceil(Co / TN) tiles (TN = 64 for Co <= 64, else 128), split into as many
# pixel ranges as fill three waves of one block on each of the H100's 132 SMs
# (as K-block-bwd's); a range holds whole K slices of the GEMM (32 pixels)
_WGRAD_SLOTS = 3 * 132
_BK = 32
# per axis, output parity -> [(kernel index, input offset)] (_AX)
_AX = {0: [(2, 0), (0, -1)], 1: [(1, 0)]}


def convt_flax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose(3x3, stride 2, 'SAME') of NHWC x with HWIO w, no
    bias: torch's transposed conv of the flipped kernel, cropped to 2H x 2W
    (``utils/convert.py`` maps the parameters the same way)."""
    h, wd = x.shape[1], x.shape[2]
    wt = w.flip(0, 1).permute(2, 3, 0, 1)  # (Ci, Co, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2)[:, :, :2 * h, :2 * wd]
    return y.permute(0, 2, 3, 1)


def convt_in_fwd_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> tuple:
    """Plain version of everything K-convt returns: (out, yhat, stats), yhat
    the normalised output before the relu, stats (N, 2, Co) = (mu, rstd)."""
    y = convt_flax(x, w)
    stats = instance_norm_stats(y, eps)
    yhat = normalise(y, stats).contiguous()
    return torch.clamp_min(yhat, 0.0), yhat, stats


def convt_in_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``fused_convt_in`` (any device)."""
    return convt_in_fwd_plain(x, w, eps)[0]


def convt_in_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5,
                       saved: tuple | None = None) -> tuple:
    """Plain version of K-convt-bwd: (dx, dw) of ``fused_convt_in`` given
    g = d out, written out over the parity planes (no autograd): the IN +
    relu backward over the 4 planes together, then per tap (ky, kx), with
    (py, dy) and (px, dx) its plane and input offsets, dW[ky, kx] = the
    shifted x^T . dz_plane, and dx = sum over the taps of dz at
    (2i + 2 - ky, 2j + 2 - kx) . W[ky, kx]^T. ``saved`` = (yhat, stats) of
    the forward, as K-convt-bwd takes them; recomputed when None."""
    yhat, stats = convt_in_fwd_plain(x, w, eps)[1:] if saved is None else saved
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    gh = torch.where(yhat > 0, g, 0.0)
    m1 = gh.mean(dim=(1, 2), keepdim=True)
    m2 = (gh * yhat).mean(dim=(1, 2), keepdim=True)
    dz = stats[:, None, None, 1] * (gh - m1 - yhat * m2)
    # x with one zero row on top and one zero column on the left: input
    # offset -1 of plane pixel i is padded row i
    xp = F.pad(x, (0, 0, 1, 0, 1, 0))
    dw = x.new_zeros((3, 3, ci, co))
    for py in (0, 1):
        for px in (0, 1):
            plane = dz[:, py::2, px::2, :].reshape(-1, co)
            for ky, dy in _AX[py]:
                for kx, dx in _AX[px]:
                    slab = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd, :].reshape(-1, ci)
                    dw[ky, kx] = slab.T @ plane
    # dz with one zero row / column past the end: out[2i + 2] for i = H - 1
    dzp = F.pad(dz, (0, 0, 0, 2, 0, 2))
    dxx = x.new_zeros(x.shape)
    for ky in range(3):
        for kx in range(3):
            src = dzp[:, 2 - ky::2, 2 - kx::2, :][:, :h, :wd, :]
            dxx += src @ w[ky, kx].T
    return dxx, dw


def _check_cuda(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{what}: x and w must be on one CUDA device")
    if not (x.dtype == w.dtype == torch.float32):
        raise TypeError(f"{what}: the kernel takes float32 x and w")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be NHWC-contiguous")
    ci = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{what}: w {tuple(w.shape)} is not (3, 3, {ci}, Co)")
    if ci % 4 or w.shape[3] % 4:
        raise ValueError(f"{what}: channels {ci} -> {w.shape[3]} must be multiples of 4")


def _aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")


def fused_convt_in_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> tuple:
    """Launch K-convt. x (N, H, W, Ci) fp32 NHWC-contiguous on a CUDA device;
    w (3, 3, Ci, Co) fp32 (made contiguous here). Returns (out, yhat, stats):
    out = relu(yhat) and yhat (N, 2H, 2W, Co), stats (N, 2, Co) = (mu, rstd),
    which K-convt-bwd takes."""
    _check_cuda("fused_convt_in_cuda", x, w)
    w = w.contiguous()
    _aligned("fused_convt_in_cuda", x, w)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    dev = x.device
    tiles = -(-(h * wd) // _BM)
    wsplit = torch.empty((2, 9, co, ci), dtype=torch.float32, device=dev)
    yhat = torch.empty((n, 2 * h, 2 * wd, co), dtype=torch.float32, device=dev)
    out = torch.empty_like(yhat)
    part = torch.empty((n * 4 * tiles, 2, co), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 2, co), dtype=torch.float32, device=dev)
    _build.op("convt_in_fwd")(x, w, wsplit, yhat, part, stats, out, eps)
    fused_convt_in_cuda.launches += 1
    return out, yhat, stats


fused_convt_in_cuda.launches = 0


def wgrad_splits(pixels: int, ci: int, co: int) -> tuple:
    """(splits, pixels per split) of K-convt-bwd's weight gradient over
    ``pixels`` = N*H*W with Ci -> Co channels: fixed by the shape, so the
    sum's order is too."""
    tiles = 9 * -(-ci // 128) * -(-co // (64 if co <= 64 else 128))
    splits = max(1, min(-(-pixels // _BK), _WGRAD_SLOTS // tiles))
    per = -(-pixels // splits)
    per = -(-per // _BK) * _BK
    return -(-pixels // per), per


def convt_in_bwd_cuda(x: torch.Tensor, w: torch.Tensor, yhat: torch.Tensor, stats: torch.Tensor,
                      g: torch.Tensor) -> tuple:
    """Launch K-convt-bwd: (dx, dw) of ``fused_convt_in`` given g = d out and
    K-convt's saved (yhat, stats). Same layouts and shape rules as
    ``fused_convt_in_cuda``; dw is (3, 3, Ci, Co)."""
    _check_cuda("convt_in_bwd_cuda", x, w)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    for name, t in (("yhat", yhat), ("g", g)):
        if tuple(t.shape) != (n, 2 * h, 2 * wd, co) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"convt_in_bwd_cuda: {name} must be a contiguous fp32 "
                             f"({n}, {2 * h}, {2 * wd}, {co}) tensor on x's device")
    if tuple(stats.shape) != (n, 2, co) or not stats.is_contiguous():
        raise ValueError(f"convt_in_bwd_cuda: stats {tuple(stats.shape)} is not ({n}, 2, {co})")
    w = w.contiguous()
    dev = x.device
    splits, per = wgrad_splits(n * h * wd, ci, co)
    wsplit = torch.empty((2, 9 * ci, co), dtype=torch.float32, device=dev)
    dz = torch.empty_like(yhat)
    part_in = torch.empty((n * -(-(4 * h * wd) // _IN_TILE), 2, co), dtype=torch.float32,
                          device=dev)
    means = torch.empty((n, 2, co), dtype=torch.float32, device=dev)
    part_w = torch.empty((splits, 9 * ci, co), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    _aligned("convt_in_bwd_cuda", x, w, yhat, stats, g)
    _build.op("convt_in_bwd")(x, w, yhat, stats, g, wsplit, dz, part_in, means, part_w, dw, dx,
                              splits, per)
    convt_in_bwd_cuda.launches += 1
    return dx, dw


convt_in_bwd_cuda.launches = 0


def convt_fwd_padded(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> tuple:
    """K-convt at any channel counts: Ci and Co zero-padded to multiples of 4,
    the output cut back to Co. Returns (out, saved): saved = the padded (x,
    w) and K-convt's (yhat, stats), which ``convt_bwd_padded`` takes."""
    ci, co = w.shape[2], w.shape[3]
    pi, po = -ci % 4, -co % 4
    if pi or po:
        x, w = F.pad(x, (0, pi)), F.pad(w, (0, po, 0, pi))
    out, yhat, stats = fused_convt_in_cuda(x, w, eps)
    return (out[..., :co].contiguous() if po else out), (x, w, yhat, stats)


def convt_bwd_padded(x: torch.Tensor, w: torch.Tensor, yhat: torch.Tensor, stats: torch.Tensor,
                     g: torch.Tensor, ci: int) -> tuple:
    """K-convt-bwd on ``convt_fwd_padded``'s saved values, given g = d out
    of the Co channels the caller sees: (dx, dw) cut back to Ci and Co."""
    co = g.shape[3]
    if w.shape[3] != co:
        g = F.pad(g, (0, w.shape[3] - co))
    dx, dw = convt_in_bwd_cuda(x, w, yhat, stats, g.contiguous())
    return dx[..., :ci], dw[:, :, :ci, :co]


class _FusedConvtIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.ci = x.shape[3]
        if x.is_cuda:
            out, saved = convt_fwd_padded(x, w, eps)
        else:
            out, yhat, stats = convt_in_fwd_plain(x, w, eps)
            saved = (x, w, yhat, stats)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, yhat, stats = ctx.saved_tensors
        if g.is_cuda:
            dx, dw = convt_bwd_padded(x, w, yhat, stats, g, ctx.ci)
        else:
            dx, dw = convt_in_bwd_plain(x, w, g, ctx.eps, saved=(yhat, stats))
        return dx, dw, None


def fused_convt_in(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """relu(IN(convT(x, w))); NHWC x, flax ConvTranspose kernel w (3, 3, Ci,
    Co). Differentiable in x and w."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"fused_convt_in: unsupported device {x.device}")
    return _FusedConvtIn.apply(x, w, eps)
