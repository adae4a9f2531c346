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

Under ``--bf16`` x and W are bfloat16. The bf16 variants of K-convt and
K-convt-bwd (one bf16 MMA a product on the shared wgmma core) and the
plain versions at bf16 compute the convolutions, the statistics and the
instance-norm backward in fp32 and round where the TPU kernel stores the
compute dtype: yhat and out, dz, dx, and dw (to W's type); the statistics
stay fp32. A 16-byte copy holds 8 bf16 channels, so the bf16 variants take
Ci and Co multiples of 8 (the padding above pads to 8 at bf16). One
wrapper launches either variant by x's type (``fused_convt_in_cuda``,
``convt_in_bwd_cuda``) and counts each on its own (``.launches``,
``.launches_bf16``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.norm import instance_norm_stats, normalise

# tile of K-convt's GEMM (pixels of one plane) and of K-convt-bwd's
# instance-norm partials (output pixels), csrc/gemm_tc.cuh and convt_bwd.cu
# (the bf16 variant's partial tiles are 256-2048 pixels: the same buffer
# holds them)
_BM = 128
_IN_TILE = 64
# K-convt-bwd's weight gradient is a split-K GEMM of 9 ceil(Ci / 128) x
# ceil(Co / TN) tiles (TN = 64 for Co <= 64, else 128), split into as many
# pixel ranges as fill three waves of one block on each of the H100's 132 SMs
# (as K-block-bwd's); a range holds whole K slices of the GEMM (32 pixels)
_WGRAD_SLOTS = 3 * 132
_BK = 32
# the channel multiple each variant's 16-byte copies need
_CH_MULT = {torch.float32: 4, torch.bfloat16: 8}
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


def convt_in_fwd_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                       work: torch.dtype = torch.float32) -> tuple:
    """Plain version of everything K-convt returns: (out, yhat, stats), yhat
    the normalised output before the relu, stats (N, 2, Co) = (mu, rstd).
    bf16 x and w are convolved and normalised in ``work`` (fp32; float64 for
    a reference with the bf16 variant's roundings), out and yhat rounded to
    bf16."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, w = x.to(work), w.to(work)
    y = convt_flax(x, w)
    stats = instance_norm_stats(y, eps)
    yhat = normalise(y, stats).to(dtype).contiguous()
    return torch.clamp_min(yhat, 0.0), yhat, stats


def convt_in_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``fused_convt_in`` (any device)."""
    return convt_in_fwd_plain(x, w, eps)[0]


def convt_in_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5,
                       saved: tuple | None = None, work: torch.dtype = torch.float32) -> tuple:
    """Plain version of K-convt-bwd: (dx, dw) of ``fused_convt_in`` given
    g = d out, written out over the parity planes (no autograd): the IN +
    relu backward over the 4 planes together, then per tap (ky, kx), with
    (py, dy) and (px, dx) its plane and input offsets, dW[ky, kx] = the
    shifted x^T . dz_plane, and dx = sum over the taps of dz at
    (2i + 2 - ky, 2j + 2 - kx) . W[ky, kx]^T. ``saved`` = (yhat, stats) of
    the forward, as K-convt-bwd takes them; recomputed when None. At bf16
    computed in ``work``."""
    yhat, stats = convt_in_fwd_plain(x, w, eps, work)[1:] if saved is None else saved
    dtype = x.dtype
    if dtype == torch.bfloat16:  # in work from here, dz, dx and dw rounded to bf16
        x, w, g, yhat, stats = (t.to(work) for t in (x, w, g, yhat, stats))
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    gh = torch.where(yhat > 0, g, 0.0)
    m1 = gh.mean(dim=(1, 2), keepdim=True)
    m2 = (gh * yhat).mean(dim=(1, 2), keepdim=True)
    dz = stats[:, None, None, 1] * (gh - m1 - yhat * m2)
    if dtype == torch.bfloat16:
        dz = dz.to(dtype).to(work)
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
    return dxx.to(dtype), dw.to(dtype)


def _check_cuda(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{what}: x and w must be on one CUDA device")
    if not (x.dtype == w.dtype and x.dtype in _CH_MULT):
        raise TypeError(f"{what}: x is {x.dtype} and w {w.dtype}; the kernel takes float32 "
                        f"(bfloat16: its bf16 variant) for both")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be NHWC-contiguous")
    ci = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{what}: w {tuple(w.shape)} is not (3, 3, {ci}, Co)")
    m = _CH_MULT[x.dtype]
    if ci % m or w.shape[3] % m:
        raise ValueError(f"{what}: channels {ci} -> {w.shape[3]} must be multiples of {m}")


def _aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")


def fused_convt_in_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> tuple:
    """Launch K-convt, or its bf16 variant for bf16 x and w (each counted on
    its own: ``.launches``, ``.launches_bf16``). x (N, H, W, Ci)
    NHWC-contiguous on a CUDA device; w (3, 3, Ci, Co) (made contiguous
    here); Ci and Co multiples of 4 (8 at bf16). Returns (out, yhat,
    stats): out = relu(yhat) and yhat (N, 2H, 2W, Co) of x's type, stats
    (N, 2, Co) = (mu, rstd) fp32, which K-convt-bwd takes."""
    _check_cuda("fused_convt_in_cuda", x, w)
    w = w.contiguous()
    _aligned("fused_convt_in_cuda", x, w)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    tiles = -(-(h * wd) // _BM)
    yhat = torch.empty((n, 2 * h, 2 * wd, co), dtype=x.dtype, device=x.device)
    out = torch.empty_like(yhat)
    part = torch.empty((n * 4 * tiles, 2, co), **f32)
    stats = torch.empty((n, 2, co), **f32)
    if x.dtype == torch.bfloat16:
        _build.op("convt_in_fwd_bf16")(x, w, part, stats, yhat, out, eps)
        fused_convt_in_cuda.launches_bf16 += 1
    else:
        wsplit = torch.empty((2, 9, co, ci), **f32)
        _build.op("convt_in_fwd")(x, w, wsplit, yhat, part, stats, out, eps)
        fused_convt_in_cuda.launches += 1
    return out, yhat, stats


fused_convt_in_cuda.launches = 0
fused_convt_in_cuda.launches_bf16 = 0


def wgrad_splits(pixels: int, ci: int, co: int, bk: int = _BK) -> tuple:
    """(splits, pixels per split) of K-convt-bwd's weight gradient over
    ``pixels`` = N*H*W with Ci -> Co channels, in K slices of ``bk`` pixels
    (32; 64 in the bf16 variant): fixed by the shape, so the sum's order is
    too."""
    tiles = 9 * -(-ci // 128) * -(-co // (64 if co <= 64 else 128))
    splits = max(1, min(-(-pixels // bk), _WGRAD_SLOTS // tiles))
    per = -(-pixels // splits)
    per = -(-per // bk) * bk
    return -(-pixels // per), per


def convt_in_bwd_cuda(x: torch.Tensor, w: torch.Tensor, yhat: torch.Tensor, stats: torch.Tensor,
                      g: torch.Tensor) -> tuple:
    """Launch K-convt-bwd, or its bf16 variant for bf16 x (counted as
    ``fused_convt_in_cuda``'s): (dx, dw), of x's type, of ``fused_convt_in``
    given g = d out and K-convt's saved (yhat, stats), g and yhat of x's
    type. Same layouts and shape rules as ``fused_convt_in_cuda``; dw is
    (3, 3, Ci, Co)."""
    _check_cuda("convt_in_bwd_cuda", x, w)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    for name, t in (("yhat", yhat), ("g", g)):
        if tuple(t.shape) != (n, 2 * h, 2 * wd, co) or t.dtype != x.dtype \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"convt_in_bwd_cuda: {name} must be a contiguous {x.dtype} "
                             f"({n}, {2 * h}, {2 * wd}, {co}) tensor on x's device")
    if tuple(stats.shape) != (n, 2, co) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError(f"convt_in_bwd_cuda: stats {tuple(stats.shape)} {stats.dtype} is not "
                         f"fp32 ({n}, 2, {co})")
    w = w.contiguous()
    bf = x.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=x.device)
    # the bf16 variant's weight gradient takes K slices of 64 pixels
    splits, per = wgrad_splits(n * h * wd, ci, co, 64 if bf else _BK)
    dz = torch.empty_like(yhat)
    part_in = torch.empty((n * -(-(4 * h * wd) // _IN_TILE), 2, co), **f32)
    means = torch.empty((n, 2, co), **f32)
    part_w = torch.empty((splits, 9 * ci, co), **f32)
    dw = torch.empty_like(w)
    dx = torch.empty_like(x)
    _aligned("convt_in_bwd_cuda", x, w, yhat, stats, g)
    if bf:
        _build.op("convt_in_bwd_bf16")(x, w, yhat, stats, g, dz, part_in, means, part_w, dw, dx,
                                       splits, per)
        convt_in_bwd_cuda.launches_bf16 += 1
    else:
        # w split into TF32 big and small parts for the dgrad
        wsplit = torch.empty((2, 9 * ci, co), **f32)
        _build.op("convt_in_bwd")(x, w, yhat, stats, g, wsplit, dz, part_in, means, part_w, dw,
                                  dx, splits, per)
        convt_in_bwd_cuda.launches += 1
    return dx, dw


convt_in_bwd_cuda.launches = 0
convt_in_bwd_cuda.launches_bf16 = 0


def convt_fwd_padded(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> tuple:
    """K-convt (its bf16 variant for bf16 x) at any channel counts: Ci and
    Co zero-padded to multiples of 4 (8 at bf16), the output cut back to Co.
    Returns (out, saved): saved = the padded (x, w) and K-convt's (yhat,
    stats), which ``convt_bwd_padded`` takes."""
    ci, co = w.shape[2], w.shape[3]
    m = _CH_MULT.get(x.dtype, 4)
    pi, po = -ci % m, -co % m
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
        if x.dtype != w.dtype:
            raise TypeError(f"fused_convt_in: x is {x.dtype} and w {w.dtype}: one type for both")
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


# ---------------------------------------------------------------------------
# band form (--mesh_spatial): the decoder stage over this rank's band of the
# frame (``parallel/spatial.py``). Output row 2i reads input row i - 1 (the
# tap ky = 0), so the band takes one halo row from above (zeros at the
# frame's top); its backward's dgrad reads d z row 2i + 2, one halo row of
# d z from below (zeros at the frame's bottom).
# ---------------------------------------------------------------------------
def convt_band_plain(x: torch.Tensor, w: torch.Tensor, band, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``fused_convt_in_band`` (any device, differentiable):
    the transposed conv of the band with its halo row above, its 2H output
    rows kept, the frame's IN + relu; by autograd, or at bf16 the bf16
    variant's roundings forward and backward (``_ConvtBandBf16``)."""
    from nemar_tpu_torch.ops.norm import instance_norm_act_band
    from nemar_tpu_torch.parallel import spatial

    if x.dtype == torch.bfloat16:
        return _ConvtBandBf16.apply(x, w, band, eps)
    h = x.shape[1]
    xp = spatial.exchange_rows(x, band, (1,) * band.size, (0,) * band.size, dim=1,
                               mode="zeros")
    y = convt_flax(xp, w)[:, 2:2 * h + 2]
    return instance_norm_act_band(y, band.up(2), "relu", eps, plain=True)


def convt_band_saved_plain(x: torch.Tensor, w: torch.Tensor, band, eps: float = 1e-5) -> tuple:
    """Plain version of what K-convt's band form saves for its backward,
    (xp, yhat, stats), from ``convt_band_plain``'s values (no gradient): a
    check feeds them to K-convt-bwd's band form, so that the kernel and
    the plain backward take the same relu mask. At bf16 those of
    ``convt_band_fwd_plain_bf16``."""
    from nemar_tpu_torch.ops.norm import in_band_stats
    from nemar_tpu_torch.parallel import spatial

    if x.dtype == torch.bfloat16:
        return convt_band_fwd_plain_bf16(x, w, band, eps)[1]
    h = x.shape[1]
    with torch.no_grad():
        xp = spatial.exchange_rows(x, band, (1,) * band.size, (0,) * band.size, dim=1,
                                   mode="zeros").contiguous()
        y = convt_flax(xp, w)[:, 2:2 * h + 2]
        stats = in_band_stats(y, eps)
        return xp, normalise(y, stats).contiguous(), stats


def convt_band_fwd_plain_bf16(x: torch.Tensor, w: torch.Tensor, band,
                              eps: float = 1e-5) -> tuple:
    """Plain version of K-convt's bf16 band form, rounded as
    ``convt_in_fwd_plain`` rounds at bf16 (yhat and out bf16; the
    convolution of the exact fp32 copies, the frame's statistics fp32):
    -> (out, (xp, yhat, stats))."""
    from nemar_tpu_torch.ops.norm import in_band_stats
    from nemar_tpu_torch.parallel import spatial

    h = x.shape[1]
    with torch.no_grad():
        xp = spatial.exchange_rows(x, band, (1,) * band.size, (0,) * band.size, dim=1,
                                   mode="zeros").contiguous()
        y = convt_flax(xp.float(), w.float())[:, 2:2 * h + 2]
        stats = in_band_stats(y, eps)
        yhat = normalise(y, stats).to(torch.bfloat16).contiguous()
    return torch.clamp_min(yhat, 0.0), (xp, yhat, stats)


def _convt_band_grads(xp: torch.Tensor, dzp: torch.Tensor, w: torch.Tensor) -> tuple:
    """(dx, dw) of the transposed conv over a band, as
    ``convt_in_bwd_plain`` computes them over the frame: xp the band with
    its halo row above (N, H + 1, W, Ci), dzp d z with its halo row below
    (N, 2H + 1, 2W, Co); dw the band's share."""
    n, hp, wd, ci = xp.shape
    h, co = hp - 1, w.shape[-1]
    xq = F.pad(xp, (0, 0, 1, 0))  # a zero column on the left: input offset -1
    dw = xp.new_zeros((3, 3, ci, co))
    for py in (0, 1):
        for px in (0, 1):
            plane = dzp[:, py:2 * h:2, px::2, :].reshape(-1, co)
            for ky, dy in _AX[py]:
                for kx, dx in _AX[px]:
                    slab = xq[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd, :].reshape(-1, ci)
                    dw[ky, kx] = slab.T @ plane
    dzq = F.pad(dzp, (0, 0, 0, 2, 0, 1))
    dx = xp.new_zeros((n, h, wd, ci))
    for ky in range(3):
        for kx in range(3):
            dx += dzq[:, 2 - ky::2, 2 - kx::2, :][:, :h, :wd, :] @ w[ky, kx].T
    return dx, dw


def convt_band_bwd_plain_bf16(xp: torch.Tensor, w: torch.Tensor, yhat: torch.Tensor,
                              stats: torch.Tensor, g: torch.Tensor, band) -> tuple:
    """Plain version of K-convt-bwd's bf16 band form: (dx, dw) of this
    rank's band (dw its share), dz, dx and dw rounded to bf16 as
    ``convt_in_bwd_plain`` rounds at bf16; dz's halo row from below."""
    from nemar_tpu_torch.ops.conv_fused import _in_bwd_band
    from nemar_tpu_torch.parallel import spatial

    f = torch.float32
    yh = yhat.to(f)
    dz = _in_bwd_band(torch.where(yh > 0, g.to(f), 0.0), yh, stats[:, None, None, 1],
                      band.up(2)).to(torch.bfloat16)
    dzp = spatial.exchange_rows(dz, band.up(2), (0,) * band.size, (1,) * band.size, dim=1,
                                mode="zeros")
    dx, dw = _convt_band_grads(xp.to(f), dzp.to(f), w.to(f))
    return dx.to(torch.bfloat16), dw.to(torch.bfloat16)


class _ConvtBandBf16(torch.autograd.Function):
    """The plain bf16 band form, its backward written out as the kernel
    computes it."""

    @staticmethod
    def forward(ctx, x, w, band, eps):
        out, saved = convt_band_fwd_plain_bf16(x, w, band, eps)
        ctx.band = band
        ctx.save_for_backward(saved[0], w, *saved[1:])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dx, dw = convt_band_bwd_plain_bf16(*ctx.saved_tensors, g, ctx.band)
        return dx, dw, None, None


def convt_band_fwd_cuda(xp: torch.Tensor, w: torch.Tensor, band, eps: float = 1e-5) -> tuple:
    """K-convt in band form on the card: xp (N, H + 1, W, Ci) this rank's
    band with its halo row above. Two launches around an all-gather of the
    tile statistics: (1) W's split and the four planes' GEMMs over xp, (2)
    the frame's (mu, rstd) from every rank's tiles and the apply. -> (out,
    yhat, stats). bf16 xp and w launch the bf16 variant's two stages (W^T
    per tap and the planes into an fp32 y; the statistics, yhat and out in
    bf16), counted on ``.launches_bf16`` and ``.stages_bf16``."""
    from nemar_tpu_torch.parallel import spatial

    from nemar_tpu_torch.ops.conv_fused import pad_tiles

    _check_cuda("convt_band_fwd_cuda", xp, w)
    bf = xp.dtype == torch.bfloat16
    n, hp, wd, ci = xp.shape
    h, co = hp - 1, w.shape[3]
    w = w.contiguous()
    f32 = dict(dtype=torch.float32, device=xp.device)
    tiles, most = -(-h * wd // _BM), -(-band.most * wd // _BM)
    hw_all = spatial.band_pixels(band, wd)
    yhat = torch.empty((n, 2 * h, 2 * wd, co), dtype=xp.dtype, device=xp.device)
    out = torch.empty_like(yhat)
    part = torch.empty((n * 4 * tiles, 2, co), **f32)
    stats = torch.empty((n, 2, co), **f32)
    _aligned("convt_band_fwd_cuda", xp, w)
    if bf:
        y = torch.empty((n, 2 * h, 2 * wd, co), **f32)
        _build.launch("nemar_convt_band_planes_bf16", "ppppiiiii", xp, w, y, part,
                      n, h, wd, ci, co)
        parts = spatial.gather_parts(pad_tiles(part, 4 * n, most))
        _build.launch("nemar_convt_band_apply_bf16", "ppppppiiiiiif", parts, stats, hw_all, y,
                      yhat, out, band.size, n, h, wd, most, co, eps)
        convt_band_fwd_cuda.launches_bf16 += 1
        convt_band_fwd_cuda.stages_bf16 += 2
        return out, yhat, stats
    wsplit = torch.empty((2, 9, co, ci), **f32)
    _build.launch("nemar_convt_band_planes", "pppppiiiii", xp, w, wsplit, yhat, part,
                  n, h, wd, ci, co)
    parts = spatial.gather_parts(pad_tiles(part, 4 * n, most))
    _build.launch("nemar_convt_band_apply", "pppppiiiiiif", parts, stats, hw_all, yhat, out,
                  band.size, n, h, wd, most, co, eps)
    convt_band_fwd_cuda.launches += 1
    convt_band_fwd_cuda.stages += 2
    return out, yhat, stats


convt_band_fwd_cuda.launches = 0
convt_band_fwd_cuda.stages = 0
convt_band_fwd_cuda.launches_bf16 = 0
convt_band_fwd_cuda.stages_bf16 = 0


def convt_band_bwd_cuda(xp: torch.Tensor, w: torch.Tensor, yhat: torch.Tensor,
                        stats: torch.Tensor, g: torch.Tensor, band) -> tuple:
    """K-convt-bwd in band form on the card: (dx, dw) of this rank's band
    (dw its share). Three launches: (1) the IN backward's partials; an
    all-gather; (2) their merge over every rank (and W's split) and dz; the
    halo row of dz from below; (3) dW's partials and their sum, and the
    dgrad over dz with its halo row. bf16 operands launch the bf16
    variant's three stages (dz, dw, dx bf16; W read as it lies)."""
    from nemar_tpu_torch.ops.conv_fused import pad_tiles
    from nemar_tpu_torch.parallel import spatial

    n, hp, wd, ci = xp.shape
    h, co = hp - 1, w.shape[3]
    up = band.up(2)
    if h == 0:  # an empty band: no launch, its share of the collectives
        spatial.gather_parts(torch.zeros((n * -(-(4 * band.most * wd) // _IN_TILE), 2, co),
                                         dtype=torch.float32, device=xp.device))
        spatial.exchange_rows(g, up, (0,) * band.size, (1,) * band.size, dim=1, mode="zeros")
        return xp.new_empty((n, 0, wd, ci)), torch.zeros_like(w)
    w = w.contiguous()
    g = g.contiguous()
    bf = xp.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=xp.device)
    splits, per = wgrad_splits(n * h * wd, ci, co, 64 if bf else _BK)
    most, pixels = -(-(4 * band.most * wd) // _IN_TILE), 4 * band.height * wd
    part_in = torch.empty((n * -(-(4 * h * wd) // _IN_TILE), 2, co), **f32)
    means = torch.empty((n, 2, co), **f32)
    dz = torch.empty_like(yhat)
    part_w = torch.empty((splits, 9 * ci, co), **f32)
    dw, dx = torch.empty_like(w), torch.empty((n, h, wd, ci), dtype=xp.dtype, device=xp.device)
    _aligned("convt_band_bwd_cuda", xp, w, yhat, stats, g)
    if bf:
        _build.launch("nemar_convt_band_bwd_part_bf16", "pppiiii", g, yhat, part_in, n, h, wd,
                      co)
        parts = spatial.gather_parts(pad_tiles(part_in, n, most))
        _build.launch("nemar_convt_band_bwd_dz_bf16", "ppppppiiliiii", parts, means, g, yhat,
                      stats, dz, band.size, most, pixels, n, h, wd, co)
        dzp = spatial.exchange_rows(dz, up, (0,) * band.size, (1,) * band.size, dim=1,
                                    mode="zeros").contiguous()
        _build.launch("nemar_convt_band_bwd_dx_bf16", "ppppppiiiiiii", xp, dzp, w, part_w, dw,
                      dx, n, h, wd, ci, co, splits, per)
        convt_band_bwd_cuda.launches_bf16 += 1
        convt_band_bwd_cuda.stages_bf16 += 3
        return dx, dw
    wsplit = torch.empty((2, 9 * ci, co), **f32)
    _build.launch("nemar_convt_band_bwd_part", "pppiiii", g, yhat, part_in, n, h, wd, co)
    parts = spatial.gather_parts(pad_tiles(part_in, n, most))
    _build.launch("nemar_convt_band_bwd_dz", "ppppppppiiliiiii", parts, means, g, yhat, stats,
                  dz, w, wsplit, band.size, most, pixels, n, h, wd, ci, co)
    dzp = spatial.exchange_rows(dz, up, (0,) * band.size, (1,) * band.size, dim=1,
                                mode="zeros").contiguous()
    _build.launch("nemar_convt_band_bwd_dx", "ppppppiiiiiii", xp, dzp, wsplit, part_w, dw, dx,
                  n, h, wd, ci, co, splits, per)
    convt_band_bwd_cuda.launches += 1
    convt_band_bwd_cuda.stages += 3
    return dx, dw


convt_band_bwd_cuda.launches = 0
convt_band_bwd_cuda.stages = 0
convt_band_bwd_cuda.launches_bf16 = 0
convt_band_bwd_cuda.stages_bf16 = 0


class _FusedConvtInBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, band, eps):
        from nemar_tpu_torch.parallel import spatial

        ci, co = w.shape[2], w.shape[3]
        m = _CH_MULT.get(x.dtype, 4)
        pi, po = -ci % m, -co % m
        if pi or po:
            x, w = F.pad(x, (0, pi)), F.pad(w, (0, po, 0, pi))
        xp = spatial.exchange_rows(x.contiguous(), band, (1,) * band.size, (0,) * band.size,
                                   dim=1, mode="zeros").contiguous()
        out, yhat, stats = convt_band_fwd_cuda(xp, w, band, eps)
        ctx.band, ctx.ci, ctx.co = band, ci, co
        ctx.save_for_backward(xp, w, yhat, stats)
        return out[..., :co].contiguous() if po else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xp, w, yhat, stats = ctx.saved_tensors
        if w.shape[3] != ctx.co:
            g = F.pad(g, (0, w.shape[3] - ctx.co))
        dx, dw = convt_band_bwd_cuda(xp, w, yhat, stats, g, ctx.band)
        return dx[..., :ctx.ci], dw[:, :, :ctx.ci, :ctx.co], None, None


def fused_convt_in_band(x: torch.Tensor, w: torch.Tensor, band,
                        eps: float = 1e-5) -> torch.Tensor:
    """``fused_convt_in`` of the frame of which the NHWC x is this rank's
    band (``parallel.spatial.Band``): the output is the band of the 2H-row
    frame (``band.up(2)``). K-convt's and K-convt-bwd's band forms on the
    card (their bf16 variants' for bf16 x and w), ``convt_band_plain`` on
    the CPU."""
    if x.is_cuda:
        return _FusedConvtInBand.apply(x, w, band, eps)
    return convt_band_plain(x, w, band, eps)
