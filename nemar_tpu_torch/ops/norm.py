"""Instance normalisation + activation.

Counterpart of ``nemar_tpu/ops/norm.py``: per-(sample, channel) statistics
over the spatial axes of an NHWC tensor, biased variance, eps 1e-5, no
affine (the reference's ``InstanceNorm2d`` configuration), then 'none',
'relu' or 'leaky_relu' (slope 0.2):

    y = act((x - mean) / sqrt(var + eps))

``instance_norm_act`` is a ``torch.autograd.Function`` that dispatches on
the device: a CPU tensor takes the plain versions (``instance_norm_stats``
+ the activation forward, ``instance_norm_act_bwd_plain`` backward); a CUDA
tensor launches the CUDA kernels K-in (forward, which replaces the TPU
kernel ``nemar_tpu/ops/norm.py:_instance_norm_act_pallas``) and K-in-bwd
(``ops/norm_cuda.py``, ``csrc/in_act_{fwd,bwd}.cu``), one launch each. The
forward saves x and the (mean, rstd) it computed, so the backward does not
recompute them:

    dx = rstd * (ĝ - mean(ĝ) - ŷ * mean(ĝ * ŷ)),   ĝ = g * act'(ŷ),

the JAX package's analytic backward (``_in_act_vjp_bwd``). That backward
is itself a differentiable function of (x, g), ``_InstanceNormActBwd``: its
forward is K-in-bwd on the card, its backward the VJP of
``instance_norm_act_bwd_recompute``, which recomputes the statistics from x
as ``_in_act_vjp_bwd`` does, so a double backward (the WGAN-GP penalty's,
through D) keeps the terms through the mean and the variance. The JAX
package takes that second derivative with XLA's autodiff, not with a Pallas
kernel, and so does this one with stock torch ops. The activation's mask is
piecewise constant and adds no term of its own.

Under ``--bf16`` x is bfloat16, and so are y, g and d x, as in the JAX
package (``_in_act_kernel`` and ``_in_act_vjp_bwd`` store the activation's
dtype): the statistics, the sums and the arithmetic are fp32 whatever the
activation's type (``nemar_tpu/ops/norm.py:131``), and each output is
rounded to bf16 once, where it is stored. K-in and K-in-bwd have bf16
variants that do the same; the plain versions upcast x and g to fp32
(exact), compute, and round the result. The statistics stay fp32.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.ops import norm_cuda


def _apply_act(y: torch.Tensor, act: str, negative_slope: float) -> torch.Tensor:
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0.0, y, negative_slope * y)
    raise ValueError(f"unknown act: {act!r}")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalisation over the spatial dims, NHWC."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x - mean).mean(dim=(1, 2), keepdim=True)  # biased
    return (x - mean) * torch.rsqrt(var + eps)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x as the arithmetic sees it: fp32 for a bf16 tensor (an exact cast;
    torch's CPU reductions of a bf16 tensor would return bf16), else x."""
    return x.float() if x.dtype == torch.bfloat16 else x


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, 2, C) = (mean, rstd) per (sample, channel) of an NHWC tensor, in
    fp32 for a bf16 x."""
    x = _wide(x)
    mean = x.mean(dim=(1, 2))
    var = torch.square(x - mean[:, None, None]).mean(dim=(1, 2))  # biased
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def normalise(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    return (x - stats[:, None, None, 0]) * stats[:, None, None, 1]


def instance_norm_act_plain(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version of ``instance_norm_act`` (any device); a bf16 x
    is normalised in fp32 and the result rounded to bf16."""
    return _apply_act(instance_norm(_wide(x), eps), act, negative_slope).to(x.dtype)


def _act_grad(y: torch.Tensor, g: torch.Tensor, act: str, negative_slope: float) -> torch.Tensor:
    """g = d act(y) through the activation's mask at y, taken as a constant
    (it is piecewise constant)."""
    if act == "relu":
        return torch.where(y > 0, g, 0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0, g, negative_slope * g)
    if act != "none":
        raise ValueError(f"unknown act: {act!r}")
    return g


def _spatial_mean(t: torch.Tensor) -> torch.Tensor:
    return t.mean(dim=(1, 2), keepdim=True)


def _in_act_bwd(x, g, mean, rstd, act: str, negative_slope: float,
                frame_mean=_spatial_mean) -> torch.Tensor:
    """d x of act((x - mean) * rstd) given g = d y, the activation's mask
    taken as a constant (it is piecewise constant); ``frame_mean`` takes the
    per-(sample, channel) means (of the whole frame, for a band)."""
    y = (x - mean) * rstd
    g = _act_grad(y.detach(), g, act, negative_slope)
    m1 = frame_mean(g)
    m2 = frame_mean(g * y)
    return rstd * (g - m1 - y * m2)


def instance_norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                                act: str = "relu", negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K-in-bwd: d x of ``instance_norm_act`` given g = d y
    and the forward's stats (N, 2, C) = (mean, rstd); bf16 x and g give a
    bf16 d x, computed in fp32."""
    return _in_act_bwd(_wide(x), _wide(g), stats[:, None, None, 0], stats[:, None, None, 1],
                       act, negative_slope).to(x.dtype)


def instance_norm_act_bwd_recompute(x: torch.Tensor, g: torch.Tensor, act: str = "relu",
                                    eps: float = 1e-5, negative_slope: float = 0.2,
                                    band=None) -> torch.Tensor:
    """``instance_norm_act_bwd_plain`` with the statistics recomputed from x
    (the JAX package's ``_in_act_vjp_bwd``): differentiable in x and g; in
    fp32 for bf16 x and g, the result rounded to their type. With ``band``
    (x and g this rank's band of their frames) d x of the band: the frame's
    statistics and the frame means of ĝ and ĝ·ŷ summed over the spatial
    group (``spatial.group_sum``, differentiable), so the terms through the
    whole frame's mean and variance reach every rank."""
    dtype = x.dtype
    x, g = _wide(x), _wide(g)
    frame_mean = _spatial_mean
    if band is not None:
        from nemar_tpu_torch.parallel import spatial

        count = x.shape[2] * band.height

        def frame_mean(t):
            return spatial.group_sum(t.sum(dim=(1, 2), keepdim=True)) / count

    mean = frame_mean(x)
    rstd = torch.rsqrt(frame_mean(torch.square(x - mean)) + eps)
    return _in_act_bwd(x, g, mean, rstd, act, negative_slope, frame_mean).to(dtype)


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, act, eps, negative_slope):
        if x.is_cuda:
            launch = (norm_cuda.instance_norm_act_bf16_cuda if x.dtype == torch.bfloat16
                      else norm_cuda.instance_norm_act_cuda)
            y, stats = launch(x, act, eps, negative_slope)
        else:
            stats = instance_norm_stats(x, eps)
            y = _apply_act(normalise(_wide(x), stats), act, negative_slope).to(x.dtype)
        ctx.act, ctx.eps, ctx.negative_slope = act, eps, negative_slope
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        return (_InstanceNormActBwd.apply(x, stats, g, ctx.act, ctx.eps, ctx.negative_slope),
                None, None, None)


class _InstanceNormActBwd(torch.autograd.Function):
    """(x, stats, g) -> d x: K-in-bwd on the card, the plain version on the
    CPU; its own backward recomputes the statistics from x (stats carries
    no gradient: it is a value of x)."""

    @staticmethod
    def forward(ctx, x, stats, g, act, eps, negative_slope):
        if x.dtype != g.dtype:
            raise TypeError(f"instance_norm_act backward: x is {x.dtype} and g {g.dtype}")
        if x.is_cuda:
            launch = (norm_cuda.instance_norm_act_bwd_bf16_cuda if x.dtype == torch.bfloat16
                      else norm_cuda.instance_norm_act_bwd_cuda)
            dx = launch(x, g.contiguous(), stats, act, negative_slope)
        else:
            dx = instance_norm_act_bwd_plain(x, g, stats, act, negative_slope)
        ctx.act, ctx.eps, ctx.negative_slope = act, eps, negative_slope
        ctx.save_for_backward(x, g)
        return dx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gg):
        x, g = ctx.saved_tensors
        with torch.enable_grad():
            x, g = x.detach().requires_grad_(), g.detach().requires_grad_()
            dx = instance_norm_act_bwd_recompute(x, g, ctx.act, ctx.eps, ctx.negative_slope)
            ddx, dg = torch.autograd.grad(dx, (x, g), gg)
        return ddx, None, dg, None, None, None


def instance_norm_act(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Fused instance norm + activation of an NHWC tensor, differentiable."""
    if act not in ("none", "relu", "leaky_relu"):
        raise ValueError(f"unknown act: {act!r}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"instance_norm_act: unsupported device {x.device}")
    return _InstanceNormAct.apply(x, act, eps, negative_slope)


# ---------------------------------------------------------------------------
# band form (--mesh_spatial): the statistics of the whole frame of which x
# is this rank's band (``parallel/spatial.py``)
# ---------------------------------------------------------------------------
def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The statistics' type for activations of x's: fp32 for bf16, else x's."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def in_band_part_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K-in's band partials, one chunk a band: (N, 1, 3, C)
    float64 = (count, mean, M2) of the band (an empty band's all 0)."""
    xd = x.double()
    n, h, w, c = x.shape
    mean = xd.sum(dim=(1, 2)) / max(h * w, 1)
    m2 = torch.square(xd - mean[:, None, None]).sum(dim=(1, 2))
    return torch.stack([torch.full_like(mean, h * w), mean, m2], dim=1)[:, None]


def in_band_stats_plain(parts: torch.Tensor, eps: float) -> torch.Tensor:
    """(mean, rstd) (N, 2, C) in float64 from every rank's partials (ranks,
    N, chunks, 3, C), merged in rank then chunk order (Chan's formula)."""
    count, mean_t, m2_t = parts[:, :, :, 0], parts[:, :, :, 1], parts[:, :, :, 2]
    total = count.sum(dim=(0, 2))
    mean = (count * mean_t).sum(dim=(0, 2)) / total
    m2 = (m2_t + count * torch.square(mean_t - mean[None, :, None])).sum(dim=(0, 2))
    return torch.stack([mean, 1.0 / torch.sqrt(m2 / total + eps)], dim=1)


def in_band_stats(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(mean, rstd) (N, 2, C) of the frame of which the NHWC x is this
    rank's band, in x's type (fp32 for a bf16 x): every rank's plain
    partials, all-gathered over the spatial group, merged (no gradient)."""
    from nemar_tpu_torch.parallel import spatial

    return in_band_stats_plain(spatial.gather_parts(in_band_part_plain(x)), eps).to(
        _stats_dtype(x))


def in_band_bwd_part_plain(x, g, stats, act: str, slope: float) -> torch.Tensor:
    """Plain version of K-in-bwd's band partials: (N, 1, 2, C) float64 =
    the band's sums of gh and gh * yhat (bf16 x and g widened to fp32)."""
    yh = normalise(_wide(x), stats)
    gh = _act_grad(yh, _wide(g), act, slope)
    return torch.stack([gh.double().sum(dim=(1, 2)), (gh * yh).double().sum(dim=(1, 2))],
                       dim=1)[:, None]


def in_band_bwd_apply_plain(x, g, stats, parts, frame_pixels: int, act: str,
                            slope: float) -> torch.Tensor:
    """Plain version of K-in-bwd's band apply: the frame's means from every
    rank's partials, then d x of the band (computed in fp32 and rounded for
    bf16 x and g)."""
    m = (parts.sum(dim=(0, 2)) / frame_pixels).to(_stats_dtype(x))
    y = normalise(_wide(x), stats)
    return (stats[:, None, None, 1] * (_act_grad(y, _wide(g), act, slope) - m[:, None, None, 0]
                                       - y * m[:, None, None, 1])).to(x.dtype)


class _InstanceNormActBand(torch.autograd.Function):
    """K-in / K-in-bwd on a band: partials, an all-gather over the spatial
    group, a merge in one fixed order and the apply. On the card the band
    launches of ``csrc/in_band.cu``; on the CPU (or ``plain``) the plain
    versions, one partial a band."""

    @staticmethod
    def forward(ctx, x, band, act, eps, slope, plain):
        from nemar_tpu_torch.parallel import spatial

        cuda = x.is_cuda and not plain
        n, h, w, c = x.shape
        ctx.chunks = norm_cuda.band_chunks(band.most * w)
        if cuda:
            parts = spatial.gather_parts(norm_cuda.in_band_part_cuda(x, ctx.chunks))
            y, stats = norm_cuda.in_band_apply_cuda(x, parts, act, eps, slope)
        else:
            stats = in_band_stats(x, eps)
            y = _apply_act(normalise(_wide(x), stats), act, slope).to(x.dtype)
        ctx.band, ctx.act, ctx.eps, ctx.slope, ctx.cuda = band, act, eps, slope, cuda
        ctx.frame_pixels = band.height * w
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        dx = _InstanceNormActBandBwd.apply(x, stats, g, ctx.band, ctx.act, ctx.eps, ctx.slope,
                                           ctx.cuda, ctx.chunks, ctx.frame_pixels)
        return dx, None, None, None, None, None


class _InstanceNormActBandBwd(torch.autograd.Function):
    """(x, stats, g) -> d x of the band, as ``_InstanceNormActBwd`` is of the
    frame: K-in-bwd's band stages on the card (partials, the all-gather,
    the merge and apply), the plain versions on the CPU. Its own backward is
    the VJP of ``instance_norm_act_bwd_recompute`` of the band: stock ops
    whose frame sums go through the differentiable all-gather (the WGAN-GP
    penalty's double backward through D under --mesh_spatial)."""

    @staticmethod
    def forward(ctx, x, stats, g, band, act, eps, slope, cuda, chunks, frame_pixels):
        from nemar_tpu_torch.parallel import spatial

        g = g.contiguous()
        if cuda:
            part = norm_cuda.in_band_bwd_part_cuda(x, g, stats, chunks, act, slope)
            parts = spatial.gather_parts(part)
            dx = norm_cuda.in_band_bwd_apply_cuda(x, g, stats, parts, frame_pixels, act, slope)
        else:
            parts = spatial.gather_parts(in_band_bwd_part_plain(x, g, stats, act, slope))
            dx = in_band_bwd_apply_plain(x, g, stats, parts, frame_pixels, act, slope)
        ctx.band, ctx.act, ctx.eps, ctx.slope = band, act, eps, slope
        ctx.save_for_backward(x, g)
        return dx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gg):
        x, g = ctx.saved_tensors
        with torch.enable_grad():
            x, g = x.detach().requires_grad_(), g.detach().requires_grad_()
            dx = instance_norm_act_bwd_recompute(x, g, ctx.act, ctx.eps, ctx.slope, ctx.band)
            ddx, dg = torch.autograd.grad(dx, (x, g), gg)
        return ddx, None, dg, None, None, None, None, None, None, None


def instance_norm_act_band(x: torch.Tensor, band, act: str = "relu", eps: float = 1e-5,
                           negative_slope: float = 0.2, plain: bool = False) -> torch.Tensor:
    """``instance_norm_act`` of the frame of which the NHWC x is this rank's
    band (``parallel.spatial.Band``): the frame's statistics. Differentiable
    twice: the backward (K-in-bwd's band stages) is a Function whose own
    backward recomputes it in stock ops (the WGAN-GP penalty's double
    backward). A bf16 x gives a bf16 y (and d x), the statistics and
    the arithmetic fp32, as ``instance_norm_act``'s bf16 variant. ``plain``
    takes the plain versions on the card too (the kernels' comparison)."""
    if act not in ("none", "relu", "leaky_relu"):
        raise ValueError(f"unknown act: {act!r}")
    return _InstanceNormActBand.apply(x.contiguous(), band, act, eps, negative_slope, plain)
