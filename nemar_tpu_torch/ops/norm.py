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

the JAX package's analytic backward (``_in_act_vjp_bwd``).
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


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, 2, C) = (mean, rstd) per (sample, channel) of an NHWC tensor."""
    mean = x.mean(dim=(1, 2))
    var = torch.square(x - mean[:, None, None]).mean(dim=(1, 2))  # biased
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def normalise(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    return (x - stats[:, None, None, 0]) * stats[:, None, None, 1]


def instance_norm_act_plain(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version of ``instance_norm_act`` (any device)."""
    return _apply_act(instance_norm(x, eps), act, negative_slope)


def instance_norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                                act: str = "relu", negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K-in-bwd: d x of ``instance_norm_act`` given g = d y
    and the forward's stats (N, 2, C) = (mean, rstd)."""
    y = normalise(x, stats)
    if act == "relu":
        g = torch.where(y > 0, g, 0.0)
    elif act == "leaky_relu":
        g = torch.where(y >= 0, g, negative_slope * g)
    elif act != "none":
        raise ValueError(f"unknown act: {act!r}")
    m1 = g.mean(dim=(1, 2), keepdim=True)
    m2 = (g * y).mean(dim=(1, 2), keepdim=True)
    return stats[:, None, None, 1] * (g - m1 - y * m2)


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, act, eps, negative_slope):
        if x.is_cuda:
            y, stats = norm_cuda.instance_norm_act_cuda(x, act, eps, negative_slope)
        else:
            stats = instance_norm_stats(x, eps)
            y = _apply_act(normalise(x, stats), act, negative_slope)
        ctx.act, ctx.negative_slope = act, negative_slope
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        if x.is_cuda:
            dx = norm_cuda.instance_norm_act_bwd_cuda(x, g.contiguous(), stats, ctx.act,
                                                      ctx.negative_slope)
        else:
            dx = instance_norm_act_bwd_plain(x, g, stats, ctx.act, ctx.negative_slope)
        return dx, None, None, None


def instance_norm_act(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Fused instance norm + activation of an NHWC tensor, differentiable."""
    if act not in ("none", "relu", "leaky_relu"):
        raise ValueError(f"unknown act: {act!r}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"instance_norm_act: unsupported device {x.device}")
    return _InstanceNormAct.apply(x, act, eps, negative_slope)
