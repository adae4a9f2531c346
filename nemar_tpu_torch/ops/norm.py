"""Instance normalisation + activation.

Counterpart of ``nemar_tpu/ops/norm.py``: per-(sample, channel) statistics
over the spatial axes of an NHWC tensor, biased variance, eps 1e-5, no
affine (the reference's ``InstanceNorm2d`` configuration), then 'none',
'relu' or 'leaky_relu' (slope 0.2):

    y = act((x - mean) / sqrt(var + eps))

``instance_norm_act`` dispatches on the device: a CPU tensor takes
``instance_norm_act_plain``; a CUDA tensor launches the Triton kernel K-in
(``ops/norm_triton.py``), which replaces the TPU kernel
``nemar_tpu/ops/norm.py:_instance_norm_act_pallas``.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.ops import norm_triton


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


def instance_norm_act_plain(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version of ``instance_norm_act`` (any device)."""
    return _apply_act(instance_norm(x, eps), act, negative_slope)


def instance_norm_act(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Fused instance norm + activation of an NHWC tensor."""
    if x.is_cuda:
        return norm_triton.instance_norm_act_triton(x, act, eps, negative_slope)
    if x.device.type != "cpu":
        raise ValueError(f"instance_norm_act: unsupported device {x.device}")
    return instance_norm_act_plain(x, act, eps, negative_slope)
