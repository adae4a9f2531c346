"""K-in and K-in-bwd: the CUDA kernels of fused instance norm + activation.

K-in (``csrc/in_act_fwd.cu``) replaces the TPU kernel
``nemar_tpu/ops/norm.py:_instance_norm_act_pallas`` (``_in_act_kernel``):
per-(n, c) mean and rstd over H*W (biased variance), then 'none' / 'relu' /
'leaky_relu'. It also returns (mean, rstd), which the backward reuses.
K-in-bwd (``csrc/in_act_bwd.cu``) computes the JAX package's analytic
backward (``nemar_tpu/ops/norm.py:_in_act_vjp_bwd``, plain XLA there):

    dx = rstd * (ĝ - mean(ĝ) - ŷ * mean(ĝ * ŷ)),   ŷ = (x - mean) * rstd,
    ĝ = g * act'(ŷ).

Each is one cooperative launch (partial sums, a grid barrier, a
fixed-order fp64 merge, a grid barrier, the apply) behind its own PyTorch
operator, ``torch.ops.nemar.in_act_fwd`` / ``in_act_bwd`` (``csrc/ops.cpp``;
``in_act_fwd_bf16`` / ``in_act_bwd_bf16`` for the bf16 variants, each
refusing a tensor of another type by name), which checks the operands,
allocates the outputs and the workspace, and computes the work split in C++. These wrappers only refuse tensors off the
card, map the activation to the operator's code and count the launches.

Each kernel has an fp32 and a bf16 variant (``--bf16``: x, y, g and d x in
bfloat16, the statistics, sums and arithmetic in fp32, each output rounded
once where it is stored), one template instantiated for each type, with its
own wrapper and count: ``instance_norm_act_cuda`` and
``instance_norm_act_bf16_cuda``, ``instance_norm_act_bwd_cuda`` and
``instance_norm_act_bwd_bf16_cuda``.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.ops import _build

_ACT_CODE = {"none": 0, "relu": 1, "leaky_relu": 2}


def _check(what: str, x: torch.Tensor, act: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: x is on {x.device}, not on a CUDA device")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown act: {act!r}")


def instance_norm_act_cuda(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                           negative_slope: float = 0.2) -> tuple:
    """Launch K-in. x (N, H, W, C) fp32 contiguous on a CUDA device ->
    (y of x's shape, stats (N, 2, C) = (mean, rstd))."""
    _check("instance_norm_act_cuda", x, act)
    y, stats = _build.op("in_act_fwd")(x, _ACT_CODE[act], eps, negative_slope)
    instance_norm_act_cuda.launches += 1
    return y, stats


instance_norm_act_cuda.launches = 0


def instance_norm_act_bf16_cuda(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                                negative_slope: float = 0.2) -> tuple:
    """Launch K-in's bf16 variant: x (N, H, W, C) bf16 -> (y bf16, stats
    (N, 2, C) fp32)."""
    _check("instance_norm_act_bf16_cuda", x, act)
    y, stats = _build.op("in_act_fwd_bf16")(x, _ACT_CODE[act], eps, negative_slope)
    instance_norm_act_bf16_cuda.launches += 1
    return y, stats


instance_norm_act_bf16_cuda.launches = 0


def instance_norm_act_bwd_cuda(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                               act: str = "relu", negative_slope: float = 0.2) -> torch.Tensor:
    """Launch K-in-bwd: d x of ``instance_norm_act`` given g = d y (both
    (N, H, W, C) fp32 contiguous on one CUDA device) and the forward's stats
    (N, 2, C) fp32."""
    _check("instance_norm_act_bwd_cuda", x, act)
    dx = _build.op("in_act_bwd")(x, g, stats, _ACT_CODE[act], negative_slope)
    instance_norm_act_bwd_cuda.launches += 1
    return dx


instance_norm_act_bwd_cuda.launches = 0


def instance_norm_act_bwd_bf16_cuda(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                                    act: str = "relu",
                                    negative_slope: float = 0.2) -> torch.Tensor:
    """Launch K-in-bwd's bf16 variant: x and g bf16, stats fp32 -> d x bf16."""
    _check("instance_norm_act_bwd_bf16_cuda", x, act)
    dx = _build.op("in_act_bwd_bf16")(x, g, stats, _ACT_CODE[act], negative_slope)
    instance_norm_act_bwd_bf16_cuda.launches += 1
    return dx


instance_norm_act_bwd_bf16_cuda.launches = 0
