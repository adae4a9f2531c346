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


# ---------------------------------------------------------------------------
# band form (--mesh_spatial): csrc/in_band.cu, two launches a direction with
# the caller's all-gather of the partials between them. A bf16 x (and g)
# launches the bf16 variant's stages (``*_bf16``: y and d x bf16, the
# statistics fp32, the partials fp64), counted on ``.launches_bf16``.
# ---------------------------------------------------------------------------
BAND_CHUNK = 256  # pixels of a band's partial


def band_chunks(hw_most: int) -> int:
    """Partials per sample: the largest band's pixels in chunks of
    BAND_CHUNK (one count for every rank, so the partials gather)."""
    return max(1, -(-hw_most // BAND_CHUNK))


def _check_band(what: str, x: torch.Tensor, *tensors) -> str:
    """The stage's launcher suffix: '' for fp32 x, '_bf16' for bf16 x (the
    other activations of x's type, the statistics fp32)."""
    for t in (x, *tensors):
        if not t.is_cuda or not t.is_contiguous() or t.dtype not in (torch.float32,
                                                                     torch.bfloat16):
            raise ValueError(f"{what}: takes contiguous float32 or bfloat16 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
    return "_bf16" if x.dtype == torch.bfloat16 else ""


def _count(fn, tag: str) -> None:
    if tag:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def in_band_part_cuda(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """K-in band form, stage 1: x (N, H, W, C), a band -> part (N, chunks,
    3, C) float64, each chunk's (count, mean, M2)."""
    tag = _check_band("in_band_part_cuda", x)
    n, h, w, c = x.shape
    part = torch.empty((n, chunks, 3, c), dtype=torch.float64, device=x.device)
    _build.launch("nemar_in_band_fwd_part" + tag, "ppiiiii", x, part, n, h * w, c, BAND_CHUNK,
                  chunks)
    _count(in_band_part_cuda, tag)
    return part


in_band_part_cuda.launches = 0
in_band_part_cuda.launches_bf16 = 0


def in_band_apply_cuda(x: torch.Tensor, parts: torch.Tensor, act: str, eps: float,
                       slope: float) -> tuple:
    """K-in band form, stage 2: every rank's partials (ranks, N, chunks, 3,
    C) merged in one fixed order, applied -> (y, stats (N, 2, C))."""
    tag = _check_band("in_band_apply_cuda", x)
    n, h, w, c = x.shape
    ranks, chunks = parts.shape[0], parts.shape[2]
    y = torch.empty_like(x)
    stats = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    _build.launch("nemar_in_band_fwd_apply" + tag, "ppppiiiiiiff", x, parts.contiguous(), y,
                  stats, ranks, n, h * w, c, chunks, _ACT_CODE[act], eps, slope)
    _count(in_band_apply_cuda, tag)
    return y, stats


in_band_apply_cuda.launches = 0
in_band_apply_cuda.launches_bf16 = 0


def in_band_bwd_part_cuda(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, chunks: int,
                          act: str, slope: float) -> torch.Tensor:
    """K-in-bwd band form, stage 1: -> part (N, chunks, 2, C) float64, each
    chunk's sums of gh and gh * yhat."""
    tag = _check_band("in_band_bwd_part_cuda", x, g, stats)
    n, h, w, c = x.shape
    part = torch.empty((n, chunks, 2, c), dtype=torch.float64, device=x.device)
    _build.launch("nemar_in_band_bwd_part" + tag, "ppppiiiiiif", x, g, stats, part, n, h * w, c,
                  BAND_CHUNK, chunks, _ACT_CODE[act], slope)
    _count(in_band_bwd_part_cuda, tag)
    return part


in_band_bwd_part_cuda.launches = 0
in_band_bwd_part_cuda.launches_bf16 = 0


def in_band_bwd_apply_cuda(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                           parts: torch.Tensor, frame_pixels: int, act: str,
                           slope: float) -> torch.Tensor:
    """K-in-bwd band form, stage 2: the means over the frame's
    ``frame_pixels`` from every rank's partials, then d x of the band."""
    tag = _check_band("in_band_bwd_apply_cuda", x, g, stats)
    n, h, w, c = x.shape
    ranks, chunks = parts.shape[0], parts.shape[2]
    dx = torch.empty_like(x)
    _build.launch("nemar_in_band_bwd_apply" + tag, "pppppiiiiilif", x, g, stats,
                  parts.contiguous(), dx, ranks, n, h * w, c, chunks, frame_pixels,
                  _ACT_CODE[act], slope)
    _count(in_band_bwd_apply_cuda, tag)
    return dx


in_band_bwd_apply_cuda.launches = 0
in_band_bwd_apply_cuda.launches_bf16 = 0
