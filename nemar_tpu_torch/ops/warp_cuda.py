"""Wrappers of the CUDA kernels K-warp (``csrc/warp_fwd.cu``) and K-warp-bwd
(``csrc/warp_bwd.cu``).

They replace the TPU kernels ``nemar_tpu/ops/warp_pallas.py:_fwd_pallas``
and ``_bwd_pallas`` (through ``_warp_core`` and its custom VJP). K-warp
samples an NHWC fp32 image bilinearly at a normalised grid, with the
padding mode and ``align_corners`` applied in the kernel (zeros-padded
taps). K-warp-bwd takes the same image and grid and g = d out, and returns
the gradient with respect to the image (first ``grad_channels`` channels)
and to the grid, the coordinate transform's derivative included.

Both launch through their PyTorch operators (``csrc/ops.cpp``), which do
the checks and the allocation in C++: at batch 1 a call's device time is a
few microseconds, so the host's cost per call is what the caller waits for.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.ops import _build

PADDING_MODES = {"zeros": 0, "border": 1, "reflection": 2}
# torch.ops.nemar.warp_grid and warp_grid_bwd, once the library is loaded
_warp_grid = None
_warp_grid_bwd = None


def _refuse(what: str, tensors: dict) -> None:
    """Raise on the first tensor the kernel cannot take (the slow path of
    the wrappers' one-line check)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not contiguous")
        if t.device != first.device:
            raise ValueError(f"{what}: inputs on different devices")


def _usable(*tensors) -> bool:
    dev = tensors[0].device
    return all(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous() and t.device == dev
               for t in tensors)


def warp_bilinear(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                  align_corners: bool = False) -> torch.Tensor:
    """Launch K-warp: img (N, H, W, C) sampled at grid (N, Ho, Wo, 2), (x, y)
    normalised to [-1, 1] -> (N, Ho, Wo, C).

    CUDA tensors only, both fp32. The checks, the allocation and the launch
    are the C++ operator ``torch.ops.nemar.warp_grid`` (``csrc/ops.cpp``),
    which raises on what the kernel does not take.
    """
    if not img.is_cuda:
        _refuse("warp_bilinear", {"img": img, "grid": grid})
    padding = PADDING_MODES.get(padding_mode)
    if padding is None:
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    out = (_warp_grid or _load_warp_grid())(img, grid, padding, align_corners)
    warp_bilinear.launches += 1
    return out


def _load_warp_grid():
    global _warp_grid
    _warp_grid = _build.op("warp_grid")
    return _warp_grid


warp_bilinear.launches = 0


def warp_grid_bwd(img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor,
                  padding_mode: str = "zeros", align_corners: bool = False,
                  grad_channels: int = -1) -> tuple:
    """Launch K-warp-bwd: (d img or None, d grid) of ``warp_bilinear(img,
    grid, padding_mode, align_corners)`` given g = d out (N, Ho, Wo, C).

    d img covers the first ``grad_channels`` channels (-1: all), the rest
    are exact zeros; with ``grad_channels == 0`` it is not computed and None
    is returned. d grid takes the padding mode's derivative with the JAX
    package's conventions at ties (``ops/warp.py:_source_coords_and_slope``).
    Deterministic: the scatter into d img sums in 64-bit fixed point. CUDA
    tensors only, fp32 and contiguous; the C++ operator
    ``torch.ops.nemar.warp_grid_bwd`` (``csrc/ops.cpp``) checks them, the
    shapes and the alignment, and raises on what the kernel does not take.
    """
    if not _usable(img, grid, g):
        _refuse("warp_grid_bwd", {"img": img, "grid": grid, "g": g})
    padding = PADDING_MODES.get(padding_mode)
    if padding is None:
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    gc = img.shape[-1] if grad_channels < 0 else grad_channels
    dimg, dgrid = (_warp_grid_bwd or _load_warp_grid_bwd())(img, grid, g, padding,
                                                              align_corners, gc)
    warp_grid_bwd.launches += 1
    return (dimg if gc else None), dgrid


def _load_warp_grid_bwd():
    global _warp_grid_bwd
    _warp_grid_bwd = _build.op("warp_grid_bwd")
    return _warp_grid_bwd


warp_grid_bwd.launches = 0
