"""Wrappers of the CUDA kernels K-warp (``csrc/warp_fwd.cu``) and K-warp-bwd
(``csrc/warp_bwd.cu``).

They replace the TPU kernels ``nemar_tpu/ops/warp_pallas.py:_fwd_pallas``
and ``_bwd_pallas`` (through ``_warp_core`` and its custom VJP). K-warp
samples an NHWC fp32 image bilinearly at a normalised grid, with the
padding mode and ``align_corners`` applied in the kernel (zeros-padded
taps). K-warp-bwd takes the PIXEL coordinates the grid maps to
(``ops/warp.py:_pixel_coords``) and returns the gradient with respect to the
image (first ``grad_channels`` channels) and to those coordinates; torch
autograd chains it to the grid (``ops/warp.py:_GridSample``).

Both launch through their PyTorch operators (``csrc/ops.cpp``). K-warp's
does the checks and the allocation in C++: at batch 1 its device time is a
few microseconds, so the host's cost per call is what the caller waits for.
Both check only what their kernels need: CUDA, fp32, contiguous, shapes.
"""

from __future__ import annotations

import torch

from nemar_tpu_torch.ops import _build

PADDING_MODES = {"zeros": 0, "border": 1, "reflection": 2}
_warp_grid = None  # torch.ops.nemar.warp_grid, once the library is loaded


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


def warp_bilinear_bwd(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, g: torch.Tensor,
                      grad_channels: int) -> tuple:
    """Launch K-warp-bwd: (d img or None, d xs, d ys) of bilinear zeros-padded
    sampling of img at pixel coordinates xs, ys (N, Ho, Wo).

    g (N, Ho, Wo, C) is the gradient of its output. d img covers the first
    ``grad_channels`` channels, the rest are exact zeros; with
    ``grad_channels == 0`` it is not computed and None is returned.
    Deterministic: the scatter into d img sums in 64-bit fixed point.
    """
    if not _usable(img, xs, ys, g):
        _refuse("warp_bilinear_bwd", {"img": img, "xs": xs, "ys": ys, "g": g})
    n, h, w, c = img.shape
    ho, wo = xs.shape[1:]
    if xs.shape != ys.shape or tuple(g.shape) != (n, ho, wo, c):
        raise ValueError(f"warp_bilinear_bwd: bad shapes img {tuple(img.shape)}, "
                         f"xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, g {tuple(g.shape)}")
    if not 0 <= grad_channels <= c:
        raise ValueError(f"warp_bilinear_bwd: grad_channels {grad_channels} not in [0, {c}]")
    dev = img.device
    dxs = torch.empty_like(xs)
    dys = torch.empty_like(ys)
    dimg = torch.empty_like(img) if grad_channels else None
    acc = torch.zeros((n, h, w, grad_channels), dtype=torch.int64, device=dev)
    gmax = torch.zeros((1,), dtype=torch.int32, device=dev)
    _build.op("warp_bwd")(img, xs, ys, g, dimg, dxs, dys, acc, gmax, grad_channels)
    warp_bilinear_bwd.launches += 1
    return dimg, dxs, dys


warp_bilinear_bwd.launches = 0
