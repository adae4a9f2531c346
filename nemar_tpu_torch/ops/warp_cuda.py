"""Wrappers of the CUDA kernels K-warp (``csrc/warp_fwd.cu``) and K-warp-bwd
(``csrc/warp_bwd.cu``).

They replace the TPU kernels ``nemar_tpu/ops/warp_pallas.py:_fwd_pallas``
and ``_bwd_pallas`` (through ``_warp_core`` and its custom VJP): bilinear
sampling with zeros padding of an NHWC fp32 image at per-pixel PIXEL
coordinates, and its gradient with respect to the image (first
``grad_channels`` channels) and to the coordinates. The padding modes and
``align_corners`` are applied before, in ``ops/warp.py``, exactly as the JAX
package applies them outside its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from nemar_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(what: str, img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           *more: tuple) -> None:
    for name, t in (("img", img), ("xs", xs), ("ys", ys), *more):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not contiguous")
        if t.device != img.device:
            raise ValueError(f"{what}: inputs on different devices")
    if img.dim() != 4 or xs.dim() != 3 or xs.shape != ys.shape or xs.shape[0] != img.shape[0]:
        raise ValueError(f"{what}: bad shapes img {tuple(img.shape)}, "
                         f"xs {tuple(xs.shape)}, ys {tuple(ys.shape)}")


def warp_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C), xs/ys (N, Ho, Wo) pixel coords -> (N, Ho, Wo, C).

    CUDA tensors only; all fp32 and contiguous (an NCHW ``channels_last``
    tensor permuted to NHWC is contiguous).
    """
    _check("warp_bilinear", img, xs, ys)
    n, h, w, c = img.shape
    ho, wo = xs.shape[1:]
    out = torch.empty((n, ho, wo, c), dtype=torch.float32, device=img.device)
    fn = _build.c_function("nemar_warp_bilinear_fwd", [_P] * 4 + [_I] * 6 + [_P])
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(img.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                  n, h, w, c, ho, wo, stream)
    _build.check(code, "warp_bilinear")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0


def warp_bilinear_bwd(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, g: torch.Tensor,
                      grad_channels: int) -> tuple:
    """Launch K-warp-bwd: (d img or None, d xs, d ys) of ``warp_bilinear``.

    g (N, Ho, Wo, C) is the gradient of its output. d img covers the first
    ``grad_channels`` channels, the rest are exact zeros; with
    ``grad_channels == 0`` it is not computed and None is returned.
    Deterministic: the scatter into d img sums in 64-bit fixed point.
    """
    _check("warp_bilinear_bwd", img, xs, ys, ("g", g))
    n, h, w, c = img.shape
    ho, wo = xs.shape[1:]
    if tuple(g.shape) != (n, ho, wo, c):
        raise ValueError(f"warp_bilinear_bwd: g {tuple(g.shape)} is not {(n, ho, wo, c)}")
    if not 0 <= grad_channels <= c:
        raise ValueError(f"warp_bilinear_bwd: grad_channels {grad_channels} not in [0, {c}]")
    dev = img.device
    dxs = torch.empty_like(xs)
    dys = torch.empty_like(ys)
    dimg = torch.empty_like(img) if grad_channels else None
    acc = torch.zeros((n, h, w, grad_channels), dtype=torch.int64, device=dev)
    gmax = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = _build.c_function("nemar_warp_bilinear_bwd", [_P] * 9 + [_I] * 7 + [_P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(img.data_ptr(), xs.data_ptr(), ys.data_ptr(), g.data_ptr(),
                  dimg.data_ptr() if dimg is not None else None, dxs.data_ptr(), dys.data_ptr(),
                  acc.data_ptr(), gmax.data_ptr(), n, h, w, c, ho, wo, grad_channels, stream)
    _build.check(code, "warp_bilinear_bwd")
    warp_bilinear_bwd.launches += 1
    return dimg, dxs, dys


warp_bilinear_bwd.launches = 0
