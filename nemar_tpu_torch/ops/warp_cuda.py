"""Wrapper of the CUDA kernel K-warp (``csrc/warp_fwd.cu``).

Replaces the TPU kernel ``nemar_tpu/ops/warp_pallas.py:_fwd_pallas``
(through ``_warp_core``): bilinear sampling with zeros padding of an NHWC
fp32 image at per-pixel PIXEL coordinates. The padding modes and
``align_corners`` are applied before, in ``ops/warp.py``, exactly as the JAX
package applies them outside its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from nemar_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def warp_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C), xs/ys (N, Ho, Wo) pixel coords -> (N, Ho, Wo, C).

    CUDA tensors only; all fp32 and contiguous (an NCHW ``channels_last``
    tensor permuted to NHWC is contiguous).
    """
    for name, t in (("img", img), ("xs", xs), ("ys", ys)):
        if not t.is_cuda:
            raise ValueError(f"warp_bilinear: {name} is on {t.device}, not on a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_bilinear: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"warp_bilinear: {name} {tuple(t.shape)} is not contiguous")
    if img.dim() != 4 or xs.dim() != 3 or xs.shape != ys.shape or xs.shape[0] != img.shape[0]:
        raise ValueError(f"warp_bilinear: bad shapes img {tuple(img.shape)}, "
                         f"xs {tuple(xs.shape)}, ys {tuple(ys.shape)}")
    if not (img.device == xs.device == ys.device):
        raise ValueError("warp_bilinear: inputs on different devices")
    _build.refuse_autograd("warp_bilinear", img, xs, ys)
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
