"""The fused ResNet trunk block, forward:

    out = x + IN(conv3x3_reflect(relu(IN(conv3x3_reflect(x, W1))), W2))

NHWC activations and HWIO weights, as ``nemar_tpu/ops/conv_fused.py:
fused_resblock``. Instance norm per (n, c), biased variance, no affine; the
conv biases are left out because IN makes them inert (the model keeps them
as parameters, for checkpoint compatibility).

``fused_resblock`` dispatches on the device: a CPU tensor takes
``resblock_plain`` (reflect pad + ``F.conv2d`` + IN, the math of the JAX
package's ``resblock_reference``); a CUDA tensor launches the CUDA kernel
K-block (``csrc/resblock_fwd.cu``), which replaces the TPU kernel
``_fwd_pallas``. The kernel computes the convolutions in its own body:
no cuDNN, cuBLAS or ``F.conv2d`` on that path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.norm import instance_norm

_P = ctypes.c_void_p
_I = ctypes.c_int
# tile sizes of csrc/resblock_fwd.cu: a pixel tile must not straddle samples
_BM, _BN = 64, 128


def _conv3x3_reflect(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC conv over a reflect-padded x, no bias."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def resblock_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``fused_resblock`` (any device)."""
    h1 = torch.clamp_min(instance_norm(_conv3x3_reflect(x, w1), eps), 0.0)
    return x + instance_norm(_conv3x3_reflect(h1, w2), eps)


def block_kernel_supported(shape) -> bool:
    """Shapes K-block takes: C % 128 == 0, H*W % 64 == 0, H and W >= 2."""
    n, h, w, c = shape
    return c % _BN == 0 and (h * w) % _BM == 0 and h >= 2 and w >= 2


def fused_resblock_cuda(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Launch K-block. x (N, H, W, C) fp32 NHWC-contiguous on a CUDA device;
    w1, w2 (3, 3, C, C) HWIO fp32 (made contiguous here)."""
    if not (x.is_cuda and w1.device == x.device and w2.device == x.device):
        raise ValueError("fused_resblock_cuda: x, w1, w2 must be on one CUDA device")
    if not (x.dtype == w1.dtype == w2.dtype == torch.float32):
        raise TypeError("fused_resblock_cuda: the kernel takes float32 x, w1, w2")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"fused_resblock_cuda: x {tuple(x.shape)} must be NHWC-contiguous")
    n, h, w, c = x.shape
    if tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"fused_resblock_cuda: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not (3, 3, {c}, {c})")
    if not block_kernel_supported(x.shape):
        raise ValueError(f"fused_resblock_cuda: shape {tuple(x.shape)} not supported "
                         f"(needs C % {_BN} == 0, H*W % {_BM} == 0, H, W >= 2)")
    _build.refuse_autograd("fused_resblock_cuda", x, w1, w2)
    w1, w2 = w1.contiguous(), w2.contiguous()
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("fused_resblock_cuda: tensors must be 16-byte aligned")
    y1 = torch.empty_like(x)
    y2 = torch.empty_like(x)
    out = torch.empty_like(x)
    part = torch.empty((n * h * w // _BM, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, 4, c), dtype=torch.float32, device=x.device)
    fn = _build.c_function("nemar_resblock_fwd",
                           [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                  part.data_ptr(), stats.data_ptr(), out.data_ptr(), n, h, w, c, eps, stream)
    _build.check(code, "fused_resblock_cuda")
    fused_resblock_cuda.launches += 1
    return out


fused_resblock_cuda.launches = 0


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """out = x + IN(conv3x3r(relu(IN(conv3x3r(x, w1))), w2)); NHWC x, HWIO w."""
    if x.is_cuda:
        return fused_resblock_cuda(x, w1, w2, eps)
    if x.device.type != "cpu":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    return resblock_plain(x, w1, w2, eps)
