"""K-in: the Triton kernel of fused instance norm + activation (forward).

Replaces the TPU kernel ``nemar_tpu/ops/norm.py:_instance_norm_act_pallas``
(``_in_act_kernel``): per-(n, c) mean and rstd over H*W (biased variance),
then 'none' / 'relu' / 'leaky_relu'.

What bounds it on the H100: bytes. It reads x twice and writes y once, with
a few operations per element. The TPU kernel walks the rows of one sample in
order and carries the sums in VMEM scratch from one grid step to the next;
Hopper blocks run in no order, so the sums are split instead:

  1. ``_partial_kernel``, one program per (row chunk, channel block,
     sample): masked sweep over its rows, accumulating in fp32 the sums of
     (x - p) and (x - p)^2, where the pivot p is the sample's first pixel
     (shifting by p keeps the E[x^2] - E[x]^2 form from cancelling when
     |mean| >> std). Writes one (S1, S2) pair per channel, in fp64.
  2. ``_apply_kernel``, same grid: reduces the chunks' pairs in a fixed
     order (deterministic) and in fp64 (hundreds of chunks summed one after
     another in fp32 cost 1e-5 at the output), forms mean and rstd, then
     normalises its rows and applies the activation in place of the store.

The row chunks are sized so that the grid holds about four programs per SM
even at batch 1 with few channels (the STN's 32-channel layers at 256^2),
which one program per (n, channel block) would run on a handful of SMs.
Masked loads cover the ragged channel counts on the path (1 to 512), so
there are no hand-written tails.

Triton is imported, and the kernels compiled, at the first launch: modules
of this package are imported on machines without Triton.
"""

from __future__ import annotations

import functools

import torch

from nemar_tpu_torch.ops import _build

_ACT_CODE = {"none": 0, "relu": 1, "leaky_relu": 2}

# triton.language, bound at the first launch; the kernels below resolve `tl`
# as a module global when Triton compiles them.
tl = None


@functools.cache
def _kernels():
    global tl
    triton = _build.import_triton()
    import triton.language as language

    tl = language

    @triton.jit
    def _partial_kernel(x_ptr, part_ptr, HW, C, ROWS, NSPLIT,
                        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        s = tl.program_id(0)
        cb = tl.program_id(1)
        n = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        base = x_ptr + n.to(tl.int64) * HW * C
        pivot = tl.load(base + cols, mask=cmask, other=0.0)
        acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        r_start = s * ROWS
        for r0 in range(r_start, r_start + ROWS, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < HW)[:, None] & cmask[None, :]
            v = tl.load(base + rows[:, None] * C + cols[None, :], mask=mask, other=0.0)
            d = tl.where(mask, v - pivot[None, :], 0.0)
            acc1 += d
            acc2 += d * d
        out = part_ptr + (n * NSPLIT + s).to(tl.int64) * 2 * C + cols
        tl.store(out, tl.sum(acc1.to(tl.float64), axis=0), mask=cmask)
        tl.store(out + C, tl.sum(acc2.to(tl.float64), axis=0), mask=cmask)

    @triton.jit
    def _apply_kernel(x_ptr, part_ptr, y_ptr, HW, C, ROWS, NSPLIT, eps, slope,
                      ACT: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        s = tl.program_id(0)
        cb = tl.program_id(1)
        n = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        offset = n.to(tl.int64) * HW * C
        pivot = tl.load(x_ptr + offset + cols, mask=cmask, other=0.0)
        s1 = tl.zeros([BLOCK_C], dtype=tl.float64)
        s2 = tl.zeros([BLOCK_C], dtype=tl.float64)
        pp = part_ptr + n.to(tl.int64) * NSPLIT * 2 * C + cols
        for k in range(0, NSPLIT):
            s1 += tl.load(pp + k * 2 * C, mask=cmask, other=0.0)
            s2 += tl.load(pp + k * 2 * C + C, mask=cmask, other=0.0)
        hw = HW * 1.0
        m1 = s1 / hw
        var = tl.maximum(s2 / hw - m1 * m1, 0.0)
        mean = (pivot.to(tl.float64) + m1).to(tl.float32)
        rstd = (1.0 / tl.sqrt(var + eps)).to(tl.float32)  # fp64: exact sqrt
        r_start = s * ROWS
        for r0 in range(r_start, r_start + ROWS, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < HW)[:, None] & cmask[None, :]
            idx = offset + rows[:, None] * C + cols[None, :]
            v = tl.load(x_ptr + idx, mask=mask, other=0.0)
            y = (v - mean[None, :]) * rstd[None, :]
            if ACT == 1:
                y = tl.maximum(y, 0.0)
            elif ACT == 2:
                y = tl.where(y >= 0.0, y, y * slope)
            tl.store(y_ptr + idx, y, mask=mask)

    return _partial_kernel, _apply_kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_shape(n: int, hw: int, c: int, sms: int) -> tuple[int, int, int, int]:
    """(BLOCK_C, BLOCK_R, rows per program, row chunks per sample): about
    four programs per SM, each sweeping whole BLOCK_R x BLOCK_C tiles."""
    block_c = min(1 << max(c - 1, 0).bit_length(), 64)
    block_r = max(2048 // block_c, 16)
    want = _cdiv(4 * sms, n * _cdiv(c, block_c))
    n_split = max(1, min(_cdiv(hw, block_r), want))
    rows = _cdiv(_cdiv(hw, n_split), block_r) * block_r
    return block_c, block_r, rows, _cdiv(hw, rows)


def instance_norm_act_triton(x: torch.Tensor, act: str = "relu", eps: float = 1e-5,
                             negative_slope: float = 0.2) -> torch.Tensor:
    """x (N, H, W, C) fp32 contiguous on a CUDA device -> same shape."""
    if not x.is_cuda:
        raise ValueError(f"instance_norm_act_triton: x is on {x.device}, not on a CUDA device")
    if x.dtype != torch.float32:
        raise TypeError(f"instance_norm_act_triton: x is {x.dtype}, the kernel takes float32")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"instance_norm_act_triton: x {tuple(x.shape)} must be NHWC-contiguous")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown act: {act!r}")
    _build.refuse_autograd("instance_norm_act_triton", x)
    n, h, w, c = x.shape
    hw = h * w
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    block_c, block_r, rows, n_split = _launch_shape(n, hw, c, sms)
    partial_kernel, apply_kernel = _kernels()
    part = torch.empty((n, n_split, 2, c), dtype=torch.float64, device=x.device)
    y = torch.empty_like(x)
    grid = (n_split, _cdiv(c, block_c), n)
    with torch.cuda.device(x.device):
        partial_kernel[grid](x, part, hw, c, rows, n_split,
                             BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
        apply_kernel[grid](x, part, y, hw, c, rows, n_split, eps, negative_slope,
                           ACT=_ACT_CODE[act], BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    instance_norm_act_triton.launches += 1
    return y


instance_norm_act_triton.launches = 0
