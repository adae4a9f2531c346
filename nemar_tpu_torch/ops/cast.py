"""The casts around the fp32 kernels that take no bf16 operands yet.

Under ``--bf16`` the activations are bfloat16. K-warp / K-warp-bwd and
K-head / K-head-bwd have fp32 kernels only (their bf16 variants are queued
as ROADMAP.md A7b), so their wrappers (``ops/warp.py:grid_sample``,
``ops/conv_head.py:conv_head``) run them on fp32 copies: the image (or x and
w) cast up before the kernel, the output cast back down after it, and in the
backward the incoming gradient up and the operands' gradients down, each by
the backward of the forward's cast. ``to_dtype`` is that cast, counted: each
one, forward or backward, adds one to ``counter.casts``, so a run can show
how many it paid (``chip_smoke.py`` asserts and times them).
"""

from __future__ import annotations

import torch


class _Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype, counter):
        ctx.dtype, ctx.counter = x.dtype, counter
        counter.casts += 1
        return x.to(dtype)

    @staticmethod
    def backward(ctx, g):
        ctx.counter.casts += 1
        return g.to(ctx.dtype), None, None


def to_dtype(x: torch.Tensor, dtype: torch.dtype, counter) -> torch.Tensor:
    """x cast to ``dtype`` (x itself when it has that type already),
    differentiable: the gradient is cast back to x's type. Each cast, and
    each cast of a gradient, adds one to ``counter.casts``."""
    if x.dtype == dtype:
        return x
    return _Cast.apply(x, dtype, counter)
