"""K-head's formulation and tiling (``nemar_tpu_torch/csrc/head_fwd.cu``,
``nemar_tpu_torch/ops/conv_head.py:head_fwd_plan``) on the CPU.

On the model's head the kernel computes the 7x7 reflect conv as a GEMM with
the 49 taps folded into N, Y[q, (tap, co)] = sum_ci xpad[q, ci] W[tap, ci,
co], over the 64 padded positions q of a strip's row, and streams the frame
down: each block walks its run of padded rows, and each row's Y is
collapsed into a ring of the 7 output rows it feeds, out[y, c, co] = sum_dy
sum_dx Y_{y + dy}[c + dx, (dy, dx, co)], dy outer, dx inner, an output row
written once its last row has been added. ``folded_fwd`` writes that out in
torch, block by block and step by step as ``head_fwd_steps`` lists them,
with the GEMM in plain fp32 (its 3xTF32 arithmetic is
``tests/test_torch_tf32_split.py``'s), and is held within 1e-5 of the
largest value against the plain version and the JAX package's B4 forward
(``conv_head_roll``; at widths other than a multiple of 128 it is the
direct conv, as ``tests/test_conv_head_roll.py`` runs it), for Co of 1 to 8
(the kernel's wgmma route takes Co <= 3; the formulation is the same at any
Co) on a card of 132 SMs and on one of 5, whose runs cross strips. The
plan's runs write every output once, fill the card, and keep to the
kernel's limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nemar_tpu.ops.conv_head_roll import conv_head_roll
from nemar_tpu_torch.ops.conv_head import (
    PAD, _run_steps, conv_head_plain, head_fwd_plan, head_fwd_steps,
)

TOL = 1e-5
SMS = 132  # the H100 SXM's SMs
M = 64     # the kernel's positions a strip row (G_M)


def folded_fwd(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """out as K-head's wgmma route computes it, in fp32 torch ops; asserts
    that every output is written exactly once."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    xpad = F.pad(x.permute(0, 3, 1, 2), (PAD,) * 4, mode="reflect").permute(0, 2, 3, 1)
    wmat = w.reshape(49, ci, co).permute(1, 0, 2).reshape(ci, 49 * co)  # [ci, (tap, co)]
    out = torch.zeros((n, h, wd, co))
    written = torch.zeros((n, h, wd), dtype=torch.long)
    for b in range(plan.blocks):
        ring = None
        for img, j0, tcw, r, y0 in head_fwd_steps(plan, h, wd, b):
            if r == y0:
                ring = torch.zeros((7, tcw, co))
            # the strip's row: positions j0 .. j0 + tcw + 5, zeros past them
            row = torch.zeros((M, ci))
            row[:tcw + 2 * PAD] = xpad[img, r, j0:j0 + tcw + 2 * PAD]
            y = (row @ wmat).reshape(M, 7, 7, co)  # [q, dy, dx, co]
            for dy in range(7):
                s = y[0:tcw, dy, 0]
                for dx in range(1, 7):
                    s = s + y[dx:dx + tcw, dy, dx]
                ring[6 - dy] += s
            if r - 2 * PAD >= y0:
                out[img, r - 2 * PAD, j0:j0 + tcw] = ring[0]
                written[img, r - 2 * PAD, j0:j0 + tcw] += 1
            ring = torch.cat([ring[1:], torch.zeros((1, tcw, co))])
    assert torch.all(written == 1), "an output is written other than once"
    return out


def _data(shape, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.05 * rng.standard_normal((7, 7, shape[-1], co))).astype(np.float32)
    return x, w


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# the card tests' small HEAD_SHAPES (tests/test_torch_cuda_kernels.py), a
# 128-wide frame that reaches B4's roll kernel, three strips a row, and Co
# of 1 to 8; on 132 SMs, and on 5 (long runs that cross strips)
CASES = [((2, 37, 70, 20), 8, SMS), ((1, 5, 5, 12), 1, SMS), ((2, 4, 9, 8), 5, SMS),
         ((1, 40, 4, 64), 2, SMS), ((1, 8, 128, 8), 3, SMS), ((1, 11, 6, 4), 6, SMS),
         ((2, 9, 119, 16), 3, SMS), ((1, 6, 60, 12), 4, SMS), ((2, 5, 70, 8), 7, SMS),
         ((2, 37, 70, 20), 3, 5), ((2, 9, 119, 16), 1, 5), ((1, 40, 4, 64), 2, 5)]


@pytest.mark.parametrize("shape,co,sms", CASES)
def test_folded_formulation_matches_plain_and_b4(shape, co, sms):
    x, w = _data(shape, co, seed=sum(shape) + co + sms)
    plan = head_fwd_plan(*shape, co, sms)
    got = folded_fwd(torch.from_numpy(x), torch.from_numpy(w), plan)
    plain = conv_head_plain(torch.from_numpy(x), torch.from_numpy(w))
    b4 = np.asarray(conv_head_roll(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == plain.shape == b4.shape
    assert _rel(got, plain) <= TOL, _rel(got, plain)
    assert _rel(got, b4) <= TOL, _rel(got, b4)


@pytest.mark.parametrize("ci,co,wgmma", [(64, 3, True), (64, 1, True), (12, 1, True),
                                         (20, 2, True), (32, 3, True), (64, 4, False),
                                         (20, 8, False), (8, 5, False), (68, 3, False),
                                         (30, 3, False), (128, 1, False)])
def test_plan_route(ci, co, wgmma):
    """The wgmma route takes Co <= 3 (49 Co <= 152 columns, one m64n152k8)
    and Ci <= 64 in multiples of 4 (two 32-deep slices, 16-byte copies);
    the rest, the direct route."""
    assert head_fwd_plan(2, 37, 70, ci, co, SMS).wgmma is wgmma


def _covered(plan, n, h, w) -> np.ndarray:
    seen = np.zeros((n, h, w), dtype=np.int64)
    for b in range(plan.blocks):
        steps = head_fwd_steps(plan, h, w, b)
        assert len(steps) == _run_steps(plan.units, h, plan.blocks, b)
        for img, j0, tcw, r, y0 in steps:
            assert 0 <= img < n and 0 <= y0 <= r < h + 2 * PAD and tcw >= 1 and j0 + tcw <= w
            if r - 2 * PAD >= y0:
                seen[img, r - 2 * PAD, j0:j0 + tcw] += 1
    return seen


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("n,h,w", [(1, 256, 256), (8, 256, 256), (2, 37, 70), (1, 4, 5),
                                   (1, 4, 58), (1, 4, 59), (2, 9, 119), (3, 30, 1000)])
def test_plan_writes_every_output_once(n, h, w, sms):
    plan = head_fwd_plan(n, h, w, 64, 3, sms)
    # strips: at most 58 output columns, so 64 padded positions, one wgmma's rows
    assert 1 <= plan.tc <= M - 2 * PAD
    assert plan.cx * plan.tc >= w and (plan.cx - 1) * plan.tc < w
    assert plan.units == n * plan.cx * h and 1 <= plan.blocks <= min(sms, plan.units)
    assert np.all(_covered(plan, n, h, w) == 1)


def _smem_bytes(ci: int, co: int) -> int:
    """The wgmma route's shared memory (csrc/head_fwd.cu: wgmma_smem): W
    split, big and small, as 49 Co (rounded up to 8) (tap, co) rows of each
    32-deep K slice; two x rows of 64 positions (KS 32 + 4 floats each); Y
    of one row (49 Co columns of 64 positions + 4)."""
    ks = -(-ci // 32)
    return 4 * (2 * ks * -(-49 * co // 8) * 8 * 32 + 2 * M * (32 * ks + 4) + 49 * co * (M + 4))


@pytest.mark.parametrize("n", [1, 8])
def test_plan_fills_the_card_within_the_kernels_limits(n):
    """At 256^2 every SM but at most two gets a block of two warpgroups (a
    second block would not fit a SM's 227 KB of shared memory), and no
    run is much longer than the mean."""
    h = w = 256
    plan = head_fwd_plan(n, h, w, 64, 3, SMS)
    assert plan.wgmma and plan.tc == 52 and plan.cx == 5
    assert SMS - 2 <= plan.blocks <= SMS
    steps = [_run_steps(plan.units, h, plan.blocks, b) for b in range(plan.blocks)]
    mean = plan.units / plan.blocks
    assert max(steps) <= mean + 2 * 2 * PAD + 1
    assert max(steps) == (16 if n == 1 else 90)
    smem = _smem_bytes(64, 3)
    assert smem <= 227 * 1024 < 2 * smem
    # every shape the route takes fits: Ci <= 64, Co <= 3
    assert max(_smem_bytes(ci, co) for ci in (4, 32, 36, 64) for co in (1, 2, 3)) <= 227 * 1024
