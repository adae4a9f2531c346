"""K-head-bwd's formulation and tiling (``nemar_tpu_torch/csrc/head_bwd.cu``,
``nemar_tpu_torch/ops/conv_head.py:head_bwd_plan``) on the CPU.

The kernel computes the head conv's VJP as two GEMMs over the positions q
of the reflect-padded frame, with the 49 taps folded into the GEMM:
dW[ci, (tap, co)] = sum_q xpad[q, ci] g0[q - tap, co] (split over the dW
blocks' tiles, merged in fp64), and Dx[q, ci] = sum_(tap, co) g0[q - tap,
co] W[tap, ci, co], whose image part is dx and whose frame part is folded
onto the edge pixels in the kernel's order. ``folded_bwd`` writes that out
in torch, tile by tile as ``head_bwd_plan`` cuts the frame, and is held
within 1e-5 of the largest value against the plain backward and the JAX
package's B4 backward (``conv_head_roll``'s VJP; at widths other than a
multiple of 128 it is the direct conv, as ``tests/test_conv_head_roll.py``
runs it). The plan's tiles cover every position of the frame once, fill the
card at batch 1, and keep within the kernel's limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nemar_tpu.ops.conv_head_roll import conv_head_roll
from nemar_tpu_torch.ops.conv_head import (
    PAD, conv_head_bwd_plain, head_bwd_plan, head_bwd_tile,
)

TOL = 1e-5
SMS = 132  # the H100 SXM's SMs


def _sources(u: int, n: int) -> list:
    """Image-coordinate padded indices that reflect onto u, u first (the
    kernel's sources())."""
    src = [u]
    if 1 <= u <= PAD:
        src.append(-u)
    if n <= 2 * n - 2 - u <= n - 1 + PAD:
        src.append(2 * n - 2 - u)
    return src


def _frame_index(i: int, j: int, h: int, w: int) -> int:
    """The kernel's Geometry::frame_index of padded (i, j)."""
    wp = w + 2 * PAD
    if i < PAD:
        return i * wp + j
    if i >= h + PAD:
        return (i - h) * wp + j
    return 2 * PAD * wp + (i - PAD) * 2 * PAD + (j if j < PAD else j - w)


def folded_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, plan) -> tuple:
    """(dx, dw) as K-head-bwd computes them, in fp32 torch ops."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    hp, wp, halo = h + 2 * PAD, wd + 2 * PAD, 2 * PAD
    xpad = F.pad(x.permute(0, 3, 1, 2), (PAD,) * 4, mode="reflect").permute(0, 2, 3, 1)
    g0 = F.pad(g.permute(0, 3, 1, 2), (halo,) * 4).permute(0, 2, 3, 1)
    # the im2col of g0 over the padded frame: cols[b, i, j, tap Co + co] = g0[b, i - dy, j - dx, co]
    cols = torch.stack([g0[:, halo - dy:halo - dy + hp, halo - dx:halo - dx + wp]
                        for dy in range(7) for dx in range(7)], dim=3).reshape(n, hp, wp, 49 * co)

    # dW: each dW block's tiles (t = block, + dw_blocks, ...), summed in fp32
    # per block, then the blocks' partials in fp64 in block order
    dw64 = torch.zeros((ci, 49 * co), dtype=torch.float64)
    owner = torch.empty((n, hp, wp), dtype=torch.long)
    for t in range(plan.tiles):
        img, i0, j0 = head_bwd_tile(plan, t)
        owner[img, i0:i0 + plan.tr, j0:j0 + plan.tc] = t % plan.dw_blocks
    for b in range(plan.dw_blocks):
        m = owner == b
        dw64 += (xpad[m].T @ cols[m]).double()
    dw = dw64.float().reshape(ci, 49, co).permute(1, 0, 2).reshape(7, 7, ci, co)

    # Dx over the frame; the image part is dx, the rest goes to the frame
    # scratch and is folded onto the edge pixels in sources() order
    dpad = cols @ w.reshape(49, ci, co).permute(0, 2, 1).reshape(49 * co, ci)
    dx = dpad[:, PAD:PAD + h, PAD:PAD + wd].clone()
    fsz = 6 * wp + 6 * h
    frame = torch.full((n, fsz, ci), float("nan"))
    for i in range(hp):
        for j in range(wp):
            if not (PAD <= i < h + PAD and PAD <= j < wd + PAD):
                frame[:, _frame_index(i, j, h, wd)] = dpad[:, i, j]
    assert not torch.isnan(frame).any(), "frame_index misses a frame position"
    for u in range(h):
        for v in range(wd):
            rows, cs = _sources(u, h), _sources(v, wd)
            for a, r in enumerate(rows):
                for b, c in enumerate(cs):
                    if a or b:
                        dx[:, u, v] += frame[:, _frame_index(r + PAD, c + PAD, h, wd)]
    return dx, dw


def _data(shape, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.05 * rng.standard_normal((7, 7, shape[-1], co))).astype(np.float32)
    g = rng.standard_normal((*shape[:3], co)).astype(np.float32)
    return x, w, g


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# the card tests' small HEAD_SHAPES (tests/test_torch_cuda_kernels.py), a
# 128-wide frame that reaches B4's roll kernel, and Co of 1 to 8
@pytest.mark.parametrize("shape,co", [((2, 37, 70, 20), 8), ((1, 5, 5, 12), 1),
                                      ((2, 4, 9, 8), 5), ((1, 40, 4, 64), 2),
                                      ((1, 8, 128, 8), 3), ((1, 11, 6, 4), 6)])
def test_folded_formulation_matches_plain_and_b4(shape, co):
    x, w, g = _data(shape, co, seed=sum(shape) + co)
    plan = head_bwd_plan(*shape, co, SMS)
    got = folded_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), plan)
    plain = conv_head_bwd_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    _, vjp = jax.vjp(conv_head_roll, jnp.asarray(x), jnp.asarray(w))
    b4 = vjp(jnp.asarray(g))
    for name, a, p, j in zip(("dx", "dw"), got, plain, b4):
        assert a.shape == p.shape == j.shape, name
        assert _rel(a, p) <= TOL, (name, _rel(a, p))
        assert _rel(a, j) <= TOL, (name, _rel(a, j))


def _coverage(plan, n, h, w) -> np.ndarray:
    hp, wp = h + 2 * PAD, w + 2 * PAD
    seen = np.zeros((n, hp + plan.tr, wp + plan.tc), dtype=np.int64)
    for t in range(plan.tiles):
        img, i0, j0 = head_bwd_tile(plan, t)
        assert 0 <= img < n and i0 < hp and j0 < wp, (t, img, i0, j0)
        seen[img, i0:i0 + plan.tr, j0:j0 + plan.tc] += 1
    return seen[:, :hp, :wp]


@pytest.mark.parametrize("n", [1, 8])
def test_plan_tiles_the_frame_once_and_fills_the_card(n):
    h = w = 256
    ci, co = 64, 3
    plan = head_bwd_plan(n, h, w, ci, co, SMS)
    assert np.all(_coverage(plan, n, h, w) == 1)
    assert plan.tiles >= SMS
    # the kernel's limits: a tile's positions, its g window
    assert plan.tr * plan.tc <= 1024 and (plan.tr + 6) * (plan.tc + 6) * co <= 4096
    # the scratch: one set of dW partials a block, the frame around each image
    assert 1 <= plan.dw_blocks <= min(plan.tiles, SMS)
    assert plan.part_floats == plan.dw_blocks * 49 * ci * co
    assert plan.frame_floats == n * (6 * (w + 6) + 6 * h) * ci
    assert 1 <= plan.dx_blocks <= SMS and 3 * plan.dx_blocks >= min(plan.tiles, 3 * SMS)
    # dW's partials do not grow with the batch: 132 sets of 49 x 64 x 3 at b1 and b8
    assert plan.part_floats == SMS * 49 * ci * co


@pytest.mark.parametrize("co", range(1, 9))
@pytest.mark.parametrize("n,h,w", [(1, 256, 256), (8, 256, 256), (2, 37, 70), (1, 4, 5),
                                   (3, 300, 1000), (1, 4, 58), (2, 9, 119)])
def test_plan_keeps_the_kernels_limits(n, h, w, co):
    plan = head_bwd_plan(n, h, w, 20, co, SMS)
    assert plan.tr >= 1 and plan.tc >= 1
    assert plan.tr * plan.tc <= 1024
    assert (plan.tr + 6) * (plan.tc + 6) * co <= 4096
    assert plan.cx * plan.tc >= w + 6 and (plan.cx - 1) * plan.tc < w + 6
    assert plan.ty * plan.tr >= h + 6 and (plan.ty - 1) * plan.tr < h + 6
    assert plan.tiles == n * plan.ty * plan.cx
    if n * (h + 6) * (w + 6) <= 300_000:
        assert np.all(_coverage(plan, n, h, w) == 1)
