"""``grid_sample(mode='nearest')`` of the port against the JAX package's.

The JAX package samples nearest in plain XLA (``nemar_tpu/ops/warp.py``,
``_grid_sample_xla``: coordinates rounded half to even, a gather, zeros out
of the frame), and the port's counterpart is the plain gather on either
device (``_GridSampleNearest``; the card holds it in
``tests/test_torch_cuda_kernels.py::test_warp_nearest_on_cuda``). Held here
on the CPU in float64: the outputs equal, d img within 1e-12 of JAX's VJP
(the same sums in another order) and d grid zero in both, in each padding
mode, with and without ``align_corners``, on grids that reach past the
frame and on grids whose coordinates sit exactly on half-pixel ties, where
the rounding picks the even pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import warp as jwarp
from nemar_tpu_torch.ops import warp as twarp

torch.set_num_threads(2)
TOL = 1e-12
W = 8


def _frame(align_corners: bool) -> int:
    """The frame's side: 8, or 9 under align_corners, so that a half-pixel
    coordinate is a normalised one exact in binary (XLA may fold the
    unnormalisation's constants, which moves an inexact tie)."""
    return W + int(align_corners)


def _tie_grid(n, gh, gw, align_corners, rng):
    """Grids whose pixel coordinates are k + 0.5: nearest's ties, some just
    past the frame."""
    size = _frame(align_corners)
    pix = rng.integers(-2, size + 1, (n, gh, gw, 2)) + 0.5
    if align_corners:
        return pix / (size - 1) * 2 - 1
    return (2 * pix + 1) / size - 1


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_nearest_forward_and_vjp_match_jax(padding_mode, align_corners, ties):
    rng = np.random.default_rng(len(padding_mode) + 2 * align_corners + 4 * ties)
    size = _frame(align_corners)
    img = rng.standard_normal((2, size, size, 3))
    grid = (_tie_grid(2, 9, 7, align_corners, rng) if ties
            else rng.uniform(-1.3, 1.3, (2, 9, 7, 2)))
    g = rng.standard_normal((2, 9, 7, 3))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        def f(i, t):
            return jwarp.grid_sample(i, t, mode="nearest", padding_mode=padding_mode,
                                     align_corners=align_corners, impl="xla")

        ref, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
        ref_dimg, ref_dgrid = (np.asarray(a) for a in vjp(jnp.asarray(g)))
        ref = np.asarray(ref)
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert ref.dtype == np.float64
    x = torch.tensor(img, requires_grad=True)
    t = torch.tensor(grid, requires_grad=True)
    out = twarp.grid_sample(x, t, "nearest", padding_mode, align_corners)
    dimg, dgrid = torch.autograd.grad(out, (x, t), torch.tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    np.testing.assert_allclose(dimg.numpy(), ref_dimg, atol=TOL, rtol=0)
    assert not np.any(ref_dgrid) and not torch.any(dgrid)
    if ties:  # the ties were hit: some source pixel took several outputs
        assert float(np.abs(ref_dimg).max()) > float(np.abs(g).max())


def test_nearest_grad_channels():
    """``grad_channels`` limits d img to the first channels, exact zeros for
    the rest, as in the bilinear path."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((1, W, W, 4)), requires_grad=True)
    t = torch.tensor(rng.uniform(-1, 1, (1, 5, 5, 2)))
    out = twarp.grid_sample(x, t, "nearest", "border", False, grad_channels=1)
    (dimg,) = torch.autograd.grad(out.sum(), x)
    assert torch.any(dimg[..., 0]) and not torch.any(dimg[..., 1:])
