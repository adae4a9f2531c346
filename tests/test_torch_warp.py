"""The port's warp ops (nemar_tpu_torch.ops.warp) against the JAX package's.

Same numpy inputs through both; on the CPU the port takes its plain gather,
which the CUDA kernel K-warp is held against on the card
(tests/test_torch_cuda_kernels.py). Tolerance 1e-5 (fp32 roundoff of the
coordinate transform and the four-tap sum). Gradients (d img for the first
``grad_channels`` channels, d grid) go through the port's differentiable
sampling, whose CPU backward is ``_sample_plain_bwd`` (K-warp-bwd on the
card), against JAX autodiff of the same op; tolerance 1e-5 relative to the
largest gradient (d grid is in pixels per normalised unit, up to ~W/2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import warp as jwarp
from nemar_tpu.ops import warp_pallas
from nemar_tpu_torch.ops import warp as twarp
from nemar_tpu_torch.ops import warp_cuda

torch.set_num_threads(2)
TOL = 1e-5


def _imgs(seed, n=2, h=9, w=11, c=3, gh=7, gw=5, span=1.2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, h, w, c)).astype(np.float32)
    grid = rng.uniform(-span, span, (n, gh, gw, 2)).astype(np.float32)
    return img, grid


def _smooth_grid(rng, n, h, w, px=2.5):
    flow = rng.standard_normal((n, h, w, 2)).astype(np.float32)
    for axis in (1, 2):  # a few box blurs: a smooth field, a few pixels
        for _ in range(3):
            flow = (np.roll(flow, 1, axis) + flow + np.roll(flow, -1, axis)) / 3.0
    flow *= px / np.abs(flow).max() * np.array([2.0 / w, 2.0 / h], np.float32)
    return (np.asarray(jwarp.identity_grid(h, w))[None] + flow).astype(np.float32), flow


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_sample_matches_jax(padding_mode, align_corners, mode):
    img, grid = _imgs(len(padding_mode) * 4 + 2 * align_corners + len(mode))
    ref = jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode,
                            padding_mode=padding_mode, align_corners=align_corners, impl="xla")
    got = twarp.grid_sample(_t(img), _t(grid), mode, padding_mode, align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_grid_sample_matches_torch_oracle():
    img, grid = _imgs(3)
    ref = torch.nn.functional.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid),
                                          mode="bilinear", padding_mode="zeros",
                                          align_corners=False).permute(0, 2, 3, 1)
    got = twarp.grid_sample(_t(img), _t(grid))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_grid_sample_matches_jax_pallas_kernel():
    """Bilinear zeros against the TPU kernel itself (interpret mode)."""
    rng = np.random.default_rng(11)
    img = rng.standard_normal((1, 16, 128, 4)).astype(np.float32)
    grid, _ = _smooth_grid(rng, 1, 16, 128)
    ref = warp_pallas.grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid))
    got = twarp.grid_sample(_t(img), _t(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_grid_sample_multi_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    b = rng.standard_normal((2, 12, 10, 1)).astype(np.float32)
    grid, _ = _smooth_grid(rng, 2, 12, 10)
    ref = jwarp.grid_sample_multi([jnp.asarray(a), jnp.asarray(b)], jnp.asarray(grid), impl="xla")
    got = twarp.grid_sample_multi([_t(a), _t(b)], _t(grid), n_grad_imgs=1)
    assert [tuple(g.shape) for g in got] == [a.shape, b.shape]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_with_flow_and_compose_match_jax(align_corners):
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 12, 14, 2)).astype(np.float32)
    _, f1 = _smooth_grid(rng, 2, 12, 14)
    _, f2 = _smooth_grid(rng, 2, 12, 14)
    ref = jwarp.warp_with_flow(jnp.asarray(img), jnp.asarray(f1), align_corners, impl="xla")
    got = twarp.warp_with_flow(_t(img), _t(f1), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    ref = jwarp.compose_flows(jnp.asarray(f1), jnp.asarray(f2), align_corners, impl="xla")
    got = twarp.compose_flows(_t(f1), _t(f2), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grids_match_jax(align_corners):
    theta = np.random.default_rng(8).uniform(-1, 1, (3, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(twarp.identity_grid(5, 7, align_corners).numpy(),
                               np.asarray(jwarp.identity_grid(5, 7, align_corners)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        twarp.affine_grid(_t(theta), (3, 1, 6, 4), align_corners).numpy(),
        np.asarray(jwarp.affine_grid(jnp.asarray(theta), (3, 1, 6, 4), align_corners)),
        atol=1e-6, rtol=0)


def _grads_jax(img, grid, g, gc, **kw):
    def f(i, gr):
        return jwarp.grid_sample(i, gr, **kw) if "impl" in kw else \
            warp_pallas.grid_sample_pallas(i, gr, grad_channels=gc)
    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _grads_port(img, grid, g, gc, padding_mode="zeros", align_corners=False):
    it, gt = _t(img).requires_grad_(), _t(grid).requires_grad_()
    out = twarp.grid_sample(it, gt, "bilinear", padding_mode, align_corners, gc)
    return [a.numpy() for a in torch.autograd.grad(out, (it, gt), _t(g))]


def _close(got, want):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_sample_grads_match_jax(padding_mode, align_corners):
    img, grid = _imgs(len(padding_mode) + 3 * align_corners, c=4)
    g = np.random.default_rng(2).standard_normal(grid.shape[:3] + (4,)).astype(np.float32)
    want = _grads_jax(img, grid, g, -1, mode="bilinear", padding_mode=padding_mode,
                      align_corners=align_corners, impl="xla")
    dimg, dgrid = _grads_port(img, grid, g, 3, padding_mode, align_corners)
    _close(dimg[..., :3], want[0][..., :3])
    assert not np.any(dimg[..., 3])  # past grad_channels: exact zeros
    _close(dgrid, want[1])
    dimg_all, dgrid_all = _grads_port(img, grid, g, -1, padding_mode, align_corners)
    _close(dimg_all, want[0])
    np.testing.assert_array_equal(dgrid_all, dgrid)


def test_grid_sample_grads_match_jax_pallas_kernel():
    """Against the TPU kernel's VJP itself (interpret mode, W = 128), with
    its grad_channels."""
    rng = np.random.default_rng(12)
    img = rng.standard_normal((1, 16, 128, 4)).astype(np.float32)
    grid, _ = _smooth_grid(rng, 1, 16, 128)
    g = rng.standard_normal(img.shape).astype(np.float32)
    want = _grads_jax(img, grid, g, 3)
    got = _grads_port(img, grid, g, 3)
    for a, b in zip(got, want):
        _close(a, b)


def test_grid_sample_multi_limits_image_grads():
    """n_grad_imgs=1: the second image is detached and the sampling's d img
    covers the first image's channels only."""
    rng = np.random.default_rng(13)
    a = _t(rng.standard_normal((1, 6, 5, 3)).astype(np.float32)).requires_grad_()
    b = _t(rng.standard_normal((1, 6, 5, 1)).astype(np.float32)).requires_grad_()
    grid, _ = _smooth_grid(rng, 1, 6, 5)
    gt = _t(grid).requires_grad_()
    out = twarp.grid_sample_multi([a, b], gt, n_grad_imgs=1)
    (out[0].sum() + out[1].sum()).backward()
    assert a.grad is not None and b.grad is None and gt.grad is not None


def test_sample_plain_bwd_matches_autograd():
    """The written-out backward against torch autograd of the plain gather."""
    img, grid = _imgs(21, c=3)
    x, y = twarp._pixel_coords(_t(img), _t(grid), "zeros", False)
    it, xt, yt = _t(img).double().requires_grad_(), x.double().requires_grad_(), \
        y.double().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape + (3,)))
    want = torch.autograd.grad(twarp._sample_plain(it, xt, yt, "bilinear"), (it, xt, yt), g)
    got = twarp._sample_plain_bwd(it.detach(), xt.detach(), yt.detach(), g, 2)
    torch.testing.assert_close(got[0][..., :2], want[0][..., :2], rtol=0, atol=1e-12)
    assert not torch.any(got[0][..., 2])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 4, 1))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        warp_cuda.warp_bilinear(x, torch.zeros((1, 4, 4, 2)))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        warp_cuda.warp_bilinear_bwd(x, x[..., 0], x[..., 0], x, 1)
    assert warp_cuda.warp_bilinear.launches == 0
    assert warp_cuda.warp_bilinear_bwd.launches == 0


class _PixelSample(torch.autograd.Function):
    """The CPU composition before the grid-in Function: bilinear sampling at
    pixel coordinates, d x and d y chained to the grid by autograd of
    ``_pixel_coords``."""

    @staticmethod
    def forward(ctx, img, x, y, grad_channels):
        ctx.grad_channels = grad_channels
        ctx.save_for_backward(img, x, y)
        return twarp._sample_plain(img, x, y, "bilinear")

    @staticmethod
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        gc = ctx.grad_channels if ctx.needs_input_grad[0] else 0
        return (*twarp._sample_plain_bwd(img, x, y, g, gc), None)


@pytest.mark.parametrize("grad_channels", [0, 3, -1])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_in_function_matches_pixel_composition(padding_mode, align_corners, grad_channels):
    """The grid-in Function (one launch on the card) gives exactly what the
    pixel-coordinate composition gives on the CPU: output, d img, d grid;
    and it matches the JAX grid_sample's VJP at TOL."""
    img, grid = _imgs(7 + len(padding_mode) + 2 * align_corners, c=4)
    g = np.random.default_rng(4).standard_normal(grid.shape[:3] + (4,)).astype(np.float32)
    gc = 4 if grad_channels < 0 else grad_channels

    def run(new):
        it, gt = _t(img).requires_grad_(), _t(grid).requires_grad_()
        if new:
            out = twarp.grid_sample(it, gt, "bilinear", padding_mode, align_corners, grad_channels)
        else:
            x, y = twarp._pixel_coords(it, gt, padding_mode, align_corners)
            out = _PixelSample.apply(it, x, y, gc)
        grads = torch.autograd.grad(out, (it, gt), _t(g), allow_unused=True)
        return out.detach(), *grads

    got, want = run(True), run(False)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (got[1] is None) == (gc == 0)
    ref = _grads_jax(img, grid, g, -1, mode="bilinear", padding_mode=padding_mode,
                     align_corners=align_corners, impl="xla")
    out_jax = jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode,
                                align_corners=align_corners, impl="xla")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out_jax), atol=TOL, rtol=0)
    if gc:
        _close(got[1].numpy()[..., :gc], ref[0][..., :gc])
        assert not np.any(got[1].numpy()[..., gc:])
    _close(got[2].numpy(), ref[1])


def test_bad_grid_shape_raises():
    with pytest.raises(ValueError, match="bad grid shape"):
        twarp.grid_sample(torch.zeros((2, 4, 4, 1)), torch.zeros((1, 4, 4, 2)))
