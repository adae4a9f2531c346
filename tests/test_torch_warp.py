"""The port's warp ops (nemar_tpu_torch.ops.warp) against the JAX package's.

Same numpy inputs through both; on the CPU the port takes its plain gather,
which the CUDA kernel K-warp is held against on the card
(tests/test_torch_cuda_kernels.py). Tolerance 1e-5 (fp32 roundoff of the
coordinate transform and the four-tap sum).
"""

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


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 4, 1))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        warp_cuda.warp_bilinear(x, x[..., 0], x[..., 0])
    assert warp_cuda.warp_bilinear.launches == 0


def test_bad_grid_shape_raises():
    with pytest.raises(ValueError, match="bad grid shape"):
        twarp.grid_sample(torch.zeros((2, 4, 4, 1)), torch.zeros((1, 4, 4, 2)))
