"""The port's fused decoder stage (``nemar_tpu_torch/ops/convt_fused.py``:
ConvTranspose 3x3 s2 'SAME' + instance norm + relu) against the JAX
package's: the Pallas kernel B5 (``nemar_tpu/ops/attic/convt_fused.py:
fused_convt_in``, interpret mode on the CPU, as ``tests/test_convt_fused.py``
runs it) where it takes the shape, and its XLA reference
``convt_in_reference`` at Co = 64 (the generator's second stage, which the
JAX package routes there) and at odd sizes. Forward, dx and dW for one
seeded cotangent, each within 1e-4 of the largest reference value (fp32
roundoff of 9 * Ci-term sums and of the instance norm's reductions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops.attic.convt_fused import convt_in_reference
from nemar_tpu.ops.attic.convt_fused import fused_convt_in as jax_fused_convt_in
from nemar_tpu_torch.ops.convt_fused import (
    convt_in_bwd_plain, convt_in_fwd_plain, convt_in_plain, fused_convt_in, wgrad_splits,
)

TOL = 1e-4


def _data(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, shape[-1], co))).astype(np.float32)
    n, h, wd, _ = shape
    g = rng.standard_normal((n, 2 * h, 2 * wd, co)).astype(np.float32)
    return x, w, g


def _port(x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fused_convt_in(xt, wt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _jax(fn, x, w, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _close(got, want, what):
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        err = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
        assert err <= TOL, (what, name, err)


def test_matches_b5_kernel():
    x, w, g = _data((2, 8, 8, 128), 128)
    _close(_port(x, w, g), _jax(jax_fused_convt_in, x, w, g), "B5")


@pytest.mark.parametrize("shape,co", [((2, 8, 8, 128), 64), ((1, 16, 16, 32), 64),
                                      ((1, 5, 7, 12), 8), ((2, 3, 4, 4), 4)])
def test_matches_xla_reference(shape, co):
    x, w, g = _data(shape, co, seed=1)
    _close(_port(x, w, g), _jax(convt_in_reference, x, w, g), f"reference {shape}->{co}")


@pytest.mark.parametrize("shape,co", [((2, 4, 5, 8), 4), ((1, 6, 6, 4), 12)])
def test_plain_backward_matches_autograd(shape, co):
    x, w, g = (torch.from_numpy(a).double() for a in _data(shape, co, seed=2))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx, dw = torch.autograd.grad(convt_in_plain(xt, wt), (xt, wt), g)
    px, pw = convt_in_bwd_plain(x, w, g)
    torch.testing.assert_close(px, dx, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(pw, dw, rtol=1e-10, atol=1e-10)


def test_saved_values_are_the_normalised_output():
    x, w, _ = (torch.from_numpy(a) for a in _data((2, 4, 4, 8), 4, seed=3))
    out, yhat, stats = convt_in_fwd_plain(x, w)
    assert yhat.shape == out.shape == (2, 8, 8, 4) and stats.shape == (2, 2, 4)
    torch.testing.assert_close(out, yhat.clamp_min(0.0))
    torch.testing.assert_close(yhat.mean(dim=(1, 2)), torch.zeros(2, 4), atol=1e-6, rtol=0)


@pytest.mark.parametrize("pixels", [16, 4096, 32768, 131072, 1000])
def test_wgrad_splits_cover_the_pixels(pixels):
    splits, per = wgrad_splits(pixels)
    assert per % 8 == 0 and splits * per >= pixels > (splits - 1) * per
