"""The port's 7x7 head conv (``nemar_tpu_torch/ops/conv_head.py``) against
the JAX package's two TPU kernels of the same function, run on the CPU in
interpret mode as their own tests run them: B4
(``nemar_tpu/ops/conv_head_roll.py``, at ``tests/test_conv_head_roll.py``'s
shapes) and B6 (``nemar_tpu/ops/attic/conv_head.py``, at
``tests/test_conv_head.py``'s), forward and both gradients for one seeded
cotangent. Tolerance 1e-4 of the largest reference value (fp32 roundoff of
49 * Ci-term sums and of the kernels' own split into border strips). The
plain backward is also held against autograd, and against JAX's direct conv
at 5 x 5, where every pixel is an edge of the reflect pad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops.attic.conv_head import conv_head as jax_conv_head_b6
from nemar_tpu.ops.conv_head_roll import _direct, conv_head_roll
from nemar_tpu_torch.ops.conv_fused import reflect_pad_adjoint
from nemar_tpu_torch.ops.conv_head import conv_head, conv_head_bwd_plain, conv_head_plain

TOL = 1e-4


def _data(shape, co, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (scale * rng.standard_normal((7, 7, shape[-1], co))).astype(np.float32)
    g = rng.standard_normal((*shape[:3], co)).astype(np.float32)
    return x, w, g


def _port(x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = conv_head(xt, wt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _jax(fn, x, w, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _close(got, want, what):
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        assert a.shape == b.shape, (what, name)
        err = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
        assert err <= TOL, (what, name, err)


@pytest.mark.parametrize("shape,co", [((2, 16, 128, 8), 3), ((1, 8, 128, 16), 2),
                                      ((2, 12, 256, 4), 3)])
def test_matches_b4_roll_kernel(shape, co):
    x, w, g = _data(shape, co)
    _close(_port(x, w, g), _jax(conv_head_roll, x, w, g), f"B4 {shape}")


def test_matches_b6_kernel():
    x, w, g = _data((2, 16, 128, 64), 3, seed=1, scale=0.05)
    _close(_port(x, w, g), _jax(jax_conv_head_b6, x, w, g), "B6")


@pytest.mark.parametrize("shape,co", [((2, 5, 5, 3), 3), ((1, 4, 9, 2), 8), ((1, 7, 6, 5), 1)])
def test_all_edges_match_jax_direct(shape, co):
    """At 5 x 5 every row and column is within 3 of an edge, so every dx
    element folds reflected positions (up to 3 per axis)."""
    x, w, g = _data(shape, co, seed=2)
    _close(_port(x, w, g), _jax(_direct, x, w, g), f"direct {shape}")


@pytest.mark.parametrize("shape,co", [((2, 6, 7, 4), 3), ((1, 16, 12, 8), 8)])
def test_plain_backward_matches_autograd(shape, co):
    x, w, g = _data(shape, co, seed=3)
    xt = torch.from_numpy(x).double().requires_grad_()
    wt = torch.from_numpy(w).double().requires_grad_()
    gt = torch.from_numpy(g).double()
    dx, dw = torch.autograd.grad(conv_head_plain(xt, wt), (xt, wt), gt)
    px, pw = conv_head_bwd_plain(xt.detach(), wt.detach(), gt)
    torch.testing.assert_close(px, dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pw, dw, rtol=1e-12, atol=1e-12)


def test_reflect_pad_adjoint_is_the_pads_transpose():
    """<pad(x), y> == <x, pad_adjoint(y)> for reflect pads 1 and 3."""
    rng = np.random.default_rng(4)
    for pad, (h, w) in ((3, (5, 4)), (3, (9, 7)), (1, (2, 3))):
        x = torch.from_numpy(rng.standard_normal((2, h, w, 3))).double()
        y = torch.from_numpy(rng.standard_normal((2, h + 2 * pad, w + 2 * pad, 3))).double()
        xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                                     mode="reflect").permute(0, 2, 3, 1)
        lhs = float((xp * y).sum())
        rhs = float((x * reflect_pad_adjoint(y, pad)).sum())
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs), (pad, h, w)


def test_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="CUDA"):
        from nemar_tpu_torch.ops.conv_head import conv_head_cuda

        conv_head_cuda(torch.zeros(1, 8, 8, 4), torch.zeros(7, 7, 4, 3))
