"""K-in's double backward: the port's instance norm + activation can be
differentiated twice, as the WGAN-GP penalty differentiates D.

The first-order backward of ``ops.norm.instance_norm_act`` is its own
``autograd.Function`` from (x, stats, g) to d x; its backward is the VJP of
the JAX package's ``_in_act_vjp_bwd`` (``nemar_tpu/ops/norm.py``), which
recomputes the mean and the variance from x. So ``(d x, d g)`` of
``<gg, bwd(x, g)>`` must equal ``jax.vjp`` of ``_in_act_vjp_bwd``, within
1e-5 of its largest value in fp32 (roundoff of a few sums over 30 pixels),
for each activation, and torch's ``gradcheck`` and ``gradgradcheck`` must
pass in float64. Before, the backward used the forward's statistics as
constants and dropped every term through them, silently.

The backward of every other kernel Function (K-block's, K-head's,
K-convt's, K-warp's) is marked ``once_differentiable``: a double backward
through G or through the warp raises instead of returning a wrong gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import norm as jnorm
from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm, warp

ACTS = ["none", "relu", "leaky_relu"]


def _draw(seed, shape=(2, 5, 6, 3)):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal(shape) + 0.5
    return x, rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("act", ACTS)
def test_double_backward_matches_jax(act):
    x, g, gg = (a.astype(np.float32) for a in _draw(ACTS.index(act)))
    xt, gt = torch.tensor(x, requires_grad=True), torch.tensor(g, requires_grad=True)
    (dx,) = torch.autograd.grad(norm.instance_norm_act(xt, act), xt, gt, create_graph=True)
    ddx, dg = torch.autograd.grad(dx, (xt, gt), torch.tensor(gg))

    def bwd(a, b):
        return jnorm._in_act_vjp_bwd(act, 1e-5, 0.2, a, b)[0]

    jdx, vjp = jax.vjp(bwd, jnp.asarray(x), jnp.asarray(g))
    jddx, jdg = vjp(jnp.asarray(gg))
    for got, want in ((dx, jdx), (ddx, jddx), (dg, jdg)):
        want = np.asarray(want)
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (act, err)
    # the terms through the statistics are there: without them d x differs
    stats = norm.instance_norm_stats(torch.tensor(x))
    xc = torch.tensor(x, requires_grad=True)
    frozen = norm.instance_norm_act_bwd_plain(xc, torch.tensor(g), stats, act)
    (ddx_frozen,) = torch.autograd.grad(frozen, xc, torch.tensor(gg))
    assert float((ddx_frozen - ddx).abs().max()) > 1e-2 * float(np.abs(jddx).max())


@pytest.mark.parametrize("act", ACTS)
def test_gradcheck_and_gradgradcheck_float64(act):
    x, _, _ = _draw(10 + ACTS.index(act), (2, 4, 5, 3))
    xt = torch.tensor(x, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: norm.instance_norm_act(a, act), (xt,))
    assert torch.autograd.gradgradcheck(lambda a: norm.instance_norm_act(a, act), (xt,))


def _op_call(op, rng):
    """(output, inputs) of one kernel Function on small CPU tensors."""
    def t(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=True)

    if op == "K-block":
        args = (t(1, 8, 8, 4), t(3, 3, 4, 4, scale=0.1), t(3, 3, 4, 4, scale=0.1))
        return conv_fused.fused_resblock(*args), args
    if op == "K-head":
        args = (t(1, 8, 8, 4), t(7, 7, 4, 3, scale=0.1))
        return conv_head.conv_head(*args), args
    if op == "K-convt":
        args = (t(1, 4, 4, 4), t(3, 3, 4, 4, scale=0.1))
        return convt_fused.fused_convt_in(*args), args
    grid = torch.tensor(rng.uniform(-0.9, 0.9, (1, 8, 8, 2)), dtype=torch.float32,
                        requires_grad=True)
    args = (t(1, 8, 8, 2), grid)
    return warp.grid_sample(*args), args


@pytest.mark.parametrize("op", ["K-block", "K-head", "K-convt", "K-warp"])
def test_other_kernel_functions_refuse_a_double_backward(op):
    y, args = _op_call(op, np.random.default_rng(3))
    first = torch.autograd.grad((y * y).sum(), args, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        sum(f.sum() for f in first).backward()
