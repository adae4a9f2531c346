"""The port's instance norm + activation against the JAX package's.

The JAX side runs its Pallas kernel (``impl='pallas'``, interpret mode on the
CPU); the port takes its plain version on the CPU, which the Triton kernel
K-in is held against on the card (tests/test_torch_cuda_kernels.py). The
backward's plain version is held against the JAX package's analytic VJP
(``_in_act_vjp_bwd``), which K-in-bwd replaces on the card. Tolerance 1e-5
(fp32 roundoff of the statistics over H*W).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import norm as jnorm
from nemar_tpu_torch.ops import norm as tnorm
from nemar_tpu_torch.ops import norm_triton

torch.set_num_threads(2)


def _x(seed, shape=(2, 12, 20, 24)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_instance_norm_act_matches_jax_pallas(act):
    x = _x(len(act))
    ref = jnorm.instance_norm_act(jnp.asarray(x), act=act, impl="pallas")
    got = tnorm.instance_norm_act(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_instance_norm_act_bwd_plain_matches_jax_vjp(act):
    x = _x(10 + len(act))
    g = np.random.default_rng(len(act)).standard_normal(x.shape).astype(np.float32)
    (want,) = jnorm._in_act_vjp_bwd(act, 1e-5, 0.2, jnp.asarray(x), jnp.asarray(g))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = tnorm.instance_norm_act_bwd_plain(xt, gt, tnorm.instance_norm_stats(xt), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the differentiable op's backward is that plain version on the CPU
    xg = xt.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tnorm.instance_norm_act(xg, act), xg, gt)
    np.testing.assert_array_equal(dx.numpy(), got.numpy())


def test_instance_norm_matches_jax_and_torch():
    x = _x(9, (2, 7, 5, 6))
    got = tnorm.instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnorm.instance_norm(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    oracle = torch.nn.InstanceNorm2d(6)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), oracle.permute(0, 2, 3, 1).numpy(), atol=1e-5, rtol=0)


def test_unknown_act_raises_and_kernel_refuses_cpu():
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="unknown act"):
        tnorm.instance_norm_act(x, "gelu")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        norm_triton.instance_norm_act_triton(x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        norm_triton.instance_norm_act_bwd_triton(x, x, torch.zeros((1, 2, 2)))
    assert norm_triton.instance_norm_act_triton.launches == 0
    assert norm_triton.instance_norm_act_bwd_triton.launches == 0


def test_launch_shape_fills_the_card_at_batch_one():
    """K-in's grid: whole row tiles, and about four programs per SM even for
    the STN's 32-channel 256^2 layer at batch 1."""
    block_c, block_r, rows, n_split = norm_triton._launch_shape(1, 256 * 256, 32, 132)
    assert block_c == 32 and rows % block_r == 0
    assert n_split * rows >= 256 * 256 > (n_split - 1) * rows
    assert n_split >= 4 * 132 // 2
    assert norm_triton._launch_shape(2, 31 * 31, 512, 132)[0] == 64
    assert norm_triton._launch_shape(1, 20 * 20, 3, 132)[0] == 4
