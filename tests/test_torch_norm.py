"""The port's instance norm + activation against the JAX package's.

The JAX side runs its Pallas kernel (``impl='pallas'``, interpret mode on the
CPU); the port takes its plain version on the CPU, which the CUDA kernel
K-in is held against on the card (tests/test_torch_cuda_kernels.py). The
backward's plain version is held against the JAX package's analytic VJP
(``_in_act_vjp_bwd``), which K-in-bwd replaces on the card. Tolerance 1e-5
(fp32 roundoff of the statistics over H*W).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import norm as jnorm
from nemar_tpu_torch.ops import norm as tnorm
from nemar_tpu_torch.ops import _build, norm_cuda

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
        norm_cuda.instance_norm_act_cuda(x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        norm_cuda.instance_norm_act_bwd_cuda(x, x, torch.zeros((1, 2, 2)))
    assert norm_cuda.instance_norm_act_cuda.launches == 0
    assert norm_cuda.instance_norm_act_bwd_cuda.launches == 0


class _CudaStandIn:
    """Passes the wrappers' device check in place of a CUDA tensor; the
    operator it reaches is a recorder."""

    is_cuda = True
    device = "cuda:0"


def _schema_args(op_name):
    """Argument names of ``torch.ops.nemar.<op_name>`` as csrc/ops.cpp
    registers it."""
    text = (Path(_build.CSRC_DIR) / "ops.cpp").read_text()
    args = re.search(rf'm\.def\("{op_name}\((.*?)\) ->', text).group(1)
    return [a.split()[-1] for a in args.split(",")]


@pytest.mark.parametrize("act,code", [("none", 0), ("relu", 1), ("leaky_relu", 2)])
def test_wrappers_pass_act_eps_slope_in_schema_order(monkeypatch, act, code):
    """The work split lives in C++ (csrc/in_act.cuh); the wrappers hand the
    operators their arguments in the order of the schemas csrc/ops.cpp
    registers, in_act_fwd(x, act, eps, slope) and in_act_bwd(x, g, stats,
    act, slope), and count one launch a call."""
    assert _schema_args("in_act_fwd") == ["x", "act", "eps", "slope"]
    assert _schema_args("in_act_bwd") == ["x", "g", "stats", "act", "slope"]
    calls = []

    def op(name):
        def run(*args):
            calls.append((name, args))
            return ("y", "stats") if name == "in_act_fwd" else "dx"

        return run

    monkeypatch.setattr(_build, "op", op)
    monkeypatch.setattr(norm_cuda.instance_norm_act_cuda, "launches", 0)
    monkeypatch.setattr(norm_cuda.instance_norm_act_bwd_cuda, "launches", 0)
    x, g, stats = _CudaStandIn(), _CudaStandIn(), _CudaStandIn()
    assert norm_cuda.instance_norm_act_cuda(x, act, 3e-5, 0.125) == ("y", "stats")
    assert norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, act, 0.375) == "dx"
    assert calls == [("in_act_fwd", (x, code, 3e-5, 0.125)),
                     ("in_act_bwd", (x, g, stats, code, 0.375))]
    assert norm_cuda.instance_norm_act_cuda.launches == 1
    assert norm_cuda.instance_norm_act_bwd_cuda.launches == 1
