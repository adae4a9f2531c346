"""The port's fused ResNet block against the JAX package's ``fused_resblock``.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
takes ``resblock_plain`` and ``resblock_bwd_plain`` on the CPU, which the
CUDA kernels K-block and K-block-bwd are held against on the card
(tests/test_torch_cuda_kernels.py). Tolerances: forward 1e-4 absolute (two
fp32 3x3 convolutions over 128 channels, each normalised); gradients
‖Δ‖/‖ref‖ <= 1e-5 (the same, backwards, summed over the batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.ops import conv_fused as jfused
from nemar_tpu_torch.ops import conv_fused as tfused

torch.set_num_threads(2)


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w1, w2 = (0.05 * rng.standard_normal((3, 3, c, c))).astype(np.float32), \
        (0.05 * rng.standard_normal((3, 3, c, c))).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 16, 16, 128)])
def test_resblock_plain_matches_jax_fused_kernel(shape):
    x, w1, w2 = _data(shape[0], shape)
    ref = jfused.fused_resblock(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    args = [torch.from_numpy(a) for a in (x, w1, w2)]
    got = tfused.resblock_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # the dispatching op takes the plain version for CPU tensors
    np.testing.assert_array_equal(tfused.fused_resblock(*args).numpy(), got.numpy())


def test_kernel_shape_rule_and_cpu_refusal():
    assert tfused.block_kernel_supported((8, 64, 64, 256))
    assert not tfused.block_kernel_supported((1, 8, 8, 96))
    # a sample's ragged last pixel tile is masked by the kernels; a frame
    # must be at least 2 x 2 to reflect
    assert tfused.block_kernel_supported((1, 4, 4, 128))
    assert not tfused.block_kernel_supported((1, 1, 4, 128))
    x = torch.zeros((1, 8, 8, 128))
    w = torch.zeros((3, 3, 128, 128))
    with pytest.raises(ValueError, match="one CUDA device"):
        tfused.fused_resblock_cuda(x, w, w)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfused.resblock_bwd_cuda(x, w, w, x, x, torch.zeros((1, 4, 128)), x)
    assert tfused.fused_resblock_cuda.launches == 0
    assert tfused.resblock_bwd_cuda.launches == 0


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want))
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


# the JAX VJP's TPU layouts: (NEMAR_FUSED_IMPL, NEMAR_FUSED_BWD)
@pytest.mark.parametrize("impl,bwd", [("taps", "planes"), ("taps", "legacy"),
                                      ("hybrid", "planes")])
def test_fused_resblock_grads_match_jax_pallas_vjp(monkeypatch, impl, bwd):
    monkeypatch.setenv("NEMAR_FUSED_IMPL", impl)
    monkeypatch.setenv("NEMAR_FUSED_BWD", bwd)
    x, w1, w2 = _data(7, (2, 8, 16, 128))
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(jfused.fused_resblock, jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    want = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    got = torch.autograd.grad(tfused.fused_resblock(*args), args, torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw1", "dw2"), got, want):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("shape", [(2, 5, 6, 8), (1, 2, 2, 4), (1, 3, 4, 4)])
def test_resblock_bwd_plain_matches_autograd(shape):
    """The written-out VJP against torch autograd of the plain forward, in
    fp64, at shapes whose every pixel is an edge (H or W of 2 or 3)."""
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    w1, w2 = (torch.from_numpy(0.3 * rng.standard_normal((3, 3, c, c))).requires_grad_()
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(shape))
    want = torch.autograd.grad(tfused.resblock_plain(x, w1, w2), (x, w1, w2), g)
    got = tfused.resblock_bwd_plain(x.detach(), w1.detach(), w2.detach(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
