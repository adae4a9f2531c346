"""The port's fused ResNet block against the JAX package's ``fused_resblock``.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the port
takes ``resblock_plain`` on the CPU, which the CUDA kernel K-block is held
against on the card (tests/test_torch_cuda_kernels.py). Tolerance 1e-4
(two fp32 3x3 convolutions over 128 channels, each normalised).
"""

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
    assert not tfused.block_kernel_supported((1, 4, 4, 128))
    x = torch.zeros((1, 8, 8, 128))
    w = torch.zeros((3, 3, 128, 128))
    with pytest.raises(ValueError, match="one CUDA device"):
        tfused.fused_resblock_cuda(x, w, w)
    assert tfused.fused_resblock_cuda.launches == 0
