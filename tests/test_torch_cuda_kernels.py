"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On the H100:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
does not have.) Shapes are the slice's (ResNet-6 G at ngf 64, depth-5 UNet
STN at stn_ngf 32, 256^2); the plain versions run with TF32 off.
"""

import numpy as np
import pytest
import torch

from nemar_tpu_torch.ops import conv_fused, norm, norm_triton, warp, warp_cuda
from nemar_tpu_torch.ops.warp import identity_grid

pytestmark = pytest.mark.cuda

# (C, H, W, act) of every instance norm on the slice's path
IN_SHAPES = [
    (64, 256, 256, "relu"), (128, 128, 128, "relu"), (256, 64, 64, "relu"),  # G
    (32, 128, 128, "leaky_relu"), (64, 64, 64, "leaky_relu"),                 # STN
    (128, 32, 32, "leaky_relu"), (256, 16, 16, "leaky_relu"),
    (256, 8, 8, "leaky_relu"), (32, 256, 256, "leaky_relu"),
    (512, 31, 31, "leaky_relu"), (3, 20, 20, "none"),                          # D, ragged
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py`")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def smooth_grid(rng, n, h, w, px=3.0):
    """Identity grid plus a smooth random field of a few pixels, fractional."""
    coarse = rng.standard_normal((n, 2, 8, 8)).astype(np.float32)
    field = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(h, w),
                                            mode="bicubic", align_corners=False)
    field = field.permute(0, 2, 3, 1) * torch.tensor([2.0 * px / w, 2.0 * px / h])
    return identity_grid(h, w)[None] + field


@pytest.mark.parametrize("n", [1, 8])
def test_warp_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    img = torch.from_numpy(rng.standard_normal((n, 256, 256, 4), dtype=np.float32)).to(dev)
    grid = smooth_grid(rng, n, 256, 256).to(dev)
    before = warp_cuda.warp_bilinear.launches
    got = warp.grid_sample(img, grid)
    ref = warp.grid_sample_plain(img, grid)
    torch.cuda.synchronize()
    assert warp_cuda.warp_bilinear.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-5


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_kernel_padding_modes(dev, padding_mode, align_corners):
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.standard_normal((2, 33, 47, 3), dtype=np.float32)).to(dev)
    grid = torch.from_numpy(rng.uniform(-1.3, 1.3, (2, 21, 19, 2)).astype(np.float32)).to(dev)
    got = warp.grid_sample(img, grid, padding_mode=padding_mode, align_corners=align_corners)
    ref = warp.grid_sample_plain(img, grid, padding_mode=padding_mode,
                                 align_corners=align_corners)
    assert torch.max(torch.abs(got - ref)).item() < 1e-5


def test_warp_nearest_raises_on_cuda(dev):
    img = torch.zeros((1, 8, 8, 1), device=dev)
    with pytest.raises(NotImplementedError):
        warp.grid_sample(img, identity_grid(8, 8, device=dev)[None], mode="nearest")


@pytest.mark.parametrize("c,h,w,act", IN_SHAPES)
def test_in_kernel_matches_plain(dev, c, h, w, act):
    rng = np.random.default_rng(c + h)
    x = torch.from_numpy(
        (rng.standard_normal((2, h, w, c)) * 2.0 + 0.5).astype(np.float32)).to(dev)
    before = norm_triton.instance_norm_act_triton.launches
    got = norm.instance_norm_act(x, act)
    ref = norm.instance_norm_act_plain(x, act)
    torch.cuda.synchronize()
    assert norm_triton.instance_norm_act_triton.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-5


@pytest.mark.parametrize("n", [1, 8])
def test_block_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    c = 256
    x = torch.from_numpy(rng.standard_normal((n, 64, 64, c), dtype=np.float32)).to(dev)
    w1, w2 = (torch.from_numpy((0.02 * rng.standard_normal((3, 3, c, c))).astype(np.float32)).to(dev)
              for _ in range(2))
    before = conv_fused.fused_resblock_cuda.launches
    got = conv_fused.fused_resblock(x, w1, w2)
    ref = conv_fused.resblock_plain(x, w1, w2)
    torch.cuda.synchronize()
    assert conv_fused.fused_resblock_cuda.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-3


def test_block_kernel_refuses_unsupported_shapes(dev):
    x = torch.zeros((1, 8, 8, 96), device=dev)
    w = torch.zeros((3, 3, 96, 96), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        conv_fused.fused_resblock(x, w, w)


def test_kernels_refuse_autograd_inputs(dev):
    """No backward kernel yet: a tensor that needs a gradient is refused
    (under no_grad the same call runs)."""
    x = torch.zeros((1, 8, 8, 128), device=dev, requires_grad=True)
    w = torch.zeros((3, 3, 128, 128), device=dev)
    grid = identity_grid(8, 8, device=dev)[None]
    for call in (lambda: conv_fused.fused_resblock(x, w, w),
                 lambda: norm.instance_norm_act(x),
                 lambda: warp.grid_sample(x, grid)):
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().shape[0] == 1
