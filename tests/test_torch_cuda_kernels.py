"""The port's Hopper kernels, forward and backward, against their plain
PyTorch versions, on the card.

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


@pytest.mark.parametrize("c,h,w,act", IN_SHAPES)
def test_in_bwd_kernel_matches_plain(dev, c, h, w, act):
    """K-in-bwd through autograd against the plain backward, 1e-5 of the
    largest gradient; the forward's stats against the plain stats."""
    rng = np.random.default_rng(c + h + 1)
    x = torch.from_numpy(
        (rng.standard_normal((2, h, w, c)) * 2.0 + 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dev)
    _, stats = norm_triton.instance_norm_act_triton(x, act)
    assert torch.max(torch.abs(stats - norm.instance_norm_stats(x))).item() < 1e-5
    before = norm_triton.instance_norm_act_bwd_triton.launches
    xg = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(norm.instance_norm_act(xg, act), xg, g)
    ref = norm.instance_norm_act_bwd_plain(x, g, stats, act)
    torch.cuda.synchronize()
    assert norm_triton.instance_norm_act_bwd_triton.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-5 * torch.max(torch.abs(ref)).item()


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


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 2, 32, 128), (1, 16, 4, 256),
                                   (1, 64, 64, 256), (8, 64, 64, 256)])
def test_block_bwd_kernel_matches_plain(dev, shape):
    """K-block-bwd against the written-out plain backward, 1e-3 of each
    output's largest value, at shapes whose edges and corners (H or W of 2)
    exercise the reflect-pad fold; fed the plain forward's saved values, so
    both take the same relu mask. Bit-for-bit repeatable."""
    rng = np.random.default_rng(shape[1] + shape[2])
    n, h, w, c = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    w1, w2 = (torch.from_numpy((0.02 * rng.standard_normal((3, 3, c, c))).astype(np.float32)).to(dev)
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]
    got = conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)
    again = conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)
    ref = conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert torch.max(torch.abs(a - r)).item() < 1e-3 * torch.max(torch.abs(r)).item()


def test_block_autograd_runs_the_kernels(dev):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 128)).astype(np.float32)).to(dev)
    ws = [torch.from_numpy((0.05 * rng.standard_normal((3, 3, 128, 128))).astype(np.float32))
          .to(dev) for _ in range(2)]
    args = [x.requires_grad_(), *(w.requires_grad_() for w in ws)]
    g = torch.randn(2, 8, 8, 128, device=dev)
    before = conv_fused.resblock_bwd_cuda.launches
    got = torch.autograd.grad(conv_fused.fused_resblock(*args), args, g)
    want = torch.autograd.grad(conv_fused.resblock_plain(*args), args, g)
    assert conv_fused.resblock_bwd_cuda.launches == before + 1
    for a, b in zip(got, want):
        assert torch.max(torch.abs(a - b)).item() < 1e-3 * torch.max(torch.abs(b)).item()


def test_block_kernel_refuses_unsupported_shapes(dev):
    x = torch.zeros((1, 8, 8, 96), device=dev)
    w = torch.zeros((3, 3, 96, 96), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        conv_fused.fused_resblock(x, w, w)


def test_kernels_refuse_autograd_inputs(dev):
    """The kernels have backward kernels now: a tensor that needs a gradient
    goes through them (forward and backward), as under no_grad the forward
    alone does."""
    x = torch.zeros((1, 8, 8, 128), device=dev, requires_grad=True)
    w = torch.zeros((3, 3, 128, 128), device=dev)
    grid = identity_grid(8, 8, device=dev)[None]
    for call in (lambda: conv_fused.fused_resblock(x, w, w),
                 lambda: norm.instance_norm_act(x),
                 lambda: warp.grid_sample(x, grid)):
        (dx,) = torch.autograd.grad(call().sum(), x)
        assert dx.shape == x.shape and bool(torch.isfinite(dx).all())
        with torch.no_grad():
            assert call().shape[0] == 1


@pytest.mark.parametrize("n", [1, 8])
def test_warp_bwd_kernel_matches_plain(dev, n):
    """K-warp-bwd against the plain backward (d img for 3 of 4 channels,
    exact zeros for the 4th; d x, d y), 1e-5 of the largest value, and bit
    for bit repeatable (the fixed-point scatter)."""
    rng = np.random.default_rng(n + 5)
    img = torch.from_numpy(rng.standard_normal((n, 256, 256, 4), dtype=np.float32)).to(dev)
    grid = smooth_grid(rng, n, 256, 256).to(dev)
    xs, ys = (t.contiguous() for t in warp._pixel_coords(img, grid, "zeros", False))
    g = torch.from_numpy(rng.standard_normal((n, 256, 256, 4), dtype=np.float32)).to(dev)
    before = warp_cuda.warp_bilinear_bwd.launches
    got = warp_cuda.warp_bilinear_bwd(img, xs, ys, g, 3)
    again = warp_cuda.warp_bilinear_bwd(img, xs, ys, g, 3)
    ref = warp._sample_plain_bwd(img, xs, ys, g, 3)
    torch.cuda.synchronize()
    assert warp_cuda.warp_bilinear_bwd.launches == before + 2
    assert not torch.any(got[0][..., 3])
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert torch.max(torch.abs(a - r)).item() < 1e-5 * torch.max(torch.abs(r)).item()


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_grads_padding_modes(dev, padding_mode, align_corners):
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.standard_normal((2, 33, 47, 3), dtype=np.float32)).to(dev)
    grid = torch.from_numpy(rng.uniform(-1.3, 1.3, (2, 21, 19, 2)).astype(np.float32)).to(dev)
    g = torch.randn(2, 21, 19, 3, device=dev)
    args = [img.requires_grad_(), grid.requires_grad_()]
    got = torch.autograd.grad(warp.grid_sample(*args, "bilinear", padding_mode, align_corners),
                              args, g)
    want = torch.autograd.grad(
        warp.grid_sample_plain(*args, "bilinear", padding_mode, align_corners), args, g)
    for a, b in zip(got, want):
        assert torch.max(torch.abs(a - b)).item() < 1e-5 * torch.max(torch.abs(b)).item()
