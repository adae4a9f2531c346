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

from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm, norm_triton, warp
from nemar_tpu_torch.ops import warp_cuda
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


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_grid_kernel_matches_torch(dev, padding_mode, align_corners):
    """K-warp from the normalised grid, one launch, against F.grid_sample on
    the same image and grid (grid points off the frame included)."""
    rng = np.random.default_rng(17)
    img = torch.from_numpy(rng.standard_normal((2, 37, 29, 4), dtype=np.float32)).to(dev)
    grid = torch.from_numpy(rng.uniform(-1.4, 1.4, (2, 23, 31, 2)).astype(np.float32)).to(dev)
    before = warp_cuda.warp_bilinear.launches
    got = warp_cuda.warp_bilinear(img, grid, padding_mode, align_corners)
    torch.cuda.synchronize()
    assert warp_cuda.warp_bilinear.launches == before + 1
    ref = torch.nn.functional.grid_sample(img.permute(0, 3, 1, 2), grid, "bilinear", padding_mode,
                                          align_corners).permute(0, 2, 3, 1)
    assert torch.max(torch.abs(got - ref)).item() < 1e-5


def test_warp_grid_op_refuses_what_it_cannot_run(dev):
    img = torch.zeros((1, 8, 8, 3), device=dev)
    grid = identity_grid(8, 8, device=dev)[None]
    with pytest.raises(RuntimeError, match="float32"):
        warp_cuda.warp_bilinear(img, grid.double())
    with pytest.raises(RuntimeError, match="bad grid"):
        warp_cuda.warp_bilinear(img, grid[..., :1])
    with pytest.raises(ValueError, match="padding_mode"):
        warp_cuda.warp_bilinear(img, grid, "wrap")
    # a non-contiguous grid is made contiguous, as the model may hand one over
    t = torch.stack([grid[..., 1], grid[..., 0]], dim=1).permute(0, 2, 3, 1)[..., [1, 0]]
    assert torch.equal(warp_cuda.warp_bilinear(img, t), warp_cuda.warp_bilinear(img, grid))


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
                                   (3, 4, 16, 128), (1, 64, 64, 256), (8, 64, 64, 256)])
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


def test_block_bwd_kernel_fp64_accuracy(dev):
    """K-block-bwd's 3xTF32 GEMMs keep fp32-level accuracy: against the plain
    backward in float64 (from the same fp32 inputs and saved values, so the
    relu mask is the same), its largest relative error is at most 4x that of
    the fp32 plain version (1xTF32 would be ~100x)."""
    rng = np.random.default_rng(19)
    shape = (2, 32, 32, 256)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    w1, w2 = (torch.from_numpy((0.02 * rng.standard_normal((3, 3, 256, 256))).astype(np.float32))
              .to(dev) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]
    got = conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)
    ref32 = conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved)
    ref64 = conv_fused.resblock_bwd_plain(x.double(), w1.double(), w2.double(), g.double(),
                                          saved=tuple(t.double() for t in saved))

    def rel(a, b):
        return max(float((p.double() - q).abs().max() / q.abs().max()) for p, q in zip(a, b))

    assert rel(got, ref64) <= 4 * rel(ref32, ref64)


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


def _randn(rng, shape, scale, dev):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)


# (N, H, W, Ci, Co): G's head at 256^2, ragged tiles, and shapes where every
# pixel is an edge of the reflect pad (H or W of 4 and 5)
HEAD_SHAPES = [(1, 256, 256, 64, 3), (8, 256, 256, 64, 3), (2, 37, 70, 20, 8),
               (1, 5, 5, 12, 1), (2, 4, 9, 8, 5), (1, 40, 4, 64, 2)]


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_kernel_matches_plain(dev, shape):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(h + w)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    before = conv_head.conv_head_cuda.launches
    got = conv_head.conv_head(x, wk)
    ref = conv_head.conv_head_plain(x, wk)
    torch.cuda.synchronize()
    assert conv_head.conv_head_cuda.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-4 * max(1.0, torch.max(torch.abs(ref)).item())


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_bwd_kernel_matches_plain(dev, shape):
    """K-head-bwd against the written-out plain backward, 1e-4 of each
    output's largest value (the reflect-pad fold at every edge included),
    bit for bit repeatable, and reached through autograd."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(h * w)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    g = _randn(rng, (n, h, w, co), 1.0, dev)
    got = conv_head.conv_head_bwd_cuda(x, wk, g)
    again = conv_head.conv_head_bwd_cuda(x, wk, g)
    ref = conv_head.conv_head_bwd_plain(x, wk, g)
    before = conv_head.conv_head_bwd_cuda.launches
    args = [x.clone().requires_grad_(), wk.clone().requires_grad_()]
    auto = torch.autograd.grad(conv_head.conv_head(*args), args, g)
    torch.cuda.synchronize()
    assert conv_head.conv_head_bwd_cuda.launches == before + 1
    for a, b, c, r in zip(got, again, auto, ref):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.max(torch.abs(a - r)).item() < 1e-4 * torch.max(torch.abs(r)).item()


# (N, H, W, Ci, Co): G's two decoder stages, ragged tiles and channels
CONVT_SHAPES = [(1, 64, 64, 256, 128), (8, 64, 64, 256, 128), (1, 128, 128, 128, 64),
                (8, 128, 128, 128, 64), (2, 5, 7, 12, 8), (1, 9, 3, 132, 20)]


@pytest.mark.parametrize("shape", CONVT_SHAPES)
def test_convt_kernel_matches_plain(dev, shape):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(h + ci)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (3, 3, ci, co), 0.05, dev)
    before = convt_fused.fused_convt_in_cuda.launches
    out, yhat, stats = convt_fused.fused_convt_in_cuda(x, wk)
    ref = convt_fused.convt_in_fwd_plain(x, wk)
    torch.cuda.synchronize()
    assert convt_fused.fused_convt_in_cuda.launches == before + 1
    for a, r in zip((out, yhat, stats[:, 0]), (ref[0], ref[1], ref[2][:, 0])):
        assert torch.max(torch.abs(a - r)).item() < 1e-4
    assert torch.max(torch.abs(stats[:, 1] / ref[2][:, 1] - 1)).item() < 1e-4


@pytest.mark.parametrize("shape", CONVT_SHAPES)
def test_convt_bwd_kernel_matches_plain(dev, shape):
    """K-convt-bwd against the written-out plain backward, 1e-4 of each
    output's largest value, fed the plain forward's saved (yhat, stats) so
    both take the same relu mask; bit for bit repeatable."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(h + ci + 1)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (3, 3, ci, co), 0.05, dev)
    g = _randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev)
    saved = convt_fused.convt_in_fwd_plain(x, wk)[1:]
    got = convt_fused.convt_in_bwd_cuda(x, wk, *saved, g)
    again = convt_fused.convt_in_bwd_cuda(x, wk, *saved, g)
    ref = convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert torch.max(torch.abs(a - r)).item() < 1e-4 * torch.max(torch.abs(r)).item()


def test_convt_autograd_runs_the_kernels(dev):
    rng = np.random.default_rng(11)
    args = [_randn(rng, (2, 8, 8, 32), 1.0, dev).requires_grad_(),
            _randn(rng, (3, 3, 32, 16), 0.05, dev).requires_grad_()]
    g = _randn(rng, (2, 16, 16, 16), 1.0, dev)
    before = convt_fused.convt_in_bwd_cuda.launches
    got = torch.autograd.grad(convt_fused.fused_convt_in(*args), args, g)
    want = torch.autograd.grad(convt_fused.convt_in_plain(*args), args, g)
    assert convt_fused.convt_in_bwd_cuda.launches == before + 1
    for a, b in zip(got, want):
        assert torch.max(torch.abs(a - b)).item() < 1e-3 * torch.max(torch.abs(b)).item()


def test_head_and_convt_refuse_what_they_cannot_run(dev):
    with pytest.raises(ValueError, match="Co <= 8"):
        conv_head.conv_head_cuda(torch.zeros((1, 8, 8, 4), device=dev),
                                 torch.zeros((7, 7, 4, 9), device=dev))
    with pytest.raises(ValueError, match=">= 4"):
        conv_head.conv_head_cuda(torch.zeros((1, 3, 8, 4), device=dev),
                                 torch.zeros((7, 7, 4, 3), device=dev))
    with pytest.raises(ValueError, match="multiples of 4"):
        convt_fused.fused_convt_in_cuda(torch.zeros((1, 8, 8, 6), device=dev),
                                        torch.zeros((3, 3, 6, 4), device=dev))
