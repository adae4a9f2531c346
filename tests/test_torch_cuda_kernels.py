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

from nemar_tpu_torch.ops import _build, conv_fused, conv_head, convt_fused, norm, norm_cuda
from nemar_tpu_torch.ops import warp, warp_cuda
from nemar_tpu_torch.ops.warp import identity_grid

pytestmark = pytest.mark.cuda

# (C, H, W, act) of every instance norm on the slice's path
IN_SHAPES = [
    (64, 256, 256, "relu"), (128, 128, 128, "relu"), (256, 64, 64, "relu"),  # G
    (32, 128, 128, "leaky_relu"), (64, 64, 64, "leaky_relu"),                 # STN
    (128, 32, 32, "leaky_relu"), (256, 16, 16, "leaky_relu"),
    (256, 8, 8, "leaky_relu"), (32, 256, 256, "leaky_relu"),
    (512, 31, 31, "leaky_relu"), (3, 20, 20, "none"),                          # D, ragged
    # ragged channel counts, and frames smaller than one pass of a block's rows
    (1, 20, 20, "relu"), (5, 9, 11, "leaky_relu"), (33, 8, 8, "relu"), (3, 8, 8, "leaky_relu"),
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
    """K-in against its plain version, 1e-5; stats too; the same bits from
    two identical calls."""
    rng = np.random.default_rng(c + h)
    x = torch.from_numpy(
        (rng.standard_normal((2, h, w, c)) * 2.0 + 0.5).astype(np.float32)).to(dev)
    before = norm_cuda.instance_norm_act_cuda.launches
    got = norm.instance_norm_act(x, act)
    ref = norm.instance_norm_act_plain(x, act)
    torch.cuda.synchronize()
    assert norm_cuda.instance_norm_act_cuda.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-5
    y1, s1 = norm_cuda.instance_norm_act_cuda(x, act)
    y2, s2 = norm_cuda.instance_norm_act_cuda(x, act)
    assert torch.equal(y1, got) and torch.equal(y1, y2) and torch.equal(s1, s2)
    assert torch.max(torch.abs(s1 - norm.instance_norm_stats(x))).item() < 1e-5


@pytest.mark.parametrize("c,h,w,act", IN_SHAPES)
def test_in_bwd_kernel_matches_plain(dev, c, h, w, act):
    """K-in-bwd through autograd against the plain backward, 1e-5 of the
    largest gradient; the forward's stats against the plain stats; the same
    bits from two identical calls."""
    rng = np.random.default_rng(c + h + 1)
    x = torch.from_numpy(
        (rng.standard_normal((2, h, w, c)) * 2.0 + 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dev)
    _, stats = norm_cuda.instance_norm_act_cuda(x, act)
    assert torch.max(torch.abs(stats - norm.instance_norm_stats(x))).item() < 1e-5
    before = norm_cuda.instance_norm_act_bwd_cuda.launches
    xg = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(norm.instance_norm_act(xg, act), xg, g)
    ref = norm.instance_norm_act_bwd_plain(x, g, stats, act)
    torch.cuda.synchronize()
    assert norm_cuda.instance_norm_act_bwd_cuda.launches == before + 1
    assert torch.max(torch.abs(got - ref)).item() < 1e-5 * torch.max(torch.abs(ref)).item()
    again = norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, act)
    assert torch.equal(again, got)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_in_kernels_large_offset(dev, act):
    """Mean 100, std 1: the pivot keeps the one-pass sums from cancelling.
    Held against the plain versions in float64 on the same input (the fp32
    plain version's own mean rounds by up to ~1e-5 there), forward 1e-5
    absolute, backward 1e-5 of the largest gradient."""
    rng = np.random.default_rng(100)
    x = torch.from_numpy((rng.standard_normal((2, 64, 64, 64)) + 100.0).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((2, 64, 64, 64)).astype(np.float32)).to(dev)
    y, stats = norm_cuda.instance_norm_act_cuda(x, act)
    ref = norm.instance_norm_act_plain(x.double(), act)
    assert torch.max(torch.abs(y.double() - ref)).item() < 1e-5
    dx = norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, act)
    dref = norm.instance_norm_act_bwd_plain(x.double(), g.double(), stats.double(), act)
    assert torch.max(torch.abs(dx.double() - dref)).item() < 1e-5 * dref.abs().max().item()


def test_in_kernels_unaligned_take_the_scalar_path(dev):
    """x 4 bytes off a 16-byte boundary, C % 4 == 0: the kernels take their
    one-channel-a-thread layout, and agree with the plain versions."""
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.standard_normal(2 * 16 * 16 * 64 + 1).astype(np.float32)).to(dev)
    x = flat[1:].view(2, 16, 16, 64)
    g = torch.from_numpy(rng.standard_normal((2, 16, 16, 64)).astype(np.float32)).to(dev)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y, stats = norm_cuda.instance_norm_act_cuda(x, "leaky_relu")
    assert torch.max(torch.abs(y - norm.instance_norm_act_plain(x, "leaky_relu"))).item() < 1e-5
    dx = norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, "leaky_relu")
    ref = norm.instance_norm_act_bwd_plain(x, g, stats, "leaky_relu")
    assert torch.max(torch.abs(dx - ref)).item() < 1e-5 * torch.max(torch.abs(ref)).item()


@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (8, 64, 64, 256), (2, 8, 8, 33)])
def test_in_kernels_one_launch_per_call(dev, shape):
    """One device launch a call, forward and backward, from profiler traces
    (chip_smoke.device_ms: every traced call must show it)."""
    import chip_smoke

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    _, stats = norm_cuda.instance_norm_act_cuda(x, "relu")
    for fn in (lambda: norm_cuda.instance_norm_act_cuda(x, "relu"),
               lambda: norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, "relu")):
        _, by_kernel = chip_smoke.device_ms(fn, 1, 10)
        assert [k for _, k, _ in by_kernel] == [1.0]


def test_in_kernels_refuse_what_they_cannot_run(dev):
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        norm_cuda.instance_norm_act_cuda(x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        norm_cuda.instance_norm_act_bwd_cuda(x, x, torch.zeros((1, 2, 4)))
    xc = torch.zeros((1, 4, 8, 8), device=dev).permute(0, 2, 3, 1)  # NCHW memory
    with pytest.raises(RuntimeError, match="NHWC-contiguous"):
        norm_cuda.instance_norm_act_cuda(xc)
    with pytest.raises(RuntimeError, match="NHWC-contiguous"):
        norm.instance_norm_act(xc)
    xd = x.to(dev)
    with pytest.raises(RuntimeError, match="NHWC-contiguous"):
        norm_cuda.instance_norm_act_bwd_cuda(xd, xc, torch.zeros((1, 2, 4), device=dev))
    with pytest.raises(RuntimeError, match="float32"):
        norm_cuda.instance_norm_act_cuda(xd.double())
    with pytest.raises(RuntimeError, match="stats"):
        norm_cuda.instance_norm_act_bwd_cuda(xd, xd, torch.zeros((1, 2, 3), device=dev))


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
                                   (3, 4, 16, 128), (1, 64, 64, 256), (8, 64, 64, 256),
                                   (2, 12, 12, 128), (2, 5, 7, 128), (1, 3, 50, 128)])
def test_block_bwd_kernel_matches_plain(dev, shape):
    """K-block-bwd against the written-out plain backward, 1e-3 of each
    output's largest value, at shapes whose edges and corners (H or W of 2)
    exercise the reflect-pad fold, and samples whose pixels end inside a
    64-pixel tile (144, 35, 150); fed the plain forward's saved values, so
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


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 8, 24, 128), (1, 12, 16, 256)])
def test_block_kernel_ragged_tiles(dev, shape):
    """Shapes whose samples end inside a 128-pixel tile (H*W of 64, 192, 192):
    out, y1, y2 within 1e-3, the IN means within 1e-4 and the rstds within
    1e-4 relative; bit for bit repeatable."""
    n, h, w, c = shape
    rng = np.random.default_rng(h * w)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    w1, w2 = (torch.from_numpy((0.05 * rng.standard_normal((3, 3, c, c))).astype(np.float32)).to(dev)
              for _ in range(2))
    got = conv_fused.fused_resblock_cuda(x, w1, w2)
    again = conv_fused.fused_resblock_cuda(x, w1, w2)
    ref = conv_fused.resblock_fwd_plain(x, w1, w2)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
    for a, r in zip(got[:3], ref[:3]):
        assert torch.max(torch.abs(a - r)).item() < 1e-3
    assert torch.max(torch.abs(got[3][:, 0::2] - ref[3][:, 0::2])).item() < 1e-4
    assert torch.max(torch.abs(got[3][:, 1::2] / ref[3][:, 1::2] - 1)).item() < 1e-4


@pytest.mark.parametrize("n", [1, 8])
def test_block_kernel_fp64_accuracy(dev, n):
    """K-block's 3xTF32 convolutions keep fp32-level accuracy: against the
    plain forward in float64 (the same inputs cast up), its largest relative
    error on out, y1 and y2 is at most 4x that of the fp32 plain version."""
    rng = np.random.default_rng(29 + n)
    shape = (n, 64, 64, 256)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    w1, w2 = (torch.from_numpy((0.02 * rng.standard_normal((3, 3, 256, 256))).astype(np.float32))
              .to(dev) for _ in range(2))
    got = conv_fused.fused_resblock_cuda(x, w1, w2)[:3]
    ref32 = conv_fused.resblock_fwd_plain(x, w1, w2)[:3]
    ref64 = conv_fused.resblock_fwd_plain(x.double(), w1.double(), w2.double())[:3]

    def rel(a, b):
        return max(float((p.double() - q).abs().max() / q.abs().max()) for p, q in zip(a, b))

    assert rel(got, ref64) <= 4 * rel(ref32, ref64)


def test_block_kernel_refuses_unsupported_shapes(dev):
    x = torch.zeros((1, 8, 8, 96), device=dev)
    w = torch.zeros((3, 3, 96, 96), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        conv_fused.fused_resblock_cuda(x, w, w)


def _autograd_vs_plain(fn, plain, args, g, tol):
    """fn's value and gradients against plain's at the same inputs."""
    args = [a.requires_grad_() for a in args]
    out = fn(*args)
    ref = plain(*args)
    got = torch.autograd.grad(out, args, g)
    want = torch.autograd.grad(ref, args, g)
    assert out.shape == ref.shape and out.is_contiguous()
    assert _rel_close(out.detach(), ref.detach(), tol)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_close(a, b, tol)


@pytest.mark.parametrize("shape", [(1, 16, 16, 64), (2, 12, 12, 256), (1, 5, 7, 192)])
def test_block_autograd_pads_channels_and_masks_tails(dev, shape):
    """The trunk at shapes off the kernels' tiles (--ngf 16's 64 channels, a
    48^2 crop's 144 positions, both): one launch each way, values and
    gradients within 1e-3 of the plain version's largest value."""
    n, h, w, c = shape
    rng = np.random.default_rng(h * c)
    args = [_randn(rng, shape, 1.0, dev), _randn(rng, (3, 3, c, c), 0.05, dev),
            _randn(rng, (3, 3, c, c), 0.05, dev)]
    g = _randn(rng, shape, 1.0, dev)
    before = conv_fused.fused_resblock_cuda.launches, conv_fused.resblock_bwd_cuda.launches
    _autograd_vs_plain(conv_fused.fused_resblock, conv_fused.resblock_plain, args, g, 1e-3)
    assert (conv_fused.fused_resblock_cuda.launches,
            conv_fused.resblock_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)


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


def _rel_close(a, r, tol):
    return torch.max(torch.abs(a - r)).item() <= tol * torch.max(torch.abs(r)).item()


@pytest.mark.parametrize("n", [1, 8])
def test_warp_bwd_kernel_matches_plain(dev, n):
    """K-warp-bwd, one operator from (img, grid, g) to (d img, d grid),
    against its written-out plain version at the slice's shape (d img for 3
    of 4 channels, exact zeros for the 4th), 1e-5 of the largest value, and
    bit for bit repeatable (the fixed-point scatter)."""
    rng = np.random.default_rng(n + 5)
    img = torch.from_numpy(rng.standard_normal((n, 256, 256, 4), dtype=np.float32)).to(dev)
    grid = smooth_grid(rng, n, 256, 256).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, 256, 256, 4), dtype=np.float32)).to(dev)
    before = warp_cuda.warp_grid_bwd.launches
    got = warp_cuda.warp_grid_bwd(img, grid, g, "zeros", False, 3)
    again = warp_cuda.warp_grid_bwd(img, grid, g, "zeros", False, 3)
    ref = warp._grid_sample_plain_bwd(img, grid, g, "zeros", False, 3)
    torch.cuda.synchronize()
    assert warp_cuda.warp_grid_bwd.launches == before + 2
    assert not torch.any(got[0][..., 3])
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert _rel_close(a, r, 1e-5)


def _bwd_case(kind, rng, align_corners):
    """(img, grid, grad_channels): a ragged random grid reaching off the
    frame, the identity grid (every edge pixel on the clip's tie), grid
    entries of exactly +-1 (the clip's and the reflection's ties), or a
    large random grid whose every output block reads from the whole image
    (K-warp-bwd's path for more candidate blocks than its lists hold)."""
    if kind == "far":
        img = rng.standard_normal((1, 64, 64, 4), dtype=np.float32)
        return img, rng.uniform(-1, 1, (1, 272, 256, 2)).astype(np.float32), 3
    if kind == "ragged":
        img = rng.standard_normal((2, 33, 47, 3), dtype=np.float32)
        grid = rng.uniform(-1.3, 1.3, (2, 21, 19, 2)).astype(np.float32)
        return img, grid, 2
    img = rng.standard_normal((2, 37, 29, 4), dtype=np.float32)
    if kind == "identity":
        grid = np.broadcast_to(identity_grid(37, 29, align_corners).numpy(), (2, 37, 29, 2))
        return img, np.ascontiguousarray(grid), 4
    pick = rng.integers(0, 3, (2, 37, 29, 2))
    grid = np.where(pick == 0, -1.0, np.where(pick == 1, 1.0, rng.uniform(-1, 1, pick.shape)))
    return img, grid.astype(np.float32), 0


@pytest.mark.parametrize("kind", ["ragged", "identity", "plus_minus_one", "far"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_warp_bwd_kernel_padding_modes_and_ties(dev, padding_mode, align_corners, kind):
    """K-warp-bwd against its plain version in every padding mode, at ties,
    ragged shapes and a far-reaching field, with grad_channels 2 of 3, all
    4, 3 of 4, or 0 (d grid alone): 1e-5 of the largest value, bit for bit
    repeatable."""
    rng = np.random.default_rng(23 + len(kind))
    img, grid, gc = _bwd_case(kind, rng, align_corners)
    img, grid = torch.from_numpy(img).to(dev), torch.from_numpy(grid).to(dev)
    g = torch.from_numpy(rng.standard_normal(grid.shape[:3] + img.shape[3:]).astype(np.float32)).to(dev)
    got = warp_cuda.warp_grid_bwd(img, grid, g, padding_mode, align_corners, gc)
    again = warp_cuda.warp_grid_bwd(img, grid, g, padding_mode, align_corners, gc)
    ref = warp._grid_sample_plain_bwd(img, grid, g, padding_mode, align_corners, gc)
    torch.cuda.synchronize()
    assert (got[0] is None) == (ref[0] is None) == (gc == 0)
    for a, b, r in zip(got, again, ref):
        if r is not None:
            assert torch.equal(a, b)
            assert _rel_close(a, r, 1e-5)


@pytest.mark.parametrize("kind", ["ragged", "identity"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_warp_bwd_kernel_non_finite_g(dev, padding_mode, kind):
    """A NaN, +inf and -inf in g (C = 3 and C = 4, the float4 path): d img
    and d grid hold the plain version's non-finite values at the same
    places, and agree with it elsewhere at 1e-5 of the largest finite value."""
    rng = np.random.default_rng(61 + len(kind))
    img, grid, gc = _bwd_case(kind, rng, False)
    g = rng.standard_normal(grid.shape[:3] + img.shape[3:]).astype(np.float32)
    g[0, 1, 2, 0], g[0, 3, 1, 1], g[1, 0, 0, 1], g[1, 6, 4, 0] = np.nan, np.inf, -np.inf, np.inf
    grid[1, 0, 0] = (-1.0, 0.25)  # the -inf pixel: two taps in frame at weight 0
    img, grid, g = (torch.from_numpy(a).to(dev) for a in (img, grid, g))
    got = warp_cuda.warp_grid_bwd(img, grid, g, padding_mode, False, gc)
    ref = warp._grid_sample_plain_bwd(img, grid, g, padding_mode, False, gc)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref[0]).all())
    for a, r in zip(got, ref):
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(a), test(r))
        finite = torch.isfinite(r)
        assert _rel_close(a[finite], r[finite], 1e-5)


def test_warp_bwd_op_refuses_what_it_cannot_run(dev):
    img = torch.zeros((1, 8, 8, 3), device=dev)
    grid = identity_grid(8, 8, device=dev)[None]
    g = torch.zeros((1, 8, 8, 3), device=dev)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        warp_cuda.warp_grid_bwd(img.cpu(), grid.cpu(), g.cpu())
    with pytest.raises(TypeError, match="float32"):
        warp_cuda.warp_grid_bwd(img, grid.double(), g)
    with pytest.raises(ValueError, match="not contiguous"):
        warp_cuda.warp_grid_bwd(img, grid.transpose(1, 2), g)
    with pytest.raises(ValueError, match="padding_mode"):
        warp_cuda.warp_grid_bwd(img, grid, g, "wrap")
    op = _build.op("warp_grid_bwd")
    with pytest.raises(RuntimeError, match="contiguous"):
        op(img, grid.transpose(1, 2), g, 0, False, 3)
    with pytest.raises(RuntimeError, match="float32"):
        op(img, grid.double(), g, 0, False, 3)
    with pytest.raises(RuntimeError, match="bad g"):
        op(img, grid, g[..., :2].contiguous(), 0, False, 3)
    with pytest.raises(RuntimeError, match="grad_channels"):
        op(img, grid, g, 0, False, 4)


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
    # every output written once, in a fixed order: bit for bit again, on either route
    assert torch.equal(got, conv_head.conv_head_cuda(x, wk))


@pytest.mark.parametrize("shape", [(2, 64, 64, 64, 3), (1, 256, 256, 64, 1), (2, 37, 70, 20, 8),
                                   (1, 5, 5, 12, 1), (2, 40, 70, 32, 2)])
def test_head_kernel_fp64_accuracy(dev, shape):
    """K-head keeps fp32-level accuracy (the wgmma route's 3xTF32 GEMM, the
    direct route's fp32 FMAs): against the plain version in float64 (the
    same inputs cast up), its largest relative error is at most 4x that of
    the fp32 plain version."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(41 + h)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    got = conv_head.conv_head_cuda(x, wk)
    ref32 = conv_head.conv_head_plain(x, wk)
    ref64 = conv_head.conv_head_plain(x.double(), wk.double())

    def rel(a):
        return float((a.double() - ref64).abs().max() / ref64.abs().max())

    assert rel(got) <= 4 * rel(ref32)


@pytest.mark.parametrize("shape,kernel", [((1, 256, 256, 64, 3), "head_fwd_wgmma_kernel"),
                                          ((8, 256, 256, 64, 3), "head_fwd_wgmma_kernel"),
                                          ((1, 40, 4, 64, 2), "head_fwd_wgmma_kernel"),
                                          ((2, 37, 70, 20, 8), "head_fwd_direct_kernel"),
                                          ((2, 4, 9, 8, 5), "head_fwd_direct_kernel")])
def test_head_kernel_one_launch_per_call(dev, shape, kernel):
    """K-head is one device launch a call, in every traced call
    (chip_smoke.device_ms), on the route head_fwd_plan picks."""
    import chip_smoke

    n, h, w, ci, co = shape
    rng = np.random.default_rng(43)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    _, by_kernel = chip_smoke.device_ms(lambda: conv_head.conv_head_cuda(x, wk), 1, 10)
    assert [(name.split("<")[0].split("::")[-1], k) for name, k, _ in by_kernel] == [(kernel, 1.0)]


def test_head_kernel_unaligned_x_takes_the_direct_route(dev):
    """An x view whose data is not 16-byte aligned, which the wgmma route's
    copies cannot read, takes the direct route, and agrees all the same."""
    import chip_smoke

    rng = np.random.default_rng(47)
    flat = _randn(rng, (2 * 32 * 48 * 64 + 1,), 1.0, dev)
    x = flat[1:].view(2, 32, 48, 64)
    wk = _randn(rng, (7, 7, 64, 3), 0.02, dev)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = conv_head.conv_head_cuda(x, wk)
    ref = conv_head.conv_head_plain(x, wk)
    assert torch.max(torch.abs(got - ref)).item() < 1e-4 * torch.max(torch.abs(ref)).item()
    _, by_kernel = chip_smoke.device_ms(lambda: conv_head.conv_head_cuda(x, wk), 1, 5)
    assert by_kernel[0][0].split("<")[0].split("::")[-1] == "head_fwd_direct_kernel"


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


@pytest.mark.parametrize("shape", [(2, 64, 64, 64, 3), (2, 37, 70, 20, 8), (1, 5, 5, 12, 1)])
def test_head_bwd_kernel_fp64_accuracy(dev, shape):
    """K-head-bwd's 3xTF32 GEMMs keep fp32-level accuracy: against the plain
    backward in float64 (the same inputs cast up), its largest relative
    error on dx and dW is at most 4x that of the fp32 plain version."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(31 + h)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    g = _randn(rng, (n, h, w, co), 1.0, dev)
    got = conv_head.conv_head_bwd_cuda(x, wk, g)
    ref32 = conv_head.conv_head_bwd_plain(x, wk, g)
    ref64 = conv_head.conv_head_bwd_plain(x.double(), wk.double(), g.double())

    def rel(a, b):
        return max(float((p.double() - q).abs().max() / q.abs().max()) for p, q in zip(a, b))

    assert rel(got, ref64) <= 4 * rel(ref32, ref64)


@pytest.mark.parametrize("shape", [(1, 256, 256, 64, 3), (2, 37, 70, 20, 8)])
def test_head_bwd_kernel_three_launches_per_call(dev, shape):
    """K-head-bwd is three device launches a call (dW partials, Dx, finish),
    in every traced call (chip_smoke.device_ms)."""
    import chip_smoke

    n, h, w, ci, co = shape
    rng = np.random.default_rng(37)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (7, 7, ci, co), 0.02, dev)
    g = _randn(rng, (n, h, w, co), 1.0, dev)
    _, by_kernel = chip_smoke.device_ms(lambda: conv_head.conv_head_bwd_cuda(x, wk, g), 3, 10)
    assert [k for _, k, _ in by_kernel] == [1.0, 1.0, 1.0]
    assert [name.split("<")[0].split("::")[-1] for name, _, _ in by_kernel] == [
        "head_wgrad_kernel", "head_dgrad_kernel", "head_bwd_finish_kernel"]


def test_head_bwd_refuses_what_it_cannot_run(dev):
    x = torch.zeros((1, 8, 8, 4))
    wk = torch.zeros((7, 7, 4, 3))
    g = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        conv_head.conv_head_bwd_cuda(x, wk, g)
    xd, wd = x.to(dev), wk.to(dev)
    gt = torch.zeros((1, 3, 8, 8), device=dev).permute(0, 2, 3, 1)  # NCHW memory
    with pytest.raises(ValueError, match="contiguous"):
        conv_head.conv_head_bwd_cuda(xd, wd, gt)
    with pytest.raises(ValueError, match="Co <= 8"):
        conv_head.conv_head_bwd_cuda(xd, torch.zeros((7, 7, 4, 9), device=dev),
                                     torch.zeros((1, 8, 8, 9), device=dev))


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


@pytest.mark.parametrize("shape", [(8, 64, 64, 256, 128), (8, 128, 128, 128, 64)],
                         ids=["stage1_b8", "stage2_b8"])
def test_convt_kernels_fp64_accuracy(dev, shape):
    """K-convt's and K-convt-bwd's 3xTF32 GEMMs keep fp32-level accuracy at
    the decoder's b8 shapes: against the plain versions in float64 (the same
    inputs and, backward, the same saved values cast up), their largest
    relative error is at most 4x that of the fp32 plain versions."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(41 + h)
    x = _randn(rng, (n, h, w, ci), 1.0, dev)
    wk = _randn(rng, (3, 3, ci, co), 0.02, dev)
    g = _randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev)

    def rel(a, b):
        return max(float((p.double() - q).abs().max() / q.abs().max()) for p, q in zip(a, b))

    got = convt_fused.fused_convt_in_cuda(x, wk)[:2]
    ref32 = convt_fused.convt_in_fwd_plain(x, wk)
    ref64 = convt_fused.convt_in_fwd_plain(x.double(), wk.double())[:2]
    assert rel(got, ref64) <= 4 * rel(ref32[:2], ref64)
    saved = ref32[1:]
    got = convt_fused.convt_in_bwd_cuda(x, wk, *saved, g)
    ref32 = convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved)
    ref64 = convt_fused.convt_in_bwd_plain(x.double(), wk.double(), g.double(),
                                           saved=tuple(t.double() for t in saved))
    assert rel(got, ref64) <= 4 * rel(ref32, ref64)


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


@pytest.mark.parametrize("co", [9, 17])
def test_head_autograd_chunks_output_channels(dev, co):
    """A head wider than 8 channels (--output_nc 9): one launch of K-head and
    of K-head-bwd a chunk of 8, within 1e-4 of the plain version."""
    rng = np.random.default_rng(co)
    args = [_randn(rng, (2, 20, 24, 32), 1.0, dev), _randn(rng, (7, 7, 32, co), 0.05, dev)]
    g = _randn(rng, (2, 20, 24, co), 1.0, dev)
    before = conv_head.conv_head_cuda.launches, conv_head.conv_head_bwd_cuda.launches
    _autograd_vs_plain(conv_head.conv_head, conv_head.conv_head_plain, args, g, 1e-4)
    chunks = len(conv_head.head_chunks(co))
    assert (conv_head.conv_head_cuda.launches,
            conv_head.conv_head_bwd_cuda.launches) == (before[0] + chunks, before[1] + chunks)


@pytest.mark.parametrize("shape", [(2, 8, 8, 12, 6), (1, 5, 7, 6, 3)])
def test_convt_autograd_pads_channels(dev, shape):
    """A decoder stage whose channels are not multiples of 4 (--ngf 6's 12 ->
    6): one launch each way, within 1e-4 of the plain version."""
    n, h, w, ci, co = shape
    rng = np.random.default_rng(ci + co)
    args = [_randn(rng, (n, h, w, ci), 1.0, dev), _randn(rng, (3, 3, ci, co), 0.1, dev)]
    g = _randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev)
    before = convt_fused.fused_convt_in_cuda.launches, convt_fused.convt_in_bwd_cuda.launches
    _autograd_vs_plain(convt_fused.fused_convt_in, convt_fused.convt_in_plain, args, g, 1e-4)
    assert (convt_fused.fused_convt_in_cuda.launches,
            convt_fused.convt_in_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)


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
