"""G at the shapes the JAX package runs that do not fill the kernels' tiles,
on the CPU.

On the card every trunk block, decoder stage and head of G launches its
kernel (K-block, K-convt, K-head) at any shape the JAX package runs. K-block
masks a sample's ragged last pixel tile itself (a 48^2 crop's 12^2 trunk);
around the launches, the wrappers zero-pad what the kernels' tiles need:
the trunk's channels to a multiple of 128 (``--ngf 16``: 64), a decoder
stage's channels to multiples of 4 (``--ngf 6``: 12 -> 6), and a head wider
than 8 channels takes one launch of K-head a chunk of 8 (``--output_nc 9``).
These tests hold

  * K-block's shape rule and ``head_chunks``;
  * at every shape G gives its three ops at ``--ngf 16``, a 48^2 crop,
    ``--output_nc 9``, ``--ngf 6`` and the default widths, the wrappers
    that feed the kernels (``block_fwd_padded`` / ``block_bwd_padded``,
    ``convt_fwd_padded`` / ``convt_bwd_padded``, ``head_fwd_chunked`` /
    ``head_bwd_chunked``) with each launch replaced by its kernel's plain
    version: every launch gets a shape its kernel takes, and the values and
    gradients equal the plain version's at the caller's shape (fp32, 1e-5
    of the largest value), and likewise at wider paddings and more chunks;
  * G at each such shape against the JAX package's G from the same
    parameters (1e-4, as ``tests/test_torch_networks.py``);
  * a CPU model at each such shape builds and takes a training step with
    finite losses. (On the CPU G runs the plain versions; the card's runs
    are ``chip_smoke.py``'s phase 8 and ``tests/test_torch_cuda_kernels.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.models import networks as jnet
from nemar_tpu_torch.models import create_model, networks as tnet
from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

# (ngf, crop, output_nc, stn_depth)
SHAPES = {
    "ngf16": (16, 64, 3, 3),
    "crop48": (64, 48, 3, 4),
    "output_nc9": (32, 64, 9, 3),
    "ngf6": (6, 64, 3, 3),
    "default": (64, 64, 3, 3),  # the default widths, at a CPU-sized crop
}


def test_predicates():
    assert conv_fused.block_kernel_supported((8, 64, 64, 256))
    assert conv_fused.block_kernel_supported((1, 12, 12, 256))   # 48^2: 144 positions
    assert conv_fused.block_kernel_supported((2, 5, 7, 128))     # less than one tile
    assert not conv_fused.block_kernel_supported((1, 16, 16, 64))  # padded by the wrapper
    assert not conv_fused.block_kernel_supported((1, 1, 16, 128))  # too short to reflect
    assert conv_head.head_chunks(3) == [(0, 3)]
    assert conv_head.head_chunks(8) == [(0, 8)]
    assert conv_head.head_chunks(9) == [(0, 8), (8, 9)]
    assert conv_head.head_chunks(17) == [(0, 8), (8, 16), (16, 17)]


@pytest.fixture
def plain_launches(monkeypatch):
    """Each kernel launch replaced by its plain version, which first checks
    that the kernel takes the shape it is given; returns the log of
    launches, (kernel, x's shape)."""
    log = []

    def block_fwd(x, w1, w2, eps=1e-5):
        c = x.shape[3]
        assert conv_fused.block_kernel_supported(x.shape)
        assert w1.shape == w2.shape == (3, 3, c, c)
        log.append(("K-block", tuple(x.shape)))
        return conv_fused.resblock_fwd_plain(x, w1, w2, eps)

    def block_bwd(x, w1, w2, y1, y2, stats, g):
        assert conv_fused.block_kernel_supported(x.shape) and g.shape == x.shape
        log.append(("K-block-bwd", tuple(x.shape)))
        return conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=(y1, y2, stats))

    def convt_fwd(x, w, eps=1e-5):
        assert x.shape[3] % 4 == 0 and w.shape[3] % 4 == 0 and w.shape[2] == x.shape[3]
        log.append(("K-convt", tuple(x.shape)))
        return convt_fused.convt_in_fwd_plain(x, w, eps)

    def convt_bwd(x, w, yhat, stats, g):
        assert x.shape[3] % 4 == 0 and g.shape[3] == w.shape[3] and w.shape[3] % 4 == 0
        log.append(("K-convt-bwd", tuple(x.shape)))
        return convt_fused.convt_in_bwd_plain(x, w, g, saved=(yhat, stats))

    def head_fwd(x, w):
        assert 1 <= w.shape[3] <= conv_head.MAX_CO
        log.append(("K-head", tuple(x.shape)))
        return conv_head.conv_head_plain(x, w)

    def head_bwd(x, w, g):
        assert 1 <= w.shape[3] <= conv_head.MAX_CO and g.shape[3] == w.shape[3]
        assert g.is_contiguous()
        log.append(("K-head-bwd", tuple(x.shape)))
        return conv_head.conv_head_bwd_plain(x, w, g)

    monkeypatch.setattr(conv_fused, "fused_resblock_cuda", block_fwd)
    monkeypatch.setattr(conv_fused, "resblock_bwd_cuda", block_bwd)
    monkeypatch.setattr(convt_fused, "fused_convt_in_cuda", convt_fwd)
    monkeypatch.setattr(convt_fused, "convt_in_bwd_cuda", convt_bwd)
    monkeypatch.setattr(conv_head, "conv_head_cuda", head_fwd)
    monkeypatch.setattr(conv_head, "conv_head_bwd_cuda", head_bwd)
    return log


def _tensor(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def _check_op(op, x, w, rng):
    """The wrapper's forward and backward (the launches replaced by the plain
    versions) against the plain version's autograd at x's shape."""
    if op == "block":
        out, saved = conv_fused.block_fwd_padded(x, w[0], w[1])
        g = _tensor(rng, out.shape)
        got = conv_fused.block_bwd_padded(*saved, g)
        args = [t.clone().requires_grad_(True) for t in (x, *w)]
        ref = conv_fused.resblock_plain(*args)
    elif op == "convt":
        out, saved = convt_fused.convt_fwd_padded(x, w)
        g = _tensor(rng, out.shape)
        got = convt_fused.convt_bwd_padded(*saved, g, x.shape[3])
        args = [t.clone().requires_grad_(True) for t in (x, w)]
        ref = convt_fused.convt_in_plain(*args)
    else:
        out = conv_head.head_fwd_chunked(x, w)
        g = _tensor(rng, out.shape)
        got = conv_head.head_bwd_chunked(x, w, g)
        args = [t.clone().requires_grad_(True) for t in (x, w)]
        ref = conv_head.conv_head_plain(*args)
    want = torch.autograd.grad(ref, args, g)
    assert out.shape == ref.shape and out.is_contiguous()
    _close(out, ref.detach())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)


@pytest.mark.parametrize("case", list(SHAPES))
def test_routes_at_the_jax_packages_shapes(plain_launches, case):
    """Every op of G at the case's shapes, on its kernel's wrappers: one
    launch of K-block and K-convt a call, one of K-head a chunk of 8."""
    ngf, crop, onc, _ = SHAPES[case]
    rng = np.random.default_rng(7)
    t = crop // 4
    x = _tensor(rng, (1, t, t, 4 * ngf))
    _check_op("block", x, [_tensor(rng, (3, 3, 4 * ngf, 4 * ngf), 0.1) for _ in range(2)], rng)
    for i, c in enumerate((4 * ngf, 2 * ngf)):
        _check_op("convt", _tensor(rng, (1, t << i, t << i, c)),
                  _tensor(rng, (3, 3, c, c // 2), 0.1), rng)
    _check_op("head", _tensor(rng, (1, crop, crop, ngf)), _tensor(rng, (7, 7, ngf, onc), 0.05), rng)
    chunks = len(conv_head.head_chunks(onc))
    kernels = [k for k, _ in plain_launches]
    assert kernels == ["K-block", "K-block-bwd"] + ["K-convt", "K-convt-bwd"] * 2 \
        + ["K-head"] * chunks + ["K-head-bwd"] * chunks


@pytest.mark.parametrize("op", ["block", "convt", "head"])
def test_kernel_feed_at_wider_paddings(plain_launches, op):
    """Paddings and chunks past the model's: a 192-channel trunk (to 256),
    a 6 -> 3 decoder stage (both sides padded), a 17-channel head (3
    chunks)."""
    rng = np.random.default_rng(11)
    if op == "block":
        _check_op(op, _tensor(rng, (2, 5, 7, 192)),
                  [_tensor(rng, (3, 3, 192, 192), 0.05) for _ in range(2)], rng)
        assert plain_launches == [("K-block", (2, 5, 7, 256)), ("K-block-bwd", (2, 5, 7, 256))]
    elif op == "convt":
        _check_op(op, _tensor(rng, (2, 6, 7, 6)), _tensor(rng, (3, 3, 6, 3), 0.1), rng)
        assert plain_launches == [("K-convt", (2, 6, 7, 8)), ("K-convt-bwd", (2, 6, 7, 8))]
    else:
        _check_op(op, _tensor(rng, (2, 9, 11, 8)), _tensor(rng, (7, 7, 8, 17), 0.05), rng)
        assert [k for k, _ in plain_launches] == ["K-head"] * 3 + ["K-head-bwd"] * 3


def _numpy_params(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(leaf), jax.device_get(variables))


@pytest.mark.parametrize("case", ["ngf16", "crop48", "output_nc9", "ngf6"])
def test_generator_off_the_kernels_matches_jax(case):
    ngf, crop, onc, _ = SHAPES[case]
    x = (np.random.default_rng(2).standard_normal((1, crop, crop, 1)) * 0.5).astype(np.float32)
    g = jnet.define_G(1, onc, ngf, "resnet_6blocks")
    params = _numpy_params(g.init(jax.random.key(3), jnp.zeros((1, crop, crop, 1))), 4)
    ref = np.asarray(g.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    tg = tnet.define_G(1, onc, ngf, "resnet_6blocks")
    tg.load_state_dict(flax_to_torch(params, tg))
    tg = tg.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, crop, crop, onc)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["ngf16", "crop48", "output_nc9", "ngf6"])
def test_model_off_the_kernels_takes_a_step(tmp_path, case):
    ngf, crop, onc, depth = SHAPES[case]
    opt = TrainOptions().parse([
        "--model", "nemar", "--dataset_mode", "synthetic", "--name", case, "--gpu_ids", "-1",
        "--checkpoints_dir", str(tmp_path), "--crop_size", str(crop), "--load_size", str(crop),
        "--ngf", str(ngf), "--ndf", "8", "--output_nc", str(onc), "--stn_ngf", "8",
        "--stn_depth", str(depth), "--batch_size", "1"])
    model = create_model(opt)
    model.setup(opt)
    rng = np.random.default_rng(5)
    model.set_input({"A": rng.uniform(-1, 1, (1, crop, crop, 1)).astype(np.float32),
                     "B": rng.uniform(-1, 1, (1, crop, crop, onc)).astype(np.float32)})
    g0 = [p.detach().clone() for p in model.netG.parameters()]
    model.optimize_parameters()
    losses = model.get_current_losses()
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert any(not torch.equal(p, q) for p, q in zip(model.netG.parameters(), g0))
