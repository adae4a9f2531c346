"""The port's networks of the template models (ROADMAP.md A9) against the
JAX package's, from the same weights (``flax_to_torch``, every bias drawn
non-zero): ``UnetGenerator``, ``PixelDiscriminator``, the ResNet
generator and the PatchGAN under ``--norm batch`` and ``none`` (their
biases live), the flax ``ConvTranspose`` layouts, ``Dropout`` and
``--remat``.

Forward and VJP run in float64 in both packages (JAX with 64-bit types,
``test_torch_nemar_pallas_all.jax_float64``; the port's CPU path is
dtype-generic), in eval mode (the JAX package's ``train=False``): the
output and the input's gradient within 1e-9 of their largest value, each
parameter's gradient within 1e-9 of the largest gradient element of its
net (a bias followed by a norm has a gradient of roundoff in both).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nemar_pallas_all as pa
from nemar_tpu.models import networks as jnet
from nemar_tpu_torch.models import networks as tnet
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

TOL64 = 1e-9


def _params(module, shape: tuple, seed: int):
    """module's variables for an input of ``shape`` as nested numpy dicts,
    drawn with numpy: kernels N(0, 0.1), biases N(0, 0.1) (the shapes from
    ``jax.eval_shape``, which compiles nothing)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros(shape), False))
    return jax.tree.map(lambda leaf: (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32),
                        shapes)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _hold_fwd_vjp(jmod, tmod, params, x, g):
    """jmod (flax, applied with train=False) and tmod (the port's, eval)
    from ``params``: output, d x and every parameter's gradient in float64
    for the cotangent g; returns the port's parameter gradients."""
    with pa.jax_float64():
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)

        @jax.jit
        def fwd_vjp(p, xx, gg):
            out, vjp = jax.vjp(lambda p_, x_: jmod.apply(p_, x_, False), p, xx)
            return (out, *vjp(gg))

        out, dparams, dx = jax.device_get(fwd_vjp(p64, jnp.asarray(x, jnp.float64),
                                                  jnp.asarray(g, jnp.float64)))
    assert out.dtype == np.float64
    tmod.load_state_dict(flax_to_torch(params, tmod, pa.F64))
    tmod.double().eval()
    xt = _nchw(x).double().requires_grad_()
    got = tmod(xt)
    got.backward(_nchw(g).double())
    assert np.max(np.abs(_nhwc(got) - out)) <= TOL64 * np.max(np.abs(out))
    assert np.max(np.abs(_nhwc(xt.grad) - dx)) <= TOL64 * np.max(np.abs(dx))
    ref = flax_to_torch(dparams, tmod, pa.F64)
    scale = max(float(v.abs().max()) for v in ref.values())
    grads = {}
    for key, p in tmod.named_parameters():
        grads[key] = p.grad
        err = float((grads[key] - ref[key]).abs().max())
        assert err <= TOL64 * scale, (key, err, scale)
    return grads, scale


@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
def test_unet_generator_matches_jax(norm):
    """num_downs 5 at 32^2 (down to 1^2), ngf 4, batch 2, with dropout
    layers (off in eval)."""
    rng = np.random.default_rng(0)
    jg = jnet.UnetGenerator(output_nc=3, num_downs=5, ngf=4, norm=norm, use_dropout=True)
    params = _params(jg, (1, 32, 32, 2), 2)
    assert set(params["params"]) == {f"{k}_{i}" for k in ("Conv", "ConvTranspose")
                                     for i in range(5)}
    tg = tnet.UnetGenerator(2, 3, 5, 4, norm, use_dropout=True)
    x = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    g = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    grads, scale = _hold_fwd_vjp(jg, tg, params, x, g)
    # the outermost transposed conv's bias feeds tanh directly: live
    assert float(grads["ConvTranspose_4.bias"].abs().max()) > 1e-6 * scale


def test_unet_refuses_sizes_that_do_not_divide():
    tg = tnet.define_G(3, 3, 4, "unet_128")
    with pytest.raises(ValueError, match="divisible by and >= 128"):
        tg(torch.zeros(1, 3, 64, 64))
    with pytest.raises(ValueError, match="divisible by and >= 256"):
        tnet.define_G(3, 3, 4, "unet_256")(torch.zeros(1, 3, 384, 128))


@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
def test_pixel_discriminator_matches_jax(norm):
    rng = np.random.default_rng(3)
    jd = jnet.define_D(6, 8, "pixel", norm=norm)
    params = _params(jd, (1, 8, 8, 6), 5)
    td = tnet.define_D(6, 8, "pixel", norm=norm)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    grads, scale = _hold_fwd_vjp(jd, td, params, x, g)
    assert float(grads["Conv_0.bias"].abs().max()) > 1e-6 * scale


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_resnet_generator_under_norm_matches_jax(norm):
    """The ResNet generator's plain blocks and decoder (no fused kernel)
    at 32^2, ngf 8; under 'none' every bias is live."""
    rng = np.random.default_rng(6)
    jg = jnet.define_G(1, 3, 8, "resnet_6blocks", norm=norm)
    params = _params(jg, (1, 32, 32, 1), 8)
    tg = tnet.define_G(1, 3, 8, "resnet_6blocks", norm)
    assert not any(getattr(tg, f"ResnetBlock_{i}").fused for i in range(6))
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    g = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    grads, scale = _hold_fwd_vjp(jg, tg, params, x, g)
    live = [k for k in grads if k.endswith(".bias")
            and float(grads[k].abs().max()) > 1e-6 * scale]
    if norm == "none":
        assert len(live) == len([k for k in grads if k.endswith(".bias")])
    else:  # only the head's bias escapes a norm
        assert live == ["Conv_3.bias"]


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_nlayer_discriminator_under_norm_matches_jax(norm):
    rng = np.random.default_rng(9)
    jd = jnet.define_D(3, 8, "basic", norm=norm)
    params = _params(jd, (1, 32, 32, 3), 11)
    td = tnet.define_D(3, 8, "basic", norm=norm)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    g = rng.standard_normal((2, 2, 2, 1)).astype(np.float32)
    _hold_fwd_vjp(jd, td, params, x, g)


@pytest.mark.parametrize("k", [3, 4])
def test_conv_transpose_layouts_match_flax(k):
    """flax ConvTranspose(k, s2, 'SAME') at 5^2 -> 10^2, kernel and bias
    carried by flax_to_torch: the 3x3 as the ResNet decoder runs it
    (padding 0, cropped), the 4x4 as the UNet's (padding 1), within 1e-6
    of the largest value (fp32)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 5, 5, 4)).astype(np.float32)
    layer = fnn.ConvTranspose(3, (k, k), strides=(2, 2), padding="SAME")
    params = {"params": {"kernel": rng.standard_normal((k, k, 4, 3)).astype(np.float32),
                         "bias": rng.standard_normal(3).astype(np.float32)}}
    ref = np.asarray(layer.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.ConvTranspose_0 = torch.nn.ConvTranspose2d(4, 3, k, stride=2, padding=k - 3)
    holder.load_state_dict(flax_to_torch({"ConvTranspose_0": params["params"]}, holder))
    with torch.no_grad():
        got = _nhwc(holder.ConvTranspose_0(_nchw(x))[:, :, :10, :10])
    assert got.shape == ref.shape == (1, 10, 10, 3)
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))


@pytest.mark.parametrize("netG,kind", [("resnet_9blocks", "ResnetGenerator"),
                                       ("resnet_6blocks", "ResnetGenerator"),
                                       ("unet_128", "UnetGenerator"),
                                       ("unet_256", "UnetGenerator")])
@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
def test_define_g_takes_every_name_and_norm(netG, kind, norm):
    net = tnet.define_G(3, 3, 4, netG, norm, use_dropout=True)
    assert type(net).__name__ == kind and net.norm == norm
    assert len(tnet.dropout_generators(net)) == (9 if netG == "resnet_9blocks" else
                                                 6 if netG == "resnet_6blocks" else 3)


@pytest.mark.parametrize("netD,kind", [("basic", "NLayerDiscriminator"),
                                       ("n_layers", "NLayerDiscriminator"),
                                       ("pixel", "PixelDiscriminator")])
@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
def test_define_d_takes_every_name_and_norm(netD, kind, norm):
    net = tnet.define_D(3, 4, netD, 2, norm)
    assert type(net).__name__ == kind and net.norm == norm


def test_unknown_norm_raises():
    with pytest.raises(NotImplementedError, match="group"):
        tnet.define_G(3, 3, 4, "unet_128", "group")
    with pytest.raises(NotImplementedError, match="group"):
        tnet.define_D(3, 4, "pixel", norm="group")


def test_dropout_draws_from_its_generator():
    """In training: about half the values kept (of 2^16), each scaled by 2,
    the mask the generator's draw (the same seed draws the same mask; the
    global generator neither used nor moved); no generator raises; in eval
    the identity."""
    x = torch.rand(4, 16, 32, 32) + 0.5
    drop = tnet.Dropout(0.5, torch.Generator().manual_seed(3))
    before = torch.random.get_rng_state()
    y = drop(x)
    assert torch.equal(torch.random.get_rng_state(), before)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], 2 * x[kept])
    again = tnet.Dropout(0.5, torch.Generator().manual_seed(3))(x)
    assert torch.equal(again, y)
    assert not torch.equal(drop(x), y)  # the generator moved on
    with pytest.raises(RuntimeError, match="generator"):
        tnet.Dropout(0.5)(x)
    drop.eval()
    assert drop(x) is x


@pytest.mark.parametrize("netG", ["resnet_6blocks", "unet_128"])
def test_remat_gradients_bit_equal(netG):
    """--remat (each ResNet trunk block checkpointed; the UNet takes none,
    as in JAX) gives the same output and bit-identical gradients, dropout
    included: the recomputation replays the block's mask."""
    size = 32 if netG.startswith("resnet") else 128
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(0))
    outs = []
    for use_remat in (False, True):
        torch.manual_seed(0)
        net = tnet.define_G(3, 3, 4, netG, "instance", True, use_remat,
                            torch.Generator().manual_seed(5))
        y = net(x)
        y.square().sum().backward()
        # the fused decoder leaves its inert biases out: no gradient
        outs.append((y.detach(), [p.grad for p in net.parameters() if p.grad is not None]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert len(outs[0][1]) == len(outs[1][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
