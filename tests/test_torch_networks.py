"""The port's G and D against the JAX package's, from the same weights.

Weights go through ``nemar_tpu_torch.utils.convert.flax_to_torch``; every
bias is drawn non-zero so the conversion of each one is exercised. On the
CPU the port's trunk blocks and instance norms take their plain versions.
Tolerance 1e-4 (fp32, six fused blocks plus the encoder/decoder convs).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.models import networks as jnet
from nemar_tpu_torch.models import networks as tnet
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)


def _numpy_params(variables, seed, bias_scale=0.1):
    """flax variables -> nested numpy dicts, with random non-zero biases."""
    rng = np.random.default_rng(seed)

    def conv(path, leaf):
        arr = np.asarray(leaf)
        if path[-1].key == "bias":
            arr = (bias_scale * rng.standard_normal(arr.shape)).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(conv, jax.device_get(variables))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_conv_transpose_recipe_matches_flax():
    """flax ConvTranspose(k3, s2, 'SAME') == flipped kernel, padding=0,
    cropped to [:2H, :2W]; the padding=1/output_padding=1 recipe is off."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 5, 5, 4)).astype(np.float32)
    layer = fnn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME")
    params = _numpy_params(layer.init(jax.random.key(0), jnp.asarray(x)), 1)
    ref = np.asarray(layer.apply(_to_jax(params), jnp.asarray(x)))
    kernel = params["params"]["kernel"]
    bias = torch.from_numpy(params["params"]["bias"])
    w = torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    good = torch.nn.functional.conv_transpose2d(xt, w, bias, stride=2, padding=0)[:, :, :10, :10]
    np.testing.assert_allclose(good.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)
    bad = torch.nn.functional.conv_transpose2d(xt, w, bias, stride=2, padding=1, output_padding=1)
    assert bad.shape == good.shape
    assert np.abs(bad.permute(0, 2, 3, 1).numpy() - ref).max() > 0.1
    # the converter applies the same recipe to a ConvTranspose_<k> module
    holder = torch.nn.Module()
    holder.ConvTranspose_0 = torch.nn.ConvTranspose2d(4, 3, 3, stride=2)
    holder.load_state_dict(flax_to_torch({"ConvTranspose_0": params["params"]}, holder))
    with torch.no_grad():
        got = holder.ConvTranspose_0(xt)[:, :, :10, :10]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("block_impl", ["pallas", "xla"])
def test_resnet_generator_matches_jax(block_impl):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 32, 32, 1)) * 0.5).astype(np.float32)
    g = jnet.define_G(1, 3, 32, "resnet_6blocks", block_impl=block_impl)
    params = _numpy_params(g.init(jax.random.key(3), jnp.zeros((1, 32, 32, 1))), 4)
    ref = np.asarray(g.apply(_to_jax(params), jnp.asarray(x)))
    tg = tnet.define_G(1, 3, 32, "resnet_6blocks")
    tg.load_state_dict(flax_to_torch(params, tg))
    tg = tg.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_nlayer_discriminator_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    d = jnet.define_D(3, 8, "basic")
    params = _numpy_params(d.init(jax.random.key(6), jnp.zeros((1, 32, 32, 3))), 7)
    ref = np.asarray(d.apply(_to_jax(params), jnp.asarray(x)))
    td = tnet.define_D(3, 8, "basic")
    td.load_state_dict(flax_to_torch(params, td))
    with torch.no_grad():
        got = td(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_converter_refuses_leftover_and_missing_keys():
    td = tnet.define_D(3, 8, "basic")
    params = _numpy_params(jnet.define_D(3, 8, "basic").init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))), 0)
    extra = {"params": dict(params["params"], Dense_0={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError, match="no counterpart"):
        flax_to_torch(extra, td)
    fewer = {"params": {k: v for k, v in params["params"].items() if k != "Conv_4"}}
    with pytest.raises(KeyError, match="lacks"):
        flax_to_torch(fewer, td)


@pytest.mark.parametrize("netG", ["unet_256", "nope"])
def test_unported_generators_raise(netG):
    """An unknown name raises, naming it; ``unet_256`` did until A9 ported
    it, and now builds."""
    if netG == "unet_256":
        assert type(tnet.define_G(1, 3, 8, netG)).__name__ == "UnetGenerator"
        return
    with pytest.raises(NotImplementedError, match=netG):
        tnet.define_G(1, 3, 8, netG)
