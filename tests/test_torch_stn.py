"""The port's UNet STN against the JAX package's, from the same weights.

Depth 3, stn_ngf 8, 32^2. The flow head is drawn non-zero (a fresh head
is zero and would warp by the identity, sampling only at pixel centres), so
the field is a few pixels and fractional. Flow, warped images and the
smoothness term are compared. Tolerance 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.models.stn.unet_stn import UnetSTN as JaxUnetSTN
from nemar_tpu_torch.models.stn import UnetSTN, define_stn
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)


def _params(stn, seed):
    a0, b0 = jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 3))
    variables = jax.device_get(stn.init(jax.random.key(seed), a0, b0, ()))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    for name, leaf in tree["params"].items():
        leaf["bias"] = (0.05 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    head = tree["params"][f"Conv_{len(tree['params']) - 1}"]
    head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    return tree


@pytest.mark.parametrize("padding_mode,bounded", [("zeros", 0.0), ("border", 1.0)])
def test_unet_stn_matches_jax(padding_mode, bounded):
    kw = dict(ngf=8, depth=3, padding_mode=padding_mode, bounded_flow=bounded)
    jstn = JaxUnetSTN(in_channels=4, warp_impl="xla", **kw)
    tree = _params(jstn, 1)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    b = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    fake = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    (jw_fake, jw_a), jreg, jaux = jstn.apply(jt, jnp.asarray(a), jnp.asarray(b),
                                             (jnp.asarray(fake), jnp.asarray(a)), n_grad_imgs=1)

    tstn = UnetSTN(in_channels=4, **kw)
    tstn.load_state_dict(flax_to_torch(tree, tstn))
    tstn = tstn.to(memory_format=torch.channels_last)

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2)

    with torch.no_grad():
        (tw_fake, tw_a), treg, taux = tstn(nchw(a), nchw(b), (nchw(fake), nchw(a)), n_grad_imgs=1)
    flow = np.asarray(jaux["flow"])
    # the field really is a few pixels (1 px = 2/32 normalised) and fractional
    assert 0.5 < np.abs(flow).max() * 16 < 8.0
    np.testing.assert_allclose(taux["flow"].numpy(), flow, atol=1e-4, rtol=0)
    np.testing.assert_allclose(taux["grid"].numpy(), np.asarray(jaux["grid"]), atol=1e-4, rtol=0)
    for got, ref in ((tw_fake, jw_fake), (tw_a, jw_a)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(treg), float(jreg), atol=1e-4, rtol=0)


def test_fresh_stn_warps_by_identity():
    stn = UnetSTN(in_channels=4, ngf=8, depth=3)
    a, b = torch.randn(1, 1, 32, 32), torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        (wa,), _, aux = stn(a, b, (a,))
    assert float(aux["flow"].abs().max()) == 0.0
    torch.testing.assert_close(wa, a, atol=1e-6, rtol=0)


class _Opt:
    input_nc, output_nc, crop_size, stn_ngf, stn_depth = 1, 3, 32, 8, 3


@pytest.mark.parametrize("kind,flags", [("affine", {}), ("unet", {"stn_multiscale": True}),
                                        ("nope", {})])
def test_unported_stn_options_raise(kind, flags):
    """The two options that were refused until they were ported (the affine
    STN, the multiscale UNet) now build, and start at the identity warp;
    an unknown STN type still raises."""
    opt = _Opt()
    opt.__dict__.update(flags)
    if kind == "nope":
        with pytest.raises(NotImplementedError, match="nope"):
            define_stn(opt, kind)
        return
    stn = define_stn(opt, kind)
    assert type(stn).__name__ == {"affine": "AffineSTN", "unet": "UnetSTN"}[kind]
    heads = stn.heads()
    assert len(heads) == (1 if kind == "affine" else 3)  # depth 3: levels 2, 1 and 0
    a, b = torch.randn(1, 1, 32, 32), torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        (wa,), reg, aux = stn(a, b, (a,))
    assert float(aux["flow"].abs().max()) == 0.0 and float(reg) == 0.0
    torch.testing.assert_close(wa, a, atol=1e-6, rtol=0)
