"""``--init_type normal|xavier|kaiming|orthogonal`` against the JAX package's
initialisers (``nemar_tpu/models/networks.py:_make_init``).

The same seed draws other numbers in the two packages, so parity is of the
distributions. For each type and for a convolution, a transposed
convolution and the PatchGAN's five layers at ndf 64 (up to 2.1 M draws a
layer), the port's ``init_weights`` on a torch module and JAX's initialiser
at the same kernel shape are drawn, and:

  * their sample variances agree, and each equals the type's variance
    (normal init_gain^2; xavier 2 init_gain^2 / fan_avg, twice
    ``nn.init.xavier_normal_``'s; kaiming 2 / fan_in; orthogonal
    init_gain^2 / max(rows, cols)), within 6 standard errors of a variance
    estimate from N normal draws, sqrt(2 / N) (for two estimates sqrt(2)
    times that; the truncated normal's kurtosis is below the normal's, so
    the bound holds for it too); the fans come from the JAX layout (HWIO,
    flax's ConvTranspose (kh, kw, in, out)), where torch's own fan of a
    ``ConvTranspose2d`` weight swaps in and out;
  * xavier is truncated at 2 standard units of its pre-scaling normal:
    |w| <= 2 std / 0.87962566, and the largest |w| of 100 k draws or more
    comes within 2% of that bound (a normal would pass it);
  * orthogonal, viewed as (kh kw in, out): Q^T Q = init_gain^2 I, or
    Q Q^T where there are fewer rows than columns, within 1e-6 init_gain^2.

At the model: G and D take the type, R keeps normal(0.02) with zero heads
(the JAX ``define_stn`` takes no init type), biases stay zero.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from nemar_tpu.models import networks as jnetworks
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.options import TrainOptions

GAIN = 0.02
TYPES = ["normal", "xavier", "kaiming", "orthogonal"]
# (module kind, JAX kernel shape): a trunk conv, a decoder ConvTranspose,
# and D's layers at ndf 64
LAYERS = {
    "conv": [("conv", (3, 3, 256, 256))],
    "convt": [("convt", (3, 3, 256, 128))],
    "D": [("conv", (4, 4, 3, 64)), ("conv", (4, 4, 64, 128)), ("conv", (4, 4, 128, 256)),
          ("conv", (4, 4, 256, 512)), ("conv", (4, 4, 512, 1))],
}


def _module(kind, shape):
    kh, kw, ci, co = shape
    if kind == "conv":
        return nn.Conv2d(ci, co, (kh, kw))
    return nn.ConvTranspose2d(ci, co, (kh, kw), stride=2)


def _jax_layout(m):
    """m's weight in the JAX package's layout, as numpy."""
    w = m.weight.detach()
    if isinstance(m, nn.ConvTranspose2d):
        return w.flip(2, 3).permute(2, 3, 0, 1).numpy()
    return w.permute(2, 3, 1, 0).numpy()


def _variance(init_type, shape):
    receptive = shape[0] * shape[1]
    fan_in, fan_out = receptive * shape[2], receptive * shape[3]
    return {"normal": GAIN**2, "xavier": 2 * GAIN**2 / ((fan_in + fan_out) / 2),
            "kaiming": 2 / fan_in,
            "orthogonal": GAIN**2 / max(fan_in, shape[3])}[init_type]


@pytest.mark.parametrize("layers", list(LAYERS))
@pytest.mark.parametrize("init_type", TYPES)
def test_init_distributions_match_jax(init_type, layers):
    gen = torch.Generator().manual_seed(0)
    for i, (kind, shape) in enumerate(LAYERS[layers]):
        m = _module(kind, shape)
        networks.init_weights(m, GAIN, gen, init_type)
        assert not torch.any(m.bias)
        got = _jax_layout(m).astype(np.float64)
        assert got.shape == shape
        want = np.asarray(jnetworks._make_init(init_type, GAIN)(
            jax.random.key(i), shape, jnp.float32), np.float64)
        n, var = got.size, _variance(init_type, shape)
        se = math.sqrt(2.0 / n)
        v_port, v_jax = float(np.mean(got**2)), float(np.mean(want**2))
        assert abs(v_port / v_jax - 1) <= 6 * math.sqrt(2) * se, (shape, v_port, v_jax)
        assert abs(v_port / var - 1) <= 6 * se, (shape, v_port, var)
        if init_type == "xavier":
            bound = 2 * math.sqrt(var) / 0.87962566103423978
            for draw in (got, want):
                top = float(np.abs(draw).max())
                assert top <= bound * (1 + 1e-6), (shape, top, bound)
                if n >= 100_000:
                    assert top >= 0.98 * bound, (shape, top, bound)
        if init_type == "orthogonal":
            rows, cols = n // shape[-1], shape[-1]
            for draw in (got, want):
                q = draw.reshape(rows, cols)
                gram = q.T @ q if rows >= cols else q @ q.T
                err = float(np.abs(gram - GAIN**2 * np.eye(len(gram))).max())
                assert err <= 1e-6 * GAIN**2, (shape, err)


@pytest.mark.parametrize("init_type", ["xavier", "kaiming", "orthogonal"])
def test_model_takes_the_init_type_r_stays_normal(tmp_path, init_type):
    opt = TrainOptions().parse([
        "--model", "nemar", "--dataset_mode", "synthetic", "--name", "init", "--gpu_ids", "-1",
        "--checkpoints_dir", str(tmp_path), "--crop_size", "32", "--load_size", "32",
        "--ngf", "8", "--ndf", "8", "--stn_ngf", "8", "--stn_depth", "3",
        "--init_type", init_type])
    model = create_model(opt)
    heads = {id(h) for h in model.netR.heads()}
    for name, net in model.nets().items():
        for m in net.modules():
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            assert not torch.any(m.bias), (name, m)
            if name == "R":
                w = m.weight.detach()
                if id(m) in heads:
                    assert not torch.any(w)
                else:  # normal(0.02): no draw past 6 standard deviations
                    assert 0 < float(w.abs().max()) <= 6 * 0.02, m
                continue
            shape = _jax_layout(m).shape
            v = float(torch.mean(m.weight.detach().double() ** 2))
            bound = 6 * math.sqrt(2 / m.weight.numel())
            assert abs(v / _variance(init_type, shape) - 1) <= bound, (name, shape, v)
