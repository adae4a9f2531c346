"""Registration-convergence gates of the port: the counterparts of the JAX
package's ``tests/test_registration_gate.py``, on the CPU.

The port's ``UnetSTN`` (single head and multiscale) and ``AffineSTN``, the
plain warp and ``torch.optim.Adam(1e-3, betas=(0.9, 0.999))`` fit a KNOWN
affine misalignment by direct photometric fit, with the JAX tests' data
recipe (``_octave_scene`` content, A built by warping B under ``border``),
step counts and thresholds: the UNet to EPE < 1 px and a direction cosine
> 0.9 in 400 steps, the affine STN on fresh per-step draws to a held-out
EPE < 1 px and below half the identity's in 300 steps. R starts from the
weights the port's NeMAR model gives it (``networks.init_weights`` at
N(0, 0.02) from a seeded ``torch.Generator``, the heads zero).

The fits run in float64. The affine fit's end point in fp32 depends on the
order of the CPU's sums: 0.965, 1.138 and 0.946 px held-out EPE with 1, 2
and 4 threads (0.795 in float64; the JAX test's fp32 fit 0.767-0.877 px
from its init at keys 0-3), so an fp32 gate at 1 px would test the thread
count. The port's fp32 gradients are not the cause: 60 steps into the fit
they lie within 7.5e-7 of float64's, JAX's fp32 ones within 1.5e-6 (the
conv biases ahead of instance norm aside: their gradients are roundoff in
both).

The parity case starts both packages from the same weights (the JAX
module's init, carried over by ``flax_to_torch``) on the same inputs, and
holds the first 5 Adam steps of the single-head and the affine fit in
fp32: the losses within 1e-5 relative, the last flow within 1e-4 of the
largest ground-truth displacement (measured: 2.7e-6 and 1.7e-5 single
head, 1.1e-6 and 1.9e-6 affine). From the zero heads every TV difference,
and the L1 at the frame's corners (where A equals B), sits on ``|x|``'s
kink at 0: ``jnp.abs`` has gradient +1 there and ``torch.abs`` 0, and
before the port's TV took JAX's convention the losses parted by 1.6e-4
relative at step 2 (8.6e-3 at step 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_registration_gate import _octave_scene
from nemar_tpu.models.stn.affine_stn import AffineSTN as JaxAffineSTN
from nemar_tpu.models.stn.unet_stn import UnetSTN as JaxUnetSTN
from nemar_tpu_torch.models import networks
from nemar_tpu_torch.models.stn import AffineSTN, UnetSTN
from nemar_tpu_torch.ops.warp import grid_sample, identity_grid
from nemar_tpu_torch.utils import metrics as M
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

RES = 32
PARITY_STEPS = 5
PARITY_LOSS_RTOL = 1e-5
PARITY_FLOW_TOL = 1e-4


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _warp_border(b_img: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """A such that warping A by the ground-truth field reproduces B: B
    sampled at identity - gt under ``border`` (NHWC numpy in and out)."""
    grid = identity_grid(RES, RES, False, torch.float32)[None] - torch.from_numpy(gts)
    return grid_sample(torch.from_numpy(b_img), grid, padding_mode="border").numpy()


def _port_init(stn):
    """R's weights as the port's NeMAR model draws them, in float64."""
    networks.init_weights(stn, 0.02, torch.Generator().manual_seed(0))
    for head in stn.heads():
        torch.nn.init.zeros_(head.weight)
        torch.nn.init.zeros_(head.bias)
    return stn.double()


def _unet_task():
    rng = np.random.default_rng(0)
    b_img = np.stack([_octave_scene(rng, RES)[:, :, None] * 2 - 1 for _ in range(4)])
    theta = np.asarray([[1, 0, 3.0], [0, 1, -1.5]], np.float32)
    gt = M.registration_gt_flow(theta, RES, RES)
    a_img = _warp_border(b_img, np.tile(gt[None], (4, 1, 1, 1)))
    return a_img.astype(np.float32), b_img.astype(np.float32), gt


def _l1(x: torch.Tensor) -> torch.Tensor:
    """mean |x| with gradient +1 at 0, as the JAX tests' ``jnp.abs``: A is B
    warped under ``border``, so some pixels of A equal B's exactly (in the
    frame's corners) and the fit starts on that tie; torch.abs gives them
    no gradient."""
    return torch.where(x >= 0, x, -x).mean()


def _unet_step(stn, opt, a, b):
    (wa,), reg, aux = stn(a, b, (a,))
    loss = _l1(wa - b) + 0.1 * reg
    opt.zero_grad()
    loss.backward()
    opt.step()
    return float(loss.detach()), aux["flow"].detach()


def _adam(stn):
    return torch.optim.Adam(stn.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


@pytest.mark.parametrize("multiscale", [False, True], ids=["single_head", "multiscale"])
def test_direct_photometric_fit_converges(multiscale):
    a_img, b_img, gt = _unet_task()
    stn = _port_init(UnetSTN(in_channels=2, ngf=8, depth=3, multiscale=multiscale,
                             level_scale=1.0))
    opt = _adam(stn)
    a, b = _nchw(a_img).double(), _nchw(b_img).double()
    epe0 = M.epe_px(np.zeros_like(gt), gt, RES, RES)
    for _ in range(400):
        _, flow = _unet_step(stn, opt, a, b)
    flow = flow.numpy()
    epe = float(np.mean([M.epe_px(flow[j], gt, RES, RES) for j in range(4)]))
    print(f"EPE {epe:.4f} px (identity {epe0:.4f} px)")
    assert epe < 1.0, f"EPE {epe:.2f}px (identity {epe0:.2f}px)"
    pv = flow.mean((0, 1, 2))
    gv = gt.mean((0, 1))
    cos = float(pv @ gv / (np.linalg.norm(pv) * np.linalg.norm(gv) + 1e-12))
    print(f"cos {cos:.4f}")
    assert cos > 0.9, f"flow direction cos {cos:.2f}"


def _affine_scenes():
    rng = np.random.default_rng(0)
    return np.stack([_octave_scene(rng, RES)[:, :, None] * 2 - 1 for _ in range(16)])


def _affine_pair(scenes, r, nb=8):
    """The JAX test's ``make_pair``: nb scenes, random shifts of up to 3 px
    and shears of up to 0.05, A warped from B under ``border``."""
    idx = r.integers(0, len(scenes), nb)
    b_img = scenes[idx].astype(np.float32)
    th = np.tile(np.asarray([[1, 0, 0], [0, 1, 0]], np.float32), (nb, 1, 1))
    th[:, :, 2] = r.uniform(-3.0, 3.0, (nb, 2)).astype(np.float32)
    th[:, 0, 1] = r.uniform(-0.05, 0.05, nb)
    th[:, 1, 0] = r.uniform(-0.05, 0.05, nb)
    gts = np.stack([M.registration_gt_flow(t, RES, RES) for t in th])
    return _warp_border(b_img, gts), b_img, gts


def _affine_step(stn, opt, a, b):
    (wa,), reg, aux = stn(a, b, (a,))
    loss = _l1(wa - b) + 0.01 * reg
    opt.zero_grad()
    loss.backward()
    opt.step()
    return float(loss.detach()), aux["flow"].detach()


def test_affine_direct_fit_converges():
    scenes = _affine_scenes()
    stn = _port_init(AffineSTN(in_channels=2, ngf=8, n_downs=3, size=RES))
    opt = _adam(stn)
    train_rng = np.random.default_rng(2)
    for _ in range(300):
        a, b, _ = _affine_pair(scenes, train_rng)
        _affine_step(stn, opt, _nchw(a).double(), _nchw(b).double())
    a, b, gts = _affine_pair(scenes, np.random.default_rng(99))
    a, b = _nchw(a).double(), _nchw(b).double()
    with torch.no_grad():
        _, _, aux = stn(a, b, (a,))
    flow = aux["flow"].numpy()
    epe = float(np.mean([M.epe_px(flow[j], gts[j], RES, RES) for j in range(len(gts))]))
    epe0 = float(np.mean([M.epe_px(np.zeros_like(g), g, RES, RES) for g in gts]))
    print(f"held-out EPE {epe:.4f} px (identity {epe0:.4f} px)")
    assert epe < 1.0, f"held-out EPE {epe:.2f}px (identity {epe0:.2f}px)"
    assert epe < epe0 / 2, f"EPE {epe:.2f} not < identity/2 ({epe0:.2f})"


def _jax_fit(jstn, a_seq, b_seq, reg_w):
    """The JAX test's step (optax adam(1e-3, b1=0.9)) from the module's
    init at key 0, over the given inputs: (init params, losses, last flow)."""
    params = jax.device_get(jstn.init(jax.random.key(0), jnp.asarray(a_seq[0]),
                                      jnp.asarray(b_seq[0]), (jnp.asarray(a_seq[0]),)))
    tx = optax.adam(1e-3, b1=0.9)

    def loss_fn(p, a, b):
        (wa,), reg, aux = jstn.apply(p, a, b, (a,))
        return jnp.mean(jnp.abs(wa - b)) + reg_w * reg, aux

    @jax.jit
    def step(p, o, a, b):
        (l, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, a, b)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, l, aux["flow"]

    p, opt_state, losses = params, tx.init(params), []
    for a, b in zip(a_seq, b_seq):
        p, opt_state, loss, flow = step(p, opt_state, jnp.asarray(a), jnp.asarray(b))
        losses.append(float(loss))
    return params, losses, np.asarray(flow)


@pytest.mark.parametrize("arm", ["single_head", "affine"])
def test_first_adam_steps_match_jax(arm):
    if arm == "single_head":
        a_img, b_img, gt = _unet_task()
        a_seq, b_seq = [a_img] * PARITY_STEPS, [b_img] * PARITY_STEPS
        jstn, tstn = (JaxUnetSTN(in_channels=2, ngf=8, depth=3, level_scale=1.0),
                      UnetSTN(in_channels=2, ngf=8, depth=3, level_scale=1.0))
        reg_w, step, scale = 0.1, _unet_step, np.abs(gt).max()
    else:
        scenes, r = _affine_scenes(), np.random.default_rng(2)
        pairs = [_affine_pair(scenes, r) for _ in range(PARITY_STEPS)]
        a_seq, b_seq = [p[0] for p in pairs], [p[1] for p in pairs]
        jstn, tstn = (JaxAffineSTN(in_channels=2, ngf=8, n_downs=3),
                      AffineSTN(in_channels=2, ngf=8, n_downs=3, size=RES))
        reg_w, step, scale = 0.01, _affine_step, np.abs(pairs[-1][2]).max()
    params, jlosses, jflow = _jax_fit(jstn, a_seq, b_seq, reg_w)
    tstn.load_state_dict(flax_to_torch(params, tstn))
    opt = _adam(tstn)
    losses = []
    for a, b in zip(a_seq, b_seq):
        loss, flow = step(tstn, opt, _nchw(a), _nchw(b))
        losses.append(loss)
    np.testing.assert_allclose(losses, jlosses, rtol=PARITY_LOSS_RTOL, atol=0)
    assert np.abs(jflow).max() > 10 * PARITY_FLOW_TOL * scale  # the heads have moved
    np.testing.assert_allclose(flow.numpy(), jflow, atol=PARITY_FLOW_TOL * scale, rtol=0)
