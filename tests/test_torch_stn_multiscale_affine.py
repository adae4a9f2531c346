"""The port's multiscale UNet STN and affine STN against the JAX package's.

From the same parameters (``flax_to_torch``; every bias and every flow head
redrawn non-zero, so each conversion and each head's gradient is
exercised), on the same inputs, in fp32 on the CPU:

  * ``resize_bilinear`` against ``jax.image.resize(..., 'bilinear')`` at
    each upward ratio the UNets below use and at 8^2 -> 256^2 (the
    science recipe's coarsest head), forward and VJP, within 1e-6 of the
    largest value (the VJP sums up to 36 cotangents a pixel at 8^2 -> 256^2,
    to values of ~20, in another order than jax's);
  * R's flow, grid, warped images and reg within 1e-5 absolute, and the
    gradients of one scalar of them with respect to R's
    parameters and to the inputs within ||dg|| / ||g|| <= 1e-4 a leaf. The
    biases of convolutions followed by instance norm have gradients that
    are zero up to roundoff in both packages: they are held to 1e-6 of the
    norm of their conv's weight gradient instead;
  * one training step with each STN against the JAX package's
    ``_train_step_impl``, from fresh Adam states, in float64 as
    ``tests/test_torch_nemar_pallas_all.py`` runs one (float32 steps are
    ill-conditioned at 1e-3 here; ``test_train_step_matches_jax`` says
    how), with its tolerances and stated exception.

The multiscale cases cover depth 3 and 4, ``head_min_res`` 0 and one that
skips the coarsest head, ``level_scale`` 0.25, ``bounded_flow`` 0 and 0.15,
``smooth_order`` 1 and 2, both ``align_corners``, and a field that points
past the frame, so the composition's border clip (and its tie convention,
``ops/warp.py``) is reached. The affine cases are at 64^2, where the last
feature map is 2 x 2 x 64: a flatten in another order than the
reference's NHWC fails them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nemar_pallas_all as pa
import test_torch_nemar_train as tt
from nemar_tpu.data.synthetic_dataset import SyntheticDataset
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.models.stn.affine_stn import AffineSTN as JaxAffineSTN
from nemar_tpu.models.stn.unet_stn import UnetSTN as JaxUnetSTN
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.models.stn import AffineSTN, UnetSTN, resize_bilinear
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("src,dst", [((4, 4), (32, 32)), ((8, 8), (32, 32)),
                                     ((16, 16), (32, 32)), ((8, 8), (256, 256)),
                                     ((6, 10), (24, 40))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, *src, 2)).astype(np.float32)
    ct = rng.standard_normal((2, *dst, 2)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: jax.image.resize(x, (2, *dst, 2), "bilinear"), jnp.asarray(f))
    (ref_grad,) = vjp(jnp.asarray(ct))
    ft = torch.from_numpy(f).requires_grad_(True)
    got = resize_bilinear(ft, *dst)
    got.backward(torch.from_numpy(ct))
    for t, want in ((got.detach(), ref), (ft.grad, ref_grad)):
        want = np.asarray(want)
        np.testing.assert_allclose(t.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


def _redraw(tree, rng, heads=(), head_bias=0.0):
    """numpy copy of a flax tree: every bias N(0, 0.05), and the zero-init
    heads' kernels N(0, 0.01) with biases head_bias + N(0, 0.05)."""
    def redraw(path, leaf):
        keys = [p.key for p in path]
        head = keys[1] in heads
        if keys[-1] == "bias":
            return (head * head_bias + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if head:
            return (0.01 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(tree))


def _smooth(rng, n, size, c):
    """Images of a few smooth waves in [-1, 1]: the warped values' roundoff
    then stays at fp32's level of the field's."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    out = np.zeros((n, size, size, c), np.float32)
    for i in range(n):
        for ch in range(c):
            fx, fy, ph = rng.uniform(0.5, 2.0, 3)
            out[i, :, :, ch] = np.sin(2 * np.pi * (fx * xx + fy * yy) + 6 * ph)
    return out


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _check_against_jax(jstn, tree, tstn, in_bias_keys, size, seed):
    """R's outputs, reg and gradients, the port's against JAX's, from the
    same parameters and inputs."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, size, size, 1)).astype(np.float32)
    b = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    fake = _smooth(rng, 2, size, 3)
    img_a = _smooth(rng, 2, size, 1)
    cots = (rng.standard_normal((2, size, size, 2)).astype(np.float32),
            rng.standard_normal((2, size, size, 3)).astype(np.float32),
            rng.standard_normal((2, size, size, 1)).astype(np.float32))

    def objective(flow, warped, reg, sum_):
        """One scalar of the flow, both warped images and the reg (NHWC)."""
        return (sum_(flow * cots[0]) + sum_(warped[0] * cots[1]) + sum_(warped[1] * cots[2])
                + 10.0 * reg)

    def run(params, a, b, fake):
        warped, reg, aux = jstn.apply(params, a, b, (fake, img_a), n_grad_imgs=1)
        return objective(aux["flow"], warped, reg, jnp.sum), (warped, reg, aux)

    (_, (jwarped, jreg, jaux)), jgrads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1, 2, 3), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(fake))

    tstn.load_state_dict(flax_to_torch(tree, tstn))
    tstn = tstn.to(memory_format=torch.channels_last)
    ta, tb, tf = (_nchw(x).requires_grad_(True) for x in (a, b, fake))
    twarped, treg, taux = tstn(ta, tb, (tf, _nchw(img_a)), n_grad_imgs=1)
    nhwc = [w.permute(0, 2, 3, 1) for w in twarped]
    cots = tuple(torch.from_numpy(c) for c in cots)
    objective(taux["flow"], nhwc, treg, torch.sum).backward()

    for k in set(jaux) & set(taux):
        np.testing.assert_allclose(taux[k].detach().numpy(), np.asarray(jaux[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    for got, ref in zip(nhwc, jwarped):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert abs(float(treg.detach()) - float(jreg)) <= 1e-5
    ref_grads = flax_to_torch(jgrads[0], tstn)
    for key, p in tstn.named_parameters():
        want, got = ref_grads[key], p.grad
        if key in in_bias_keys:
            scale = float(torch.linalg.vector_norm(ref_grads[key.replace(".bias", ".weight")]))
            assert max(float(want.abs().max()), float(got.abs().max())) <= 1e-6 * scale, key
            continue
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert rel <= 1e-4, (key, rel)
    for t, ref in zip((ta, tb, tf), jgrads[1:]):
        want = torch.from_numpy(np.array(ref))
        got = t.grad.permute(0, 2, 3, 1)
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert rel <= 1e-4, rel
    return taux


# (depth, head_min_res, bounded_flow, smooth_order, align_corners, head bias)
MULTISCALE = {
    "d3": (3, 0, 0.0, 1, False, 0.0),
    "d4_skip_coarsest": (4, 8, 0.15, 2, True, 0.3),
    "d4_bounded": (4, 0, 0.15, 1, False, 0.3),
    "d3_past_frame": (3, 0, 0.0, 2, False, 1.5),
}


@pytest.mark.parametrize("case", list(MULTISCALE))
def test_multiscale_unet_stn_matches_jax(case):
    depth, hmr, bounded, order, ac, head_bias = MULTISCALE[case]
    kw = dict(ngf=8, depth=depth, multiscale=True, level_scale=0.25, head_min_res=hmr,
              bounded_flow=bounded, smooth_order=order, align_corners=ac)
    jstn = JaxUnetSTN(in_channels=4, warp_impl="xla", **kw)
    z = (jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 3)))
    variables = jstn.init(jax.random.key(depth), *z, ())
    tstn = UnetSTN(in_channels=4, size=32, **kw)
    heads = [f"Conv_{k}" for k in tstn.head_index.values()]
    # the same heads, under the same names, as the flax tree's
    assert set(variables["params"]) == {f"Conv_{k}" for k in range(tstn.n_convs)}
    for name in heads:
        assert variables["params"][name]["kernel"].shape[-1] == 2
    # levels 3..1 at 32^2 are 4, 8, 16 a side: head_min_res 8 drops level 3
    assert len(heads) == depth - (hmr == 8)
    tree = _redraw(variables, np.random.default_rng(1), heads, head_bias)
    in_bias = {f"{n}.bias" for n in (f"Conv_{k}" for k in range(tstn.n_convs)) if n not in heads}
    aux = _check_against_jax(jstn, tree, tstn, in_bias, 32, seed=2)
    flow_px = float(aux["flow"].abs().max()) * 16
    assert flow_px > 0.5  # a field of pixels, not of roundoff
    if head_bias > 1:
        # some samples of the composition and of the warp fall past the frame
        assert float(aux["grid"].abs().max()) > 1.2


@pytest.mark.parametrize("head", ["flatten", "gap"])
def test_affine_stn_matches_jax(head):
    jstn = JaxAffineSTN(in_channels=4, ngf=8, warp_impl="xla", head=head)
    z = (jnp.zeros((1, 64, 64, 1)), jnp.zeros((1, 64, 64, 3)))
    variables = jstn.init(jax.random.key(0), *z, ())
    assert set(variables["params"]) == {*(f"Conv_{k}" for k in range(5)), "Dense_0", "Dense_1"}
    tree = _redraw(variables, np.random.default_rng(3), ("Dense_1",))
    tstn = AffineSTN(in_channels=4, ngf=8, head=head, size=64)
    if head == "flatten":  # the last map is 2 x 2 x 64
        assert tstn.Dense_0.in_features == 2 * 2 * 64
    aux = _check_against_jax(jstn, tree, tstn, {f"Conv_{k}.bias" for k in range(5)}, 64, seed=4)
    assert float(aux["dtheta"].abs().max()) > 1e-3


# --------------------------------------------------------------------------
# one training step with each STN against the JAX package's, in float64
# --------------------------------------------------------------------------

STEPS = {
    "multiscale": ["--stn_multiscale", "--stn_level_scale", "0.25", "--stn_smooth_order", "2"],
    # at 64^2 the affine STN's last map is 2 x 2 (at 32^2 it is one pixel,
    # whose instance norm is 0 in both packages: R would have no gradient)
    "affine": ["--stn_type", "affine", "--crop_size", "64", "--load_size", "64"],
}


def _in_bias_keys(model) -> dict:
    """Per net, the biases of convolutions followed by instance norm."""
    heads = [id(h) for h in model.netR.heads()]
    return {"G": pa._in_bias_keys(model.netG),
            "D": {f"Conv_{i}.bias" for i in range(1, model.netD.n_layers + 1)},
            "R": {f"{name}.bias" for name, m in model.netR.named_children()
                  if isinstance(m, torch.nn.Conv2d) and id(m) not in heads}}


@pytest.mark.parametrize("stn", list(STEPS))
def test_train_step_matches_jax(tmp_path, stn):
    """One step from fresh Adam states in float64, as
    ``test_torch_nemar_pallas_all.py`` holds one (it says why float64: two
    float32 runs of the step do not share every relu mask and L1 sign, and
    one flipped element moves every upstream gradient by ~1e-3; measured
    here in float32, G's gradients 1.5e-3 apart under the multiscale STN
    and 2e-2 under the affine one). The seven losses and every gradient
    within 1e-9, the updated parameters within 1e-10, the IN-followed
    biases by their stated exception; every head of R has a gradient."""
    flags = STEPS[stn]
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--checkpoints_dir",
                                    str(tmp_path / "jax"), *tt.SLICE, *flags])
    model = create_model(TrainOptions().parse([*tt.SLICE, "--gpu_ids", "-1",
                                               "--checkpoints_dir", str(tmp_path / "port"),
                                               *flags]))
    head_names = {n for n, m in model.netR.named_children()
                  if any(m is h for h in model.netR.heads())}
    assert len(head_names) == (1 if stn == "affine" else 3)
    rng = np.random.default_rng(0)
    item = SyntheticDataset(jopt)
    batch = {k: np.stack([item[i][k] for i in range(2)]) for k in ("A", "B")}
    rec = []
    with pa.jax_float64():
        jm = jax_create_model(jopt)
        jm.setup(jopt)
        params = {n: _redraw(getattr(jm.state, f"params_{n}"), rng,
                             head_names if n == "R" else ()) for n in "GDR"}
        (losses, grads, new, _), = tt._jax_steps(
            jm, {n: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                 for n, t in params.items()}, [batch], {}, stn, rec)
    assert {leaf.dtype for n in "GDR" for leaf in jax.tree.leaves((grads[n], new[n]))} \
        == {np.dtype(np.float64)}

    for name, tree in params.items():
        net = getattr(model, f"net{name}").double()
        net.load_state_dict(flax_to_torch(tree, net, pa.F64))
    model.setup(model.opt)
    model.set_epoch(1)
    before = {n: {k: v.detach().clone() for k, v in getattr(model, f"net{n}").named_parameters()}
              for n in "GDR"}
    model.set_input(batch)
    model.real_A, model.real_B = model.real_A.double(), model.real_B.double()
    model.optimize_parameters()
    got = model.get_current_losses()
    assert list(got) == tt.LOSSES
    for k in tt.LOSSES:
        assert abs(got[k] - losses[k]) <= pa.TOL64 * abs(losses[k]) + 1e-15, (k, got[k], losses[k])

    bound = tt.LR * (1 + 1e-6)  # Adam's first step, lr * g / (|g| + eps)
    skip = _in_bias_keys(model)
    assert set(grads) == {"G", "D", "R"}
    for name in "GDR":
        net = getattr(model, f"net{name}")
        ref_g = flax_to_torch(grads[name], net, pa.F64)
        ref_p = flax_to_torch(new[name], net, pa.F64)
        jbefore = flax_to_torch(params[name], net, pa.F64)
        for key, p in net.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if key in skip[name]:  # zero up to roundoff, relative to the conv's weight's
                scale = float(torch.linalg.vector_norm(ref_g[key.replace(".bias", ".weight")]))
                assert max(float(ref_g[key].abs().max()), float(g.abs().max())) \
                    <= pa.TOL64 * scale, (name, key)
                assert float((p.detach() - before[name][key]).abs().max()) <= bound, (name, key)
                assert float((ref_p[key] - jbefore[key]).abs().max()) <= bound, (name, key)
                continue
            assert torch.any(ref_g[key]), (name, key)
            assert pa._rel(g, ref_g[key]) <= pa.TOL64, (name, key, pa._rel(g, ref_g[key]))
            err = float((p.detach() - ref_p[key]).abs().max())
            assert err <= 1e-10, (name, key, err)
    # every head has a gradient, the coarse ones too
    assert all(float(torch.linalg.vector_norm(h.weight.grad)) > 0 for h in model.netR.heads())
