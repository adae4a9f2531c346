"""The port against the JAX package's TPU layouts of G's head and decoder,
``--block_impl pallas_all`` (the fused trunk B1, the fused decoder stage B5
and the flat-lane head B6) and ``--c7_impl roll`` (the roll head B4), with
the Pallas kernels in interpret mode on the CPU.

The size is the least at which JAX reaches all three: 128^2, batch 1, ngf
64 (the head's input is 128 wide, as B4 and B6 need; the first decoder
stage has 128 output channels, as B5 needs; the second, 64, runs JAX's XLA
reference of the same function). The STN and D are narrow (stn_ngf 8,
depth 3, ndf 8).

  * G alone, from one converted parameter tree: the output in float32
    (1e-4 of its largest value), and in float64 the output and the
    gradients of the input and of every parameter for one seeded cotangent;
  * one NeMAR training step under ``--block_impl pallas_all`` from fresh
    Adam states, in float64: the seven losses, every gradient and the
    updated parameters. Under ``pallas_all`` neither package gives the
    decoder's ConvTranspose biases a gradient (B5 and its reference leave
    them out, as the port does), so both must hold them unchanged exactly.

Why float64 for the gradients: at this size two float32 runs do not share
every relu mask. An element within roundoff of 0 falls on either side, and
its gradient moves by O(1): measured, one flipped element of the second
decoder stage moves every upstream gradient of G by 1.7e-3 of its norm, and
differently initialised weights flip elements of JAX's own float32 paths
against each other (dx 0.13 apart). So JAX runs with 64-bit types on and
``jnp.float32`` read as float64 (its kernels name float32 for their
accumulators, one of them as a default argument), and the port's CPU path,
which is dtype-generic, in float64.
Both then compute the same function to ~1e-14, and no mask can differ.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nemar_tpu.data.synthetic_dataset import SyntheticDataset
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.models import networks as jnetworks
from nemar_tpu.ops import conv_fused as jax_conv_fused
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.parallel import replicate
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

SIZE = 128
SLICE = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "pallas_all",
         "--crop_size", str(SIZE), "--load_size", str(SIZE), "--ngf", "64", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3", "--synthetic_size", "2", "--batch_size", "1"]
LR = 2e-4
LOSSES = ["D", "D_real", "D_fake", "G_GAN", "G_recon", "G_smooth", "G"]
F64 = torch.float64
# float64 roundoff of two implementations: losses and gradients (relative)
TOL64 = 1e-9


@contextlib.contextmanager
def jax_float64():
    """JAX with 64-bit types, and every ``jnp.float32`` read as float64. The
    switch is global, not a thread-local context: host callbacks (the
    gradient recorder below) run on other threads."""
    f32 = jnp.float32
    conv9 = jax_conv_fused._conv9
    defaults = conv9.__defaults__
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    conv9.__defaults__ = tuple(jnp.float64 if d is f32 else d for d in defaults)
    try:
        yield
    finally:
        jnp.float32 = f32
        conv9.__defaults__ = defaults
        jax.config.update("jax_enable_x64", x64)


def _redraw_biases(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(leaf), tree)


def _in_bias_keys(net) -> set:
    """G's biases of convolutions followed by instance norm (all but the head's)."""
    head = f"Conv_{1 + net.n_downsampling}."
    return {k for k in net.state_dict() if k.endswith(".bias") and not k.startswith(head)}


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("flag", [("block_impl", "pallas_all"), ("c7_impl", "roll")])
def test_generator_matches_jax_layout(flag):
    """G's forward and every gradient against JAX G with the TPU kernels."""
    rng = np.random.default_rng(0)
    jg = jnetworks.define_G(1, 3, 64, "resnet_6blocks", **dict([flag]))
    x = rng.standard_normal((1, SIZE, SIZE, 1)).astype(np.float32)
    g = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    params = _redraw_biases(jax.device_get(jg.init(jax.random.key(0), jnp.asarray(x))), rng)
    net = networks.define_G(1, 3, 64, "resnet_6blocks")
    net.load_state_dict(flax_to_torch(params, net))

    # float32: the forward
    want32 = np.asarray(jg.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got32 = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got32 - want32)) <= 1e-4 * np.max(np.abs(want32))

    # float64: the forward and the gradients
    with jax_float64():
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        out, vjp = jax.vjp(lambda p, xx: jg.apply(p, xx), p64, jnp.asarray(x, jnp.float64))
        dparams, dx = vjp(jnp.asarray(g, jnp.float64))
        out, dx, dparams = np.asarray(out), np.asarray(dx), jax.device_get(dparams)
    assert out.dtype == np.float64
    net.double()
    xt = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    got = net(xt)
    got.backward(torch.from_numpy(g).double().permute(0, 3, 1, 2))
    got_out = got.detach().permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got_out - out)) <= TOL64 * np.max(np.abs(out))
    got_dx = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got_dx - dx)) <= TOL64 * np.max(np.abs(dx))

    ref = flax_to_torch(dparams, net, F64)
    skip = _in_bias_keys(net)
    for key, p in net.named_parameters():
        got_g = torch.zeros_like(p) if p.grad is None else p.grad
        if key in skip:  # zero up to roundoff, relative to the conv's weight gradient
            scale = float(torch.linalg.vector_norm(ref[key.replace(".bias", ".weight")]))
            assert max(float(ref[key].abs().max()), float(got_g.abs().max())) <= TOL64 * scale, \
                key
            continue
        assert _rel(got_g, ref[key]) <= TOL64, (key, _rel(got_g, ref[key]))
    # the port gives the decoder's biases no gradient at all
    for i in range(net.n_downsampling):
        assert getattr(net, f"ConvTranspose_{i}").bias.grad is None


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One float64 JAX training step under --block_impl pallas_all from fresh
    Adam: (redrawn numpy params, batch, losses, grads, new params)."""
    root = tmp_path_factory.mktemp("pallas_all")
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--checkpoints_dir",
                                    str(root / "jax"), "--block_impl", "pallas_all", *SLICE])
    rng = np.random.default_rng(1)
    item = SyntheticDataset(jopt)[0]
    batch = {k: item[k][None] for k in ("A", "B")}
    rec = []

    def recording(tx, tag):
        def update(grads, state, p=None):
            jax.debug.callback(lambda gr: rec.append((tag, jax.tree.map(np.asarray, gr))), grads)
            return tx.update(grads, state, p)

        return optax.GradientTransformation(tx.init, update)

    with jax_float64():
        jm = jax_create_model(jopt)
        jm.setup(jopt)
        params = {n: _redraw_biases(jax.device_get(getattr(jm.state, f"params_{n}")), rng)
                  for n in "GDR"}
        head = params["R"]["params"][f"Conv_{len(params['R']['params']) - 1}"]
        head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
        jm.tx, jm.tx_R = recording(jm.tx, "GD"), recording(jm.tx_R, "R")
        p = {n: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t) for n, t in params.items()}
        state = replicate(jm.state.replace(
            step=jnp.zeros((), jnp.int32), params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])), jm.mesh)
        jm.set_input(batch)
        step = jax.jit(lambda *args: jm._train_step_impl(*args))
        state, metrics = step(state, jm.real_A, jm.real_B, jnp.float64(LR), jm._gan_w_scalar(),
                              jm._r_gate_scalar())
        jax.block_until_ready(state)
        new = {n: jax.device_get(getattr(state, f"params_{n}")) for n in "GDR"}
        losses = {k: float(v) for k, v in metrics.items()}
    grads = {}
    for tag, tree in rec:
        grads["R" if tag == "R" else ("G" if "ResnetBlock_0" in tree["params"] else "D")] = tree
    return params, batch, losses, grads, new


def test_train_step_matches_jax_pallas_all(jax_step, tmp_path):
    params, batch, losses, grads, new = jax_step
    assert {leaf.dtype for n in "GDR" for leaf in jax.tree.leaves((grads[n], new[n]))} \
        == {np.dtype(np.float64)}
    model = create_model(TrainOptions().parse([*SLICE, "--gpu_ids", "-1", "--block_impl",
                                               "pallas_all", "--checkpoints_dir",
                                               str(tmp_path)]))
    for name, tree in params.items():
        net = getattr(model, f"net{name}").double()
        net.load_state_dict(flax_to_torch(tree, net, F64))
    model.setup(model.opt)
    model.set_epoch(1)
    before = {n: {k: v.detach().clone() for k, v in getattr(model, f"net{n}").named_parameters()}
              for n in "GDR"}
    model.set_input(batch)
    model.real_A, model.real_B = model.real_A.double(), model.real_B.double()
    model.optimize_parameters()

    got = model.get_current_losses()
    assert list(got) == LOSSES
    for k in LOSSES:
        assert abs(got[k] - losses[k]) <= TOL64 * abs(losses[k]) + 1e-15, (k, got[k], losses[k])

    # Adam's first step is lr * g / (|g| + eps): where a gradient is zero up
    # to roundoff (the IN-followed biases) its sign, and so the update, is
    # either way, by at most lr; everywhere else the updates agree
    bound = LR * (1 + 1e-6)
    skip = {"G": _in_bias_keys(model.netG),
            "D": {f"Conv_{i}.bias" for i in range(1, model.netD.n_layers + 1)},
            "R": {f"Conv_{i}.bias" for i in range(model.netR.n_convs - 1)}}
    assert set(grads) == {"G", "D", "R"}
    for name in "GDR":
        net = getattr(model, f"net{name}")
        ref_g = flax_to_torch(grads[name], net, F64)
        ref_p = flax_to_torch(new[name], net, F64)
        jbefore = flax_to_torch(params[name], net, F64)
        for key, p in net.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            moved = (p.detach() - before[name][key]).abs()
            if key in skip[name]:
                scale = float(torch.linalg.vector_norm(ref_g[key.replace(".bias", ".weight")]))
                assert max(float(ref_g[key].abs().max()), float(g.abs().max())) \
                    <= TOL64 * scale, (name, key)
                assert float(moved.max()) <= bound, (name, key)
                assert float((ref_p[key] - jbefore[key]).abs().max()) <= bound, (name, key)
                continue
            assert _rel(g, ref_g[key]) <= TOL64, (name, key, _rel(g, ref_g[key]))
            # lr * g / (|g| + eps) turns the gradient's relative roundoff
            # into up to lr times it where |g| is near eps: 1e-10 = lr * 5e-7
            err = float((p.detach() - ref_p[key]).abs().max())
            assert err <= 1e-10, (name, key, err)

    # the decoder's ConvTranspose biases: no gradient in either package, so
    # neither Adam moves them
    for i in range(model.netG.n_downsampling):
        key = f"ConvTranspose_{i}.bias"
        assert float(flax_to_torch(grads["G"], model.netG, F64)[key].abs().max()) == 0.0, key
        assert torch.equal(dict(model.netG.named_parameters())[key].detach(),
                           before["G"][key]), key
        assert torch.equal(flax_to_torch(new["G"], model.netG, F64)[key],
                           flax_to_torch(params["G"], model.netG, F64)[key]), key
