"""The template model families on the port (ROADMAP.md A9) against the JAX
package: ``pix2pix``, ``cycle_gan`` and ``test``, NeMAR under ``--norm
batch``, dropout in training, ``--remat``, the registry and the entry
points.

A JAX model and the port's are built from the same flags; both take the
same parameters (kernels N(0, 0.02), biases N(0, 0.05), drawn with numpy
in the JAX tree's shapes and carried by ``flax_to_torch``) and fresh Adam
states, and train on the same batches in float64, as
``test_torch_a5_step.py`` holds a step (it says why: two float32 runs of a
step do not share every relu mask and L1 sign). The JAX step's gradients
are recorded where it hands them to optax. Held: the losses and every
gradient within 1e-9 (relative), the parameters after each step within
1e-10. The biases of convolutions followed by a norm have a gradient of
roundoff in both (or none, in the port's fused kernels): it is held to
1e-9 of the gradient of the same convolution's weight, and the bias to at
most 1.1 lr of movement a step in each package.

The JAX models are built with ``flax.linen.Module.init`` returning zeros
of the tree's shapes (``_shapes_only``): an eager init compiles each op,
and the parameters are replaced anyway.
"""

import contextlib
import os
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nemar_pallas_all as pa
import test_torch_nemar_train as tt
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.options import TestOptions as JaxTestOptions
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.utils.image_pool import PoolState
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import base_model, create_model, find_model_using_name, networks
from nemar_tpu_torch.options import TestOptions, TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

TOL64 = 1e-9
LR = 2e-4
F64 = torch.float64
PIX2PIX = ["--model", "pix2pix", "--netG", "unet_128", "--crop_size", "128", "--load_size",
           "128", "--ngf", "4", "--ndf", "4", "--batch_size", "2", "--norm", "batch",
           "--no_dropout", "--input_nc", "3", "--output_nc", "3"]
CYCLE = ["--model", "cycle_gan", "--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "32", "--ngf", "8", "--ndf", "8", "--batch_size", "2", "--pool_size", "2",
         "--input_nc", "3", "--output_nc", "3"]
NEMAR_BATCH = ["--model", "nemar", "--norm", "batch", "--crop_size", "32", "--load_size", "32",
               "--ngf", "8", "--ndf", "8", "--stn_ngf", "8", "--stn_depth", "3",
               "--batch_size", "2"]
POOL = 2


@contextlib.contextmanager
def _shapes_only():
    """flax ``Module.init`` returning numpy zeros of the variables' shapes
    (``jax.eval_shape``: nothing compiled)."""
    orig = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda: orig(self, rngs, *args, **kwargs))
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = orig


def _jax_model(root, flags, train=True):
    opts = JaxTrainOptions() if train else JaxTestOptions()
    jopt = opts.parse(["--dataroot", "__synthetic__", "--dataset_mode", "synthetic",
                       "--checkpoints_dir", str(root / "jax"), "--name", "jax", *flags])
    with _shapes_only():
        return jax_create_model(jopt)


def _draw(tree, rng):
    """kernels N(0, 0.02), biases N(0, 0.05), in the tree's shapes."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((0.05 if path[-1].key == "bias" else 0.02)
                            * rng.standard_normal(np.shape(leaf))).astype(np.float32),
        jax.device_get(tree))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _one_device(state):
    """state on one device: the JAX model replicates its state over the
    test mesh, and a step's output on other shardings than its input's
    would trace and compile the step again."""
    return jax.device_put(state, jax.devices()[0])


def _port_model(root, flags, params: dict):
    """The port's model of ``flags`` on the CPU in float64 with ``params``
    ({net name: flax tree}), set up (fresh Adam)."""
    model = create_model(TrainOptions().parse([*flags, "--dataset_mode", "synthetic",
                                               "--gpu_ids", "-1", "--checkpoints_dir",
                                               str(root / "port"), "--name", "port"]))
    for name, tree in params.items():
        net = model.nets()[name].double()
        net.load_state_dict(flax_to_torch(tree, net, F64))
    model.setup(model.opt)
    model.set_epoch(1)
    return model


def _batches(n_steps, nc_a, nc_b, size, seed):
    """float32 batches of 2, as the datasets give them (JAX takes them
    widened to float64, the port's set_input in float32 then widened)."""
    rng = np.random.default_rng(seed)
    return [{k: rng.uniform(-1, 1, (2, size, size, c)).astype(np.float32)
             for k, c in (("A", nc_a), ("B", nc_b))} for _ in range(n_steps)]


def _jnp64(batch):
    return jnp.asarray(batch["A"], jnp.float64), jnp.asarray(batch["B"], jnp.float64)


def _set_input(model, batch):
    model.set_input(batch)
    model.real_A, model.real_B = model.real_A.double(), model.real_B.double()


def _norm_biases(net) -> set:
    """The biases of ``net``'s convolutions that a norm follows (a gradient
    of roundoff): every one but the ResNet head's; the UNet's encoder
    convolutions but the first and the innermost, and its transposed ones
    but the outermost; the PatchGAN's Conv_1..n_layers; the UNet STN's
    every one but its flow heads'."""
    if isinstance(net, networks.ResnetGenerator):
        head = f"Conv_{1 + net.n_downsampling}."
        return {k for k, _ in net.named_parameters() if k.endswith(".bias")
                and not k.startswith(head)}
    if isinstance(net, networks.UnetGenerator):
        n = net.num_downs
        return ({f"Conv_{i}.bias" for i in range(1, n - 1)}
                | {f"ConvTranspose_{j}.bias" for j in range(n - 1)})
    if isinstance(net, networks.NLayerDiscriminator):
        return {f"Conv_{i}.bias" for i in range(1, net.n_layers + 1)}
    heads = set(net.head_index.values())  # R's flow heads: no norm follows
    return {f"Conv_{i}.bias" for i in range(net.n_convs) if i not in heads}


def _hold_step(name, net, jgrads, jparams, start, steps):
    """The port's gradients and parameters of ``net`` after its ``steps``-th
    step against JAX's (flax trees), ``start`` its parameters before the
    first."""
    ref_g = flax_to_torch(jgrads, net, F64)
    ref_p = flax_to_torch(jparams, net, F64)
    skip = _norm_biases(net)
    bound = 1.1 * LR * steps
    for key, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if key in skip:
            scale = float(torch.linalg.vector_norm(ref_g[key.replace(".bias", ".weight")]))
            assert max(float(ref_g[key].abs().max()), float(g.abs().max())) <= TOL64 * scale, \
                (name, key)
            assert float((p.detach() - start[key]).abs().max()) <= bound, (name, key)
            assert float((ref_p[key] - start[key]).abs().max()) <= bound, (name, key)
            continue
        assert torch.any(ref_g[key]), (name, key)
        assert pa._rel(g, ref_g[key]) <= TOL64, (name, key, pa._rel(g, ref_g[key]))
        err = float((p.detach() - ref_p[key]).abs().max())
        assert err <= 1e-10, (name, key, err)


def _hold_losses(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL64 * abs(v) + 1e-15, (k, got[k], v)


@pytest.mark.parametrize("name,cls", [("nemar", "NEMARModel"), ("pix2pix", "Pix2PixModel"),
                                      ("cycle_gan", "CycleGANModel"), ("test", "TestModel")])
def test_registry_resolves_the_four_models(name, cls):
    assert find_model_using_name(name).__name__ == cls


def test_pix2pix_step_matches_jax(tmp_path):
    """One step at unet_128, 128^2, ngf 4, batch 2, --norm batch
    --no_dropout, vanilla GAN (the template's defaults otherwise): the
    conditional D's two passes, the D step, then G against the updated D."""
    jm = _jax_model(tmp_path, PIX2PIX)
    rng = np.random.default_rng(0)
    params = {"G": _draw(jm.state.params_G, rng), "D": _draw(jm.state.params_D, rng)}
    rec = []
    jm.tx = tt._recording(jm.tx, "GD", rec)
    (batch,) = _batches(1, 3, 3, 128, 1)
    with pa.jax_float64():
        p = {n: _f64(t) for n, t in params.items()}
        state = _one_device(jm.state.replace(params_G=p["G"], params_D=p["D"],
                                             opt_G=jm.tx.init(p["G"]), opt_D=jm.tx.init(p["D"])))
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, *_jnp64(batch), jnp.float64(LR))
        jax.block_until_ready(state)
    grads = {("G" if "ConvTranspose_0" in t["params"] else "D"): t for _, t in rec}
    assert set(grads) == {"G", "D"}

    model = _port_model(tmp_path, PIX2PIX, params)
    assert model.gan_mode == "vanilla" and model.lambda_L1 == 100.0
    start = {n: flax_to_torch(params[n], model.nets()[n], F64) for n in "GD"}
    _set_input(model, batch)
    model.optimize_parameters()
    _hold_losses(model.get_current_losses(), {k: float(metrics[k]) for k in model.loss_names})
    for n in "GD":
        _hold_step(n, model.nets()[n], grads[n], jax.device_get(getattr(state, f"params_{n}")),
                   start[n], 1)


def _cycle_draws(key, n):
    """The pool draws of one JAX cycle_gan step from the state's key: the
    next key, then (use_old, rand_idx) for pool_B and for pool_A, in the
    order the step queries them."""
    nxt, r_a, r_b = jax.random.split(key, 3)
    draws = []
    for r in (r_b, r_a):
        r_choice, r_idx = jax.random.split(r)
        draws.append((torch.tensor(np.asarray(jax.random.bernoulli(r_choice, 0.5, (n,)))),
                      torch.tensor(np.asarray(jax.random.randint(r_idx, (n,), 0, POOL)),
                                   dtype=torch.int64)))
    return nxt, draws


def test_cycle_gan_steps_match_jax(tmp_path):
    """Two steps at resnet_6blocks, 32^2, ngf 8, batch 2, a pool of 2 (it
    fills in the first step; the second swaps), the port fed JAX's pool
    draws: losses, gradients, parameters and the pools after each step."""
    jm = _jax_model(tmp_path, CYCLE)
    rng = np.random.default_rng(2)
    names = ("G_A", "G_B", "D_A", "D_B")
    params = {n: _draw(getattr(jm.state, f"params_{n}"), rng) for n in names}
    rec = []
    jm.tx = tt._recording(jm.tx, "GD", rec)
    batches = _batches(2, 3, 3, 32, 3)
    out, all_draws = [], []
    with pa.jax_float64():
        p = {n: _f64(t) for n, t in params.items()}
        empty = PoolState(jnp.zeros((POOL, 32, 32, 3), jnp.float64), jnp.int32(0))
        state = _one_device(jm.state.replace(
            **{f"params_{n}": p[n] for n in names},
            opt_G=jm.tx.init({"A": p["G_A"], "B": p["G_B"]}),
            opt_D=jm.tx.init({"A": p["D_A"], "B": p["D_B"]}), pool_A=empty, pool_B=empty))
        step = jax.jit(lambda *a: jm._train_step_impl(*a))
        for batch in batches:
            all_draws.append(_cycle_draws(state.rng, 2)[1])
            rec.clear()
            state, metrics = step(state, *_jnp64(batch), jnp.float64(LR))
            jax.block_until_ready(state)
            grads = {}
            for _, t in rec:
                kind = "G" if "ResnetBlock_0" in t["A"]["params"] else "D"
                grads.update({f"{kind}_{k}": t[k] for k in "AB"})
            out.append(({k: float(v) for k, v in metrics.items()}, grads,
                        {n: jax.device_get(getattr(state, f"params_{n}")) for n in names},
                        {k: (np.asarray(getattr(state, f"pool_{k}").images),
                             int(getattr(state, f"pool_{k}").count)) for k in "AB"}))
    swaps = [bool(u and i < POOL) for draws in all_draws[1] for u, i in zip(*draws)]
    assert any(swaps), "the second step swaps nothing: the pool's path to D is not reached"

    model = _port_model(tmp_path, CYCLE, params)
    model.pools = {k: (torch.zeros((POOL, 3, 32, 32), dtype=F64), torch.tensor(0))
                   for k in "AB"}
    start = {n: flax_to_torch(params[n], model.nets()[n], F64) for n in names}
    for i, (batch, (losses, grads, new, pools)) in enumerate(zip(batches, out)):
        model._pool_draws = lambda n, it=iter(all_draws[i]): next(it)
        _set_input(model, batch)
        model.optimize_parameters()
        _hold_losses(model.get_current_losses(), {k: losses[k] for k in model.loss_names})
        for n in names:
            _hold_step(n, model.nets()[n], grads[n], new[n], start[n], i + 1)
        for k in "AB":
            images, count = model.pools[k]
            assert int(count) == pools[k][1] == POOL
            np.testing.assert_allclose(images.permute(0, 2, 3, 1).numpy(), pools[k][0],
                                       rtol=0, atol=1e-10)


def test_test_model_serves_cycle_gan_g_a_as_jax(tmp_path):
    """cycle_gan's G_A saved by the port and loaded by ``--model test
    --model_suffix _A``, against JAX's TestModel with the same weights: a
    b1 request's output within 1e-5 of its largest value (fp32)."""
    rng = np.random.default_rng(4)
    train = create_model(TrainOptions().parse([*CYCLE, "--dataset_mode", "synthetic",
                                               "--gpu_ids", "-1", "--checkpoints_dir",
                                               str(tmp_path), "--name", "cyc"]))
    flags = ["--model", "test", "--model_suffix", "_A", "--netG", "resnet_6blocks", "--ngf", "8",
             "--crop_size", "32", "--load_size", "32", "--input_nc", "3", "--output_nc", "3",
             "--no_dropout"]
    jm = _jax_model(tmp_path, flags, train=False)
    params = _draw(jm.state.params_G, rng)
    train.netG_A.load_state_dict(flax_to_torch(params, train.netG_A))
    train.setup(train.opt)
    train.save_networks("latest")
    assert jm.model_names == ["G_A"]
    jm.state = jm.state.replace(params_G=jax.tree.map(jnp.asarray, params))
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jm.set_input({"A": x, "A_paths": ["x"]})
    jm.forward()
    want = np.asarray(jm.fake)

    opt = TestOptions().parse([*flags, "--dataset_mode", "synthetic", "--gpu_ids", "-1",
                               "--checkpoints_dir", str(tmp_path), "--name", "cyc"])
    model = create_model(opt)
    model.setup(opt)
    assert list(model.nets()) == ["G_A"] and model.nets()["G_A"] is model.netG
    model.set_input({"A": x, "A_paths": ["x"]})
    model.test()
    got = model.get_current_visuals()
    assert list(got) == ["real", "fake"]
    assert np.max(np.abs(got["fake"] - want)) <= 1e-5 * np.max(np.abs(want))
    with pytest.raises(RuntimeError, match="no training step"):
        model.optimize_parameters()
    with pytest.raises(AssertionError, match="inference-only"):
        TrainOptions().parse(["--model", "test", "--dataset_mode", "synthetic"])


def test_cycle_gan_refuses_mismatched_nc(tmp_path):
    opt = TrainOptions().parse([*CYCLE, "--dataset_mode", "synthetic", "--gpu_ids", "-1",
                                "--checkpoints_dir", str(tmp_path), "--input_nc", "1"])
    with pytest.raises(ValueError, match="input_nc == output_nc"):
        create_model(opt)


def test_nemar_step_under_batch_norm_matches_jax(tmp_path):
    """One NeMAR step under --norm batch: D's two passes (real, fake), G's
    plain blocks and decoder, against JAX's step."""
    jm = _jax_model(tmp_path, NEMAR_BATCH)
    rng = np.random.default_rng(5)
    params = {n: _draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    rec = []
    jm.tx, jm.tx_R = tt._recording(jm.tx, "GD", rec), tt._recording(jm.tx_R, "R", rec)
    (batch,) = _batches(1, 1, 3, 32, 6)
    with pa.jax_float64():
        p = {n: _f64(t) for n, t in params.items()}
        state = _one_device(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])}, opt_D=jm.tx.init(p["D"])))
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, *_jnp64(batch), jnp.float64(LR), jm._gan_w_scalar(), jm._r_gate_scalar())
        jax.block_until_ready(state)
    grads = {}
    for tag, t in rec:
        grads["R" if tag == "R" else ("G" if "ResnetBlock_0" in t["params"] else "D")] = t

    model = _port_model(tmp_path, NEMAR_BATCH, params)
    assert not model.netG.ResnetBlock_0.fused
    start = {n: flax_to_torch(params[n], model.nets()[n], F64) for n in "GDR"}
    _set_input(model, batch)
    model.optimize_parameters()
    _hold_losses(model.get_current_losses(), {k: float(metrics[k]) for k in model.loss_names})
    for n in "GDR":
        _hold_step(n, model.nets()[n], grads[n], jax.device_get(getattr(state, f"params_{n}")),
                   start[n], 1)


def test_g_batch_refused_under_batch_norm(tmp_path):
    opt = TrainOptions().parse([*NEMAR_BATCH, "--dataset_mode", "synthetic", "--gpu_ids", "-1",
                                "--checkpoints_dir", str(tmp_path), "--g_batch"])
    with pytest.raises(ValueError, match="--g_batch requires --norm instance"):
        create_model(opt)


def test_nemar_refuses_dropout_when_built(tmp_path):
    """An opt with dropout (possible only from code: the CLI's default is
    --no_dropout) is refused by name when NeMAR is built, not at its first
    training forward."""
    opt = TrainOptions().parse([*NEMAR_BATCH[:2], *NEMAR_BATCH[4:], "--dataset_mode",
                                "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
                                str(tmp_path)])
    opt.no_dropout = False
    with pytest.raises(ValueError, match="nemar model's G takes no dropout"):
        create_model(opt)


def test_dropout_generator_state_across_device_types(tmp_path):
    """The dropout generator's state is not saved: a step reseeds it from
    --seed and the step count (``base_model.dropout_seed``), which carry
    over on either device type. A state of the earlier format, whose
    generator was a card one, loads on the CPU without a warning, and the
    next step's first mask is the first draw from its step count's seed."""
    flags = [f for f in PIX2PIX if f != "--no_dropout"]
    model = create_model(TrainOptions().parse([*flags, "--dataset_mode", "synthetic",
                                               "--gpu_ids", "-1", "--checkpoints_dir",
                                               str(tmp_path)]))
    model.setup(model.opt)
    assert "drop_gen" not in model.extra_train_state()
    model.step = 5
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model.load_extra_train_state({"drop_gen": {"device": "cuda", "state": torch.zeros(
            16, dtype=torch.uint8)}}, "latest")
    drop = next(m for m in model.netG.modules() if isinstance(m, networks.Dropout))
    seen = []
    drop.register_forward_hook(lambda m, i, o: seen.append((i[0].detach(), o.detach())))
    (batch,) = _batches(1, 3, 3, 128, 7)
    model.set_input(batch)
    model.optimize_parameters()
    x, y = seen[0]
    gen = torch.Generator().manual_seed(base_model.dropout_seed(model.opt.seed + 23, 5))
    keep = torch.empty_like(x).uniform_(generator=gen) >= drop.p
    assert model.step == 6 and torch.equal(y, torch.where(keep, x / (1.0 - drop.p), 0.0))


def test_pix2pix_dropout_one_draw_from_the_model_generator(tmp_path):
    """pix2pix with dropout (unet_128, instance norm): a step runs G once,
    so D's fake and G's backward see one draw, taken from the model's
    generator (the global one not moved); the draw keeps about half of an
    innermost level's values, scaled by 2; the visuals' forward has dropout
    off (two forwards equal, the generator not moved)."""
    flags = [f for f in PIX2PIX if f != "--no_dropout"] + ["--norm", "instance"]
    model = create_model(TrainOptions().parse([*flags, "--dataset_mode", "synthetic",
                                               "--gpu_ids", "-1", "--checkpoints_dir",
                                               str(tmp_path)]))
    model.setup(model.opt)
    drops = [m for m in model.netG.modules() if isinstance(m, networks.Dropout)]
    assert len(drops) == 3 and all(d.generator is model.drop_gen for d in drops)
    seen = {"G": 0, "D": []}
    model.netG.register_forward_hook(lambda m, i, o: seen.__setitem__("G", seen["G"] + 1))
    model.netD.register_forward_hook(lambda m, i, o: seen["D"].append(i[0][:, 3:].detach()))
    kept = []
    drops[0].register_forward_hook(lambda m, i, o: kept.append((i[0].detach(), o.detach())))
    (batch,) = _batches(1, 3, 3, 128, 7)
    model.set_input(batch)
    gen0, glob0 = model.drop_gen.get_state(), torch.random.get_rng_state()
    model.optimize_parameters()
    assert seen["G"] == 1
    both, fake_g = seen["D"]  # the D step's one pass over [real; fake], then G's loss
    assert torch.equal(both[2:], fake_g)
    assert not torch.equal(model.drop_gen.get_state(), gen0)
    assert torch.equal(torch.random.get_rng_state(), glob0)
    x, y = kept[0]
    nz = y != 0
    assert 0.3 < float(nz.float().mean()) < 0.7 and torch.equal(y[nz], 2 * x[nz])
    gen1 = model.drop_gen.get_state()
    model.test()
    first = model.get_current_visuals()["fake_B"]
    model.test()
    assert np.array_equal(first, model.get_current_visuals()["fake_B"])
    assert torch.equal(model.drop_gen.get_state(), gen1) and model.netG.training


def _cycle_model(ckpt, *flags):
    opt = TrainOptions().parse([*CYCLE, "--dataset_mode", "synthetic", "--gpu_ids", "-1",
                                "--ngf", "4", "--ndf", "4", "--checkpoints_dir", str(ckpt),
                                "--name", "resume", *flags])
    model = create_model(opt)
    model.setup(opt)
    return model


def test_cycle_gan_resumes_bit_for_bit(tmp_path):
    """--continue_train restores cycle_gan's four nets, both Adams, the
    step count, the pools and the generators: 1 step, save, resume, 2 more
    steps equal 3 uninterrupted ones (the pool of 2 swapping from the
    second)."""
    batches = _batches(3, 3, 3, 32, 8)
    run = _cycle_model(tmp_path / "a")
    for i, b in enumerate(batches):
        run.set_input(b)
        run.optimize_parameters()
        if i == 0:
            run.save_networks("latest")
            cut = _cycle_model(tmp_path / "a", "--continue_train")
    for b in batches[1:]:
        cut.set_input(b)
        cut.optimize_parameters()
    assert cut.step == run.step == 3
    for n in ("G_A", "G_B", "D_A", "D_B"):
        for p, q in zip(cut.nets()[n].parameters(), run.nets()[n].parameters()):
            assert torch.equal(p, q), n
    for n in "GD":
        sa, sb = cut.optimizers[n].state_dict()["state"], run.optimizers[n].state_dict()["state"]
        assert sa.keys() == sb.keys() and all(
            torch.equal(sa[k][f], sb[k][f]) for k in sa for f in ("exp_avg", "exp_avg_sq"))
    for k in "AB":
        assert all(torch.equal(a, b) for a, b in zip(cut.pools[k], run.pools[k]))
    assert torch.equal(cut.rng.get_state(), run.rng.get_state())


@pytest.mark.parametrize("norm,bf16", [("instance", False), ("instance", True), ("none", True)])
def test_nemar_remat_bit_equal(tmp_path, norm, bf16):
    """--remat (R and G's trunk blocks recomputed in the backward) leaves a
    NeMAR step's gradients and parameters bit-identical, under --bf16 too:
    there G runs inside ``functional_call`` on bf16 copies of its
    parameters, which the blocks' recomputation reads again, through the
    fused block (instance norm) and the plain convolutions (none)."""
    runs = []
    (batch,) = _batches(1, 1, 3, 32, 9)
    extra = ["--norm", norm] + (["--bf16"] if bf16 else [])
    for flags in ([], ["--remat"]):
        opt = TrainOptions().parse([*NEMAR_BATCH[:2], *NEMAR_BATCH[4:], "--dataset_mode",
                                    "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
                                    str(tmp_path), *extra, *flags])
        model = create_model(opt)
        model.setup(opt)
        model.set_input(batch)
        model.optimize_parameters()
        runs.append([t.detach().clone() for net in model.nets().values()
                     for p in net.parameters() for t in (p, p.grad) if t is not None])
    assert model.remat and model.netG.use_remat and model.bf16 == bf16
    assert len(runs[0]) == len(runs[1])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_entry_points_train_and_serve_the_families(tmp_path):
    """``nemar_tpu_torch.train`` trains cycle_gan and pix2pix for an epoch
    on the CPU and writes their nets; ``nemar_tpu_torch.test`` serves
    cycle_gan's G_A as ``--model test --model_suffix _A`` and pix2pix's G;
    ``--eval_registration`` summarises nothing for a model without a field."""
    shared = ["--dataset_mode", "synthetic", "--synthetic_size", "2", "--gpu_ids", "-1",
              "--checkpoints_dir", str(tmp_path), "--crop_size", "32", "--load_size", "32",
              "--ngf", "4", "--ndf", "4", "--input_nc", "3", "--output_nc", "3"]
    sched = ["--n_epochs", "1", "--n_epochs_decay", "0", "--display_freq", "1",
             "--print_freq", "1", "--save_epoch_freq", "1", "--batch_size", "2"]
    port_train.main(["--model", "cycle_gan", "--name", "cyc", "--netG", "resnet_6blocks",
                     *shared, *sched])
    port_train.main(["--model", "pix2pix", "--name", "p2p", "--netG", "resnet_6blocks",
                     "--norm", "none", *shared, *sched])
    ckpt = os.listdir(tmp_path / "cyc")
    assert {f"latest_net_{n}.pth" for n in ("G_A", "G_B", "D_A", "D_B")} <= set(ckpt)
    serve = [*shared, "--results_dir", str(tmp_path / "res"), "--num_test", "2",
             "--eval_registration"]
    assert port_test.main(["--model", "test", "--name", "cyc", "--model_suffix", "_A",
                           "--netG", "resnet_6blocks", "--no_dropout", *serve]) == {}
    assert port_test.main(["--model", "pix2pix", "--name", "p2p", "--netG", "resnet_6blocks",
                           "--norm", "none", *serve]) == {}
