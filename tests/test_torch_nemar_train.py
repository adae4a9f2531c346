"""The port's NeMAR training step against the JAX package's ``_train_step_impl``.

A JAX ``nemar`` model (ResNet-6 G at ngf 32, depth-3 UNet STN at stn_ngf 8,
ndf 8, 32^2, batch 2) gets non-zero biases and a non-zero flow head, so
every R conv has a gradient; the same parameters are converted with
``flax_to_torch`` into the port's model on the CPU (``--gpu_ids -1``). Both
then take two steps from fresh Adam states on the same synthetic batches.
The JAX step's gradients are recorded where it hands them to optax (R's
after the clip and the gate), converted with the same map (it is linear),
and held against the port's ``.grad``s.

Tolerances: losses 1e-5 relative; every gradient ‖Δg‖/‖g‖ <= 1e-4; updated
parameters 1e-5 absolute (fp32 roundoff of two independent
implementations). The second step starts the port from JAX's state after
the first (parameters and Adam moments): stepped independently, the few
elements of the second exception below sit up to 2·lr apart after step 1,
and that moves step 2's D_fake by ~1e-3 relative (measured). Two stated exceptions, both because Adam's first step
turns a gradient's roundoff into an update of up to ±lr:

  * the biases of convolutions followed by instance norm have a gradient
    that is zero up to roundoff in both packages (None in the port's trunk,
    which leaves them out). With lambda_recon = 100 the gradients are large
    (‖dW‖ up to ~300 at the first conv of G) and that roundoff reaches
    ~2e-5, so the bound is relative: |grad| <= 1e-6 · ‖grad of the same
    conv's weight‖; and |Δparam| <= lr·(1+1e-3) per step (times Adam's
    bound on its t-th step, 1.054 at t = 2 with beta1 0.5);
  * the few weight elements whose gradient is within roundoff of zero (the
    packages disagree on its sign, or by more than half its size; at most
    2 + 1e-4 of a net's elements): the same bound on |Δparam|.

JAX's trunk runs through its Pallas kernels (interpret mode,
``--block_impl pallas``), so JAX's trunk biases are unused too, as in the
port.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from nemar_tpu.data.synthetic_dataset import SyntheticDataset
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.models import networks as jnetworks
from nemar_tpu.models.optim import make_adam
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.parallel import replicate
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "train",
         "--crop_size", "32", "--load_size", "32", "--ngf", "32", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3", "--synthetic_size", "4", "--batch_size", "2"]
LR = 2e-4
LOSSES = ["D", "D_real", "D_fake", "G_GAN", "G_recon", "G_smooth", "G"]
# recipe flags: the port's command line, and the JAX model's attributes they set
RECIPES = {
    "default": ([], {}),
    "stn_grad_clip": (["--stn_grad_clip", "0.001"], {"stn_grad_clip": 0.001}),
    "stn_warmup_epochs": (["--stn_warmup_epochs", "1"], {"stn_warmup": 1}),
    "recon_pyramid": (["--recon_pyramid", "2"], {"recon_pyramid": 2}),
    "border_mask": (["--border_mask"], {"border_mask": True}),
    "freeze_g": (["--freeze_g"], {"freeze_g": True}),
    "stn_lr": (["--stn_lr", "1e-4", "--stn_beta1", "0.9"],
               {"stn_lr_ratio": 0.5, "tx_R": make_adam(0.9)}),
}


def _port_opt(root, *extra):
    return TrainOptions().parse([*SLICE, "--gpu_ids", "-1", "--checkpoints_dir",
                                 str(root / "port"), *extra])


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """(root, JAX model, redrawn numpy params per net, two batches, step cache,
    gradient records)."""
    root = tmp_path_factory.mktemp("train")
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--checkpoints_dir",
                                    str(root / "jax"), "--block_impl", "pallas", *SLICE])
    jm = jax_create_model(jopt)
    jm.setup(jopt)
    rng = np.random.default_rng(0)
    params = {}
    for name in "GDR":
        tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
            getattr(jm.state, f"params_{name}")))

        def redraw(path, leaf):
            if path[-1].key == "bias":
                return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
            return leaf

        params[name] = jax.tree_util.tree_map_with_path(redraw, tree)
    head = params["R"]["params"][f"Conv_{len(params['R']['params']) - 1}"]
    head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    ds = SyntheticDataset(jopt)
    items = [ds[i] for i in range(4)]
    batches = [{k: np.stack([it[k] for it in items[j:j + 2]]) for k in ("A", "B")}
               for j in (0, 2)]
    # jitted JAX steps by the recipe attributes their trace reads, and the
    # list their gradient callbacks append to
    return root, jm, params, batches, {}, []


def _recording(tx, tag, rec):
    """tx whose update records the gradients it is handed, as numpy."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: rec.append((tag, jax.tree.map(np.asarray, g))), grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


def _jax_steps(jm, params, batches, cache, key, rec):
    """Two JAX steps from fresh Adam; per step (losses, {net: grads},
    {net: params}, {net: Adam state})."""
    if key not in cache:
        jm.tx = _recording(jm.tx, "GD", rec)
        jm.tx_R = _recording(jm.tx_R, "R", rec)
        # a fresh function per key: jit caches by the function, and the
        # bound method would hit the trace of an earlier recipe
        cache[key] = jax.jit(lambda *args: jm._train_step_impl(*args))
    step = cache[key]
    p = {n: jax.tree.map(jnp.asarray, t) for n, t in params.items()}
    state = replicate(jm.state.replace(
        step=jnp.zeros((), jnp.int32), params_G=p["G"], params_D=p["D"], params_R=p["R"],
        opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
        opt_D=jm.tx.init(p["D"])), jm.mesh)
    out = []
    for batch in batches:
        jm.set_input(batch)
        rec.clear()
        state, metrics = step(state, jm.real_A, jm.real_B, jnp.float32(LR),
                              jm._gan_w_scalar(), jm._r_gate_scalar())
        jax.block_until_ready(state)
        grads = {}
        for tag, tree in rec:
            name = "R" if tag == "R" else ("G" if "ResnetBlock_0" in tree["params"] else "D")
            grads[name] = tree
        new = {n: jax.tree.map(np.asarray, jax.device_get(getattr(state, f"params_{n}")))
               for n in "GDR"}
        adam = jax.device_get({"G": state.opt_G["G"], "R": state.opt_G["R"], "D": state.opt_D})
        out.append(({k: float(v) for k, v in metrics.items()}, grads, new, adam))
    return out


def _load_jax_state(model, params, adam):
    """Set the port's parameters and Adam moments to JAX's."""
    for name in "GDR":
        net = getattr(model, f"net{name}")
        net.load_state_dict(flax_to_torch(params[name], net))
        mu, nu = flax_to_torch(adam[name].mu, net), flax_to_torch(adam[name].nu, net)
        state = model.optimizers[name].state
        for key, p in net.named_parameters():
            if p in state:
                state[p]["step"].fill_(float(adam[name].count))
                state[p]["exp_avg"].copy_(mu[key])
                state[p]["exp_avg_sq"].copy_(nu[key])


def _in_biases(model) -> dict:
    """Per net, the biases of convolutions followed by instance norm."""
    g = [k for k in model.netG.state_dict() if k.endswith(".bias")
         and not k.startswith(f"Conv_{1 + model.netG.n_downsampling}.")]
    d = [f"Conv_{i}.bias" for i in range(1, model.netD.n_layers + 1)]
    r = [f"Conv_{i}.bias" for i in range(model.netR.n_convs - 1)]
    return {"G": set(g), "D": set(d), "R": set(r)}


def _check_grads(name, net, jgrads, skip) -> dict:
    """Hold the port's grads against JAX's; returns, per parameter, the
    elements whose gradient the two packages do not resolve (opposite signs,
    or apart by more than half its size): roundoff-level gradients, on
    which Adam's first update is ±lr either way."""
    ref = flax_to_torch(jgrads, net)
    unresolved, count, total = {}, 0, 0
    for key, p in net.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        want = ref[key]
        if key in skip:  # zero up to roundoff, relative to the conv's weight gradient
            scale = float(torch.linalg.vector_norm(ref[key.replace(".bias", ".weight")]))
            assert max(float(want.abs().max()), float(got.abs().max())) <= 1e-6 * scale, \
                (name, key, float(want.abs().max()), float(got.abs().max()), scale)
            continue
        if not torch.any(want):  # R frozen by its gate: exact zeros
            assert not torch.any(got), (name, key)
            continue
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert rel <= 1e-4, (name, key, rel)
        unresolved[key] = (got * want < 0) | ((got - want).abs() > 0.5 * want.abs())
        count += int(unresolved[key].sum())
        total += p.numel()
    assert count <= 2 + 1e-4 * total, (name, count, total)
    return unresolved


# max |m̂ / sqrt(v̂)| of Adam's t-th step over all gradient histories (1 at
# t = 1; 1.054 at t = 2 with b1 = 0.5): the smoke's bound, one copy
_adam_bound = chip_smoke.adam_bound


def _check_params(name, net, jparams, before, jbefore, skip, unresolved, lr):
    """Updated parameters within 1e-5; the IN-followed biases and the
    unresolved elements move by at most one Adam step in each package."""
    ref = flax_to_torch(jparams, net)
    bound = lr * (1 + 1e-3)
    for key, p in net.named_parameters():
        p = p.detach()
        if key in skip:
            assert float((p - before[key]).abs().max()) <= bound, (name, key)
            assert float((ref[key] - jbefore[key]).abs().max()) <= bound, (name, key)
            continue
        free = unresolved[key]
        assert float(torch.where(free, p - before[key], 0.0).abs().max()) <= bound, (name, key)
        assert float(torch.where(free, ref[key] - jbefore[key], 0.0).abs().max()) <= bound, \
            (name, key)
        err = float(torch.where(free, 0.0, p - ref[key]).abs().max())
        assert err <= 1e-5, (name, key, err)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_port_train_steps_match_jax(jax_setup, monkeypatch, tmp_path, recipe):
    root, jm, params, batches, cache, rec = jax_setup
    flags, attrs = RECIPES[recipe]
    for k, v in attrs.items():
        monkeypatch.setattr(jm, k, v)
    monkeypatch.setattr(jm, "tx", jm.tx)
    monkeypatch.setattr(jm, "tx_R", jm.tx_R)
    # the R gate is an argument of the step, not part of its trace
    key = tuple(sorted((k, str(v)) for k, v in attrs.items() if k != "stn_warmup"))
    jax_out = _jax_steps(jm, params, batches, cache, key, rec)

    model = create_model(_port_opt(tmp_path, *flags))
    for name, tree in params.items():
        net = getattr(model, f"net{name}")
        net.load_state_dict(flax_to_torch(tree, net))
    model.setup(model.opt)
    model.set_epoch(1)
    skip = _in_biases(model)
    for step, (batch, (losses, grads, new, _)) in enumerate(zip(batches, jax_out)):
        if step:  # from JAX's state after the first step (see the module doc)
            _load_jax_state(model, jax_out[step - 1][2], jax_out[step - 1][3])
        prev = params if step == 0 else jax_out[step - 1][2]
        jbefore = {n: flax_to_torch(prev[n], getattr(model, f"net{n}")) for n in "GDR"}
        before = {n: {k: v.detach().clone() for k, v in getattr(model, f"net{n}")
                      .named_parameters()} for n in "GDR"}
        model.set_input(batch)
        model.optimize_parameters()
        got = model.get_current_losses()
        assert list(got) == LOSSES
        for k in LOSSES:
            assert abs(got[k] - losses[k]) <= 1e-5 * abs(losses[k]) + 1e-9, (k, got[k], losses[k])
        assert set(grads) == ({"R"} if recipe == "freeze_g" else {"G", "D", "R"})
        unresolved = {n: {k: torch.zeros_like(p, dtype=torch.bool) for k, p in
                          getattr(model, f"net{n}").named_parameters()} for n in "GDR"}
        for name, tree in grads.items():
            unresolved[name].update(_check_grads(name, getattr(model, f"net{name}"), tree,
                                                 skip[name]))
        for name in "GDR":
            r_recipe = recipe == "stn_lr" and name == "R"
            lr = LR * (0.5 if r_recipe else 1.0) * _adam_bound(step + 1, 0.9 if r_recipe else 0.5)
            _check_params(name, getattr(model, f"net{name}"), new[name], before[name],
                          jbefore[name], skip[name], unresolved[name], lr)

    r_grads = [p.grad for p in model.netR.parameters()]
    assert all(g is not None for g in r_grads)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in r_grads)))
    if recipe == "stn_grad_clip":
        assert abs(norm - 0.001) <= 1e-7  # the clip engaged
    elif recipe == "stn_warmup_epochs":
        assert norm == 0.0
    else:
        # every R conv, the flow head included, has a gradient
        assert all(float(torch.linalg.vector_norm(p.grad)) > 0 for p in model.netR.parameters())


def test_zero_init_head_moves_by_lr(tmp_path):
    """A fresh R warps by the identity; its zero flow head still gets a
    gradient on step 1 and Adam moves every head weight by ~lr."""
    model = create_model(_port_opt(tmp_path))
    model.setup(model.opt)
    head = model.netR.heads()[-1]
    assert float(head.weight.abs().max()) == 0.0
    rng = np.random.default_rng(3)
    model.set_input({"A": rng.standard_normal((2, 32, 32, 1)).astype(np.float32),
                     "B": rng.standard_normal((2, 32, 32, 3)).astype(np.float32)})
    model.optimize_parameters()
    moved = head.weight.detach().abs()
    assert float(moved.max()) <= LR * (1 + 1e-3)
    assert float(moved.median()) > 0.5 * LR
    losses = model.get_current_losses()
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["G_smooth"] == 0.0  # identity field at the step's forward


def test_train_entry_point_writes_checkpoints_test_loads(tmp_path):
    args = [*SLICE, "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path / "ckpt"),
            "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1",
            "--print_freq", "2", "--display_freq", "2", "--lr_policy", "linear"]
    model = port_train.main(args)
    assert model.current_lr == 0.0  # linear decay over 0 extra epochs ends at 0
    ckpt = tmp_path / "ckpt" / "train"
    for suffix in ("1", "latest"):
        for net in "GDR":
            assert (ckpt / f"{suffix}_net_{net}.pth").exists()
    assert "G_recon" in (ckpt / "loss_log.txt").read_text()
    summary = port_test.main([*SLICE[:-2], "--gpu_ids", "-1", "--checkpoints_dir",
                              str(tmp_path / "ckpt"), "--results_dir", str(tmp_path / "res"),
                              "--epoch", "1", "--eval_registration", "--num_test", "2"])
    assert set(summary) >= {"ncc", "psnr", "l1"}
    assert all(np.isfinite(v) for v in summary.values())


@pytest.mark.parametrize("policy,want", [
    ("linear", [1.0, 1.0, 2 / 3, 1 / 3]), ("step", [1.0, 1.0, 0.1, 0.1]),
    ("cosine", [1.0, 0.5 * (1 + np.cos(np.pi / 4)), 0.5, 0.5 * (1 + np.cos(3 * np.pi / 4))]),
])
def test_lr_policies_match_jax(tmp_path, policy, want):
    opt = _port_opt(tmp_path, "--lr_policy", policy, "--n_epochs", "2", "--n_epochs_decay", "2",
                    "--lr_decay_iters", "2")
    from nemar_tpu_torch.models.networks import get_lr_multiplier_fn

    fn, jfn = get_lr_multiplier_fn(opt), jnetworks.get_lr_multiplier_fn(opt)
    got = [fn(e, None) for e in range(4)]
    np.testing.assert_allclose(got, [jfn(e, None) for e in range(4)], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_plateau_policy_is_fed_the_g_loss(tmp_path):
    model = create_model(_port_opt(tmp_path, "--lr_policy", "plateau"))
    model.setup(model.opt)
    from nemar_tpu_torch.models.networks import get_lr_multiplier_fn

    jfn = jnetworks.get_lr_multiplier_fn(model.opt)
    pfn = get_lr_multiplier_fn(model.opt)
    for metric in [5.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 3.0]:
        assert pfn(0, metric) == jfn(0, metric)
    assert pfn.state == jfn.state and pfn.state["mult"] == pytest.approx(0.2)
    model._losses = {"G": torch.tensor(7.5)}
    model.update_learning_rate(1)
    assert model.metric == 7.5 and model.lr_fn.state["best"] == 7.5
    assert all(g["lr"] == LR for o in model.optimizers.values() for g in o.param_groups)


def test_schedule_scalars(tmp_path):
    model = create_model(_port_opt(tmp_path, "--gan_warmup_epochs", "2", "--gan_ramp_epochs", "2",
                                   "--stn_warmup_epochs", "1", "--stn_ramp_epochs", "4"))
    gan, gate = [], []
    for epoch in range(1, 6):
        model.set_epoch(epoch)
        gan.append(model._gan_w_scalar())
        gate.append(model._r_gate_scalar())
    assert gan == [0.0, 0.0, 0.5, 1.0, 1.0]
    assert gate == [0.0, 0.25, 0.5, 0.75, 1.0]


def test_train_path_imports_no_jax(tmp_path):
    """The train entry point, a few steps and a save pull in no JAX and no
    module of the JAX package."""
    code = (
        "import sys\n"
        "from nemar_tpu_torch import train\n"
        f"train.main({[*SLICE, '--gpu_ids', '-1', '--checkpoints_dir', str(tmp_path), '--n_epochs', '1', '--n_epochs_decay', '0', '--save_epoch_freq', '1']!r})\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'nemar_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("flag,label", [
    (["--opt_fused"], "opt_fused"),
    (["--opt_split"], "opt_split"),
])
def test_unported_train_flags_raise(tmp_path, flag, label):
    """--opt_fused and --opt_split were refused as TPU-only Adam layouts
    until the port took them: the JAX package's flat-bucket Adam is the
    same elementwise math (``nemar_tpu/models/optim.py``), here torch's
    multi-tensor Adam (``foreach``). Two steps with the flag equal two
    without it bit for bit (parameters and Adam moments); --opt_split keeps
    the JAX package's two refusals, word for word."""
    rng = np.random.default_rng(9)
    batches = [{"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
                "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)} for _ in range(2)]
    models = []
    for extra in ([], flag):
        model = create_model(_port_opt(tmp_path / label / str(len(extra)), *extra))
        model.setup(model.opt)
        model.set_epoch(1)
        for batch in batches:
            model.set_input(batch)
            model.optimize_parameters()
        models.append(model)
    plain, fused = models
    assert all(o.defaults["foreach"] is True for o in fused.optimizers.values())
    for n in "GDR":
        for (k, p), q in zip(plain.nets()[n].named_parameters(), fused.nets()[n].parameters()):
            assert torch.equal(p, q), (n, k)
            if p not in plain.optimizers[n].state:  # an inert bias: no gradient, no state
                assert q not in fused.optimizers[n].state
                continue
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(plain.optimizers[n].state[p][m],
                                   fused.optimizers[n].state[q][m]), (n, k, m)
    if flag == ["--opt_split"]:
        with pytest.raises(ValueError, match=r"--opt_split is per-step \(two programs\); "
                                             r"incompatible with --steps_per_execution > 1"):
            create_model(_port_opt(tmp_path / "spe", *flag, "--steps_per_execution", "2"))
        with pytest.raises(ValueError, match="--opt_split is incompatible with --grad_accum > 1"):
            create_model(_port_opt(tmp_path / "acc", *flag, "--grad_accum", "2"))


def test_opt_fused_step_matches_jax_float64(tmp_path):
    """One --opt_fused step of the port against the JAX package's
    (``make_adam(fused=True)``: Adam over flat buckets), both in float64
    from the same parameters and numpy batch: losses and gradients within
    1e-9, parameters within 1e-10 (``test_torch_model_families``'s
    ``_hold_losses`` and ``_hold_step``)."""
    import test_torch_model_families as fam
    import test_torch_nemar_pallas_all as pa

    flags = [*fam.NEMAR_BATCH[:2], *fam.NEMAR_BATCH[4:], "--opt_fused"]
    jm = fam._jax_model(tmp_path, flags)
    assert len(jm.tx.init({"a": jnp.zeros(3)})) == 1  # flat buckets
    rng = np.random.default_rng(14)
    params = {n: fam._draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    rec = []
    jm.tx, jm.tx_R = _recording(jm.tx, "GD", rec), _recording(jm.tx_R, "R", rec)
    batch = {k: rng.uniform(-1, 1, (2, 32, 32, c)).astype(np.float32)
             for k, c in (("A", 1), ("B", 3))}
    with pa.jax_float64():
        p = {n: fam._f64(t) for n, t in params.items()}
        state = fam._one_device(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])))
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, jnp.asarray(batch["A"], jnp.float64), jnp.asarray(batch["B"], jnp.float64),
            jnp.float64(LR), jm._gan_w_scalar(), jm._r_gate_scalar())
        jax.block_until_ready(state)
    grads = {}
    for tag, t in rec:
        grads["R" if tag == "R" else ("G" if "ResnetBlock_0" in t["params"] else "D")] = t
    model = create_model(TrainOptions().parse(
        [*flags, "--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
         str(tmp_path / "port")]))
    model.to_dtype(torch.float64)
    starts = {n: flax_to_torch(params[n], model.nets()[n], torch.float64) for n in "GDR"}
    for n in "GDR":
        model.nets()[n].load_state_dict(starts[n])
    model.setup(model.opt)
    model.set_epoch(1)
    model.set_input(batch)
    model.optimize_parameters()
    fam._hold_losses(dict(model.get_current_losses()),
                     {k: float(metrics[k]) for k in model.loss_names})
    for n in "GDR":
        fam._hold_step(n, model.nets()[n], grads[n],
                       jax.device_get(getattr(state, f"params_{n}")), starts[n], 1)


def test_vanilla_gan_loss_matches_jax():
    pred = np.random.default_rng(4).standard_normal((2, 1, 3, 3)).astype(np.float32) * 3
    from nemar_tpu_torch.models.networks import gan_loss

    for real in (True, False):
        for mode in ("lsgan", "vanilla"):
            got = float(gan_loss(torch.from_numpy(pred), real, mode))
            want = float(jnetworks.gan_loss(jnp.asarray(pred), real, mode))
            assert abs(got - want) <= 1e-6 * abs(want), (mode, real)
