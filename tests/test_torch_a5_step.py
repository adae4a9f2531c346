"""The rest of the JAX training step on the port (ROADMAP.md A5), one feature
at a time, against the JAX package from carried weights.

A JAX ``nemar`` model (ResNet-6 G at ngf 8, depth-3 UNet STN at stn_ngf 8,
ndf 8, 32^2, batch 2) with one recipe's flags gets non-zero biases and a
non-zero flow head; the same parameters go through ``flax_to_torch`` into
the port's model on the CPU. Both take the recipe's steps from fresh Adam
states on the same synthetic batches, in float64, as
``test_torch_nemar_pallas_all.py`` holds a step (it says why: two float32
runs of the step do not share every relu mask and L1 sign): the seven
losses and every gradient (JAX's where it hands them to optax) within
1e-9, the parameters after each step within 1e-10, the IN-followed biases
by that file's stated exception (a gradient of roundoff, an Adam step of
at most lr either way). The recipes:

  * ``--grad_accum 2``: ``_train_step_accum``, two microbatches of one;
  * ``--pool_size 4``: the pool starts full of seeded images in both
    packages, the port is fed JAX's draws (``jax.random.split`` of the
    state's key, ``bernoulli``, ``randint``), and at least one swap hands D
    an old image; the buffer and count after the step are equal;
  * ``--gan_mode wgangp``: the penalty's alpha is JAX's draw, fed to the
    port; the port's ``D_gp`` is JAX's D - (D_real + D_fake) / 2;
  * ``--ema_decay 0.5``: two steps; the port's shadows equal JAX's
    ``state.ema`` (carried by ``flax_to_torch``) after each.
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
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.parallel import replicate
from nemar_tpu.utils.image_pool import PoolState
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

SLICE = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "a5",
         "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3", "--synthetic_size", "4", "--batch_size", "2"]
# recipe: (flags, steps)
RECIPES = {
    "grad_accum": (["--grad_accum", "2"], 1),
    "pool": (["--pool_size", "4"], 1),
    "wgangp": (["--gan_mode", "wgangp"], 1),
    "ema": (["--ema_decay", "0.5"], 2),
}
POOL = 4
SEED = 17  # the JAX state's key: jax.random.key(--seed + 17)


def _jax_draws(key, n, k, pool, alpha_dtype):
    """The draws of one JAX step from the state's key: (the next key, the
    pool's (use_old, rand_idx) per microbatch, alpha per microbatch)."""
    nxt, r_pool, r_gp = jax.random.split(key, 3)
    pools = [r_pool] if k == 1 else list(jax.random.split(r_pool, k))
    gps = [r_gp] if k == 1 else list(jax.random.split(r_gp, k))
    m = n // k
    draws = []
    for rp in pools if pool else ():
        r_choice, r_idx = jax.random.split(rp)
        draws.append((torch.tensor(np.asarray(jax.random.bernoulli(r_choice, 0.5, (m,)))),
                      torch.tensor(np.asarray(jax.random.randint(r_idx, (m,), 0, POOL)),
                                   dtype=torch.int64)))
    alphas = [torch.tensor(np.asarray(jax.random.uniform(rg, (m, 1, 1, 1), alpha_dtype)))
              for rg in gps]
    return nxt, draws, alphas


def _jax_run(root, recipe):
    """The recipe's JAX steps in float64: (redrawn params, batches, the
    pool's start, per step (losses, grads, params, ema, pool, draws))."""
    flags, steps = RECIPES[recipe]
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--checkpoints_dir",
                                    str(root / "jax"), *SLICE, *flags])
    rng = np.random.default_rng(5)
    ds = SyntheticDataset(jopt)
    items = [ds[i] for i in range(2 * steps)]
    batches = [{k: np.stack([it[k] for it in items[j:j + 2]]) for k in ("A", "B")}
               for j in range(0, 2 * steps, 2)]
    pool0 = rng.uniform(-1, 1, (POOL, 32, 32, 3))
    rec, out = [], []
    with pa.jax_float64():
        jm = jax_create_model(jopt)
        jm.setup(jopt)
        params = {n: pa._redraw_biases(jax.device_get(getattr(jm.state, f"params_{n}")), rng)
                  for n in "GDR"}
        head = params["R"]["params"][f"Conv_{len(params['R']['params']) - 1}"]
        head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
        jm.tx, jm.tx_R = tt._recording(jm.tx, "GD", rec), tt._recording(jm.tx_R, "R", rec)
        p = {n: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t) for n, t in params.items()}
        state = replicate(jm.state.replace(
            step=jnp.zeros((), jnp.int32), params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"]), rng=jax.random.key(SEED),
            pool=PoolState(jnp.asarray(pool0), jnp.int32(POOL)) if recipe == "pool" else None,
            ema=jax.tree.map(jnp.copy, {"G": p["G"], "R": p["R"]}) if recipe == "ema" else None),
            jm.mesh)
        step = jax.jit(lambda *args: jm._train_step_impl(*args))
        for batch in batches:
            jm.set_input(batch)
            # float64 inputs: JAX draws alpha in real_B's dtype, and an fp32
            # alpha * real would round where the port's float64 does not
            jm.real_A, jm.real_B = jm.real_A.astype(jnp.float64), jm.real_B.astype(jnp.float64)
            _, draws, alphas = _jax_draws(state.rng, 2, jm.grad_accum, recipe == "pool",
                                          jm.real_B.dtype)
            rec.clear()
            state, metrics = step(state, jm.real_A, jm.real_B, jnp.float64(tt.LR),
                                  jm._gan_w_scalar(), jm._r_gate_scalar())
            jax.block_until_ready(state)
            grads = {}
            for tag, tree in rec:
                grads["R" if tag == "R" else ("G" if "ResnetBlock_0" in tree["params"]
                                              else "D")] = tree
            out.append(({k: float(v) for k, v in metrics.items()}, grads,
                        {n: jax.device_get(getattr(state, f"params_{n}")) for n in "GDR"},
                        jax.device_get(state.ema),
                        None if state.pool is None else
                        (np.asarray(state.pool.images), int(state.pool.count)),
                        (draws, alphas)))
    return params, batches, pool0, out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_a5_step_matches_jax(tmp_path, recipe):
    params, batches, pool0, jax_out = _jax_run(tmp_path, recipe)
    flags, steps = RECIPES[recipe]
    model = create_model(TrainOptions().parse([*SLICE, "--gpu_ids", "-1", "--checkpoints_dir",
                                               str(tmp_path / "port"), *flags]))
    for name, tree in params.items():
        net = getattr(model, f"net{name}").double()
        net.load_state_dict(flax_to_torch(tree, net, pa.F64))
    model.setup(model.opt)
    model.set_epoch(1)
    if recipe == "pool":
        model.pool = (_nchw(pool0), torch.tensor(POOL))
    skip = tt._in_biases(model)
    bound = tt.LR * (1 + 1e-6) * tt._adam_bound(steps, 0.5)
    start = {n: flax_to_torch(params[n], getattr(model, f"net{n}"), pa.F64) for n in "GDR"}
    for batch, (losses, grads, new, ema, pool, (draws, alphas)) in zip(batches, jax_out):
        model._pool_draws = lambda n, it=iter(draws): next(it)
        model._gp_alpha = lambda n, it=iter(alphas): next(it)
        model.set_input(batch)
        model.real_A, model.real_B = model.real_A.double(), model.real_B.double()
        model.optimize_parameters()
        got = model.get_current_losses()
        for k in tt.LOSSES:
            assert abs(got[k] - losses[k]) <= pa.TOL64 * abs(losses[k]) + 1e-15, \
                (k, got[k], losses[k])
        if recipe == "wgangp":
            gp = losses["D"] - 0.5 * (losses["D_real"] + losses["D_fake"])
            assert gp > 0 and abs(got["D_gp"] - gp) <= pa.TOL64 * abs(losses["D"]), (got, gp)
        else:
            assert "D_gp" not in got
        assert set(grads) == {"G", "D", "R"}
        for name in "GDR":
            net = getattr(model, f"net{name}")
            ref_g = flax_to_torch(grads[name], net, pa.F64)
            ref_p = flax_to_torch(new[name], net, pa.F64)
            for key, p in net.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if key in skip[name]:  # zero up to roundoff (see the module's doc)
                    scale = float(torch.linalg.vector_norm(ref_g[key.replace(".bias", ".weight")]))
                    assert max(float(ref_g[key].abs().max()), float(g.abs().max())) \
                        <= pa.TOL64 * scale, (name, key)
                    assert float((p.detach() - start[name][key]).abs().max()) <= bound
                    assert float((ref_p[key] - start[name][key]).abs().max()) <= bound
                    continue
                if not torch.any(ref_g[key]):  # wgangp's D_real + D_fake: D's last bias
                    assert not torch.any(g), (name, key)
                else:
                    assert pa._rel(g, ref_g[key]) <= pa.TOL64, (name, key,
                                                               pa._rel(g, ref_g[key]))
                err = float((p.detach() - ref_p[key]).abs().max())
                assert err <= 1e-10, (name, key, err)
        if recipe == "ema":
            for name in "GR":
                net = getattr(model, f"net{name}")
                ref = flax_to_torch(ema[name], net, pa.F64)
                for key, shadow in model.ema[name].items():
                    err = float((shadow - ref[key]).abs().max())
                    limit = bound if key in skip[name] else 1e-10
                    assert err <= limit, (name, key, err)
        if recipe == "pool":
            images, count = model.pool
            assert int(count) == pool[1] == POOL
            np.testing.assert_allclose(images.permute(0, 2, 3, 1).numpy(), pool[0], rtol=0,
                                       atol=1e-10)
            swaps = [bool(u) for u, idx in zip(*draws[0]) if u]
            assert swaps, "the draw swaps nothing: the pool's path to D is not reached"
    if recipe == "grad_accum":
        assert model.grad_accum == 2 and len(jax_out[0][5][1]) == 2
    names = tt.LOSSES[:3] + ["D_gp"] + tt.LOSSES[3:] if recipe == "wgangp" else tt.LOSSES
    assert list(model.get_current_losses()) == names
