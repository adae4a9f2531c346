"""``--bf16`` on the port against the JAX package's ``--bf16``, on the CPU.

The JAX package's bf16 is bfloat16 compute with fp32 parameters
(``nemar_tpu/models/nemar_model.py:_cast``). Here both packages run the same
functions from the same weights (``utils/convert.py``) and the same numpy
inputs, in fp32 and in bf16, JAX with its default ``--block_impl xla``. For
every compared tensor T let

    e = max|T_jax,bf16 - T_jax,fp32| / max|T_jax,fp32|,

JAX's own bf16 error. Each T is held to

    (a) max|T_port,bf16 - T_jax,bf16| / max|T_jax,fp32| <= 2 e + 1e-6
        (the two bf16 runs agree as closely as bf16 lets each of them
        agree with fp32), and
    (b) max|T_port,bf16 - T_port,fp32| >= e / 4
        (the port's bf16 run computes in bf16: a port that ignored --bf16
        would give 0 here).

A scalar (a loss, reg) or a tensor of a few elements (an output layer's
bias gradient) is one draw of bf16's rounding noise, and its e can come
out far below that noise by luck (the default step's D_real: 1.5e-5,
while D's predictions move by 2.6% of their size). For these e is taken
as at least Q = 2^-8, bf16's relative spacing, in (a), and at most Q in
(b); and a step's seven losses are held to (b) together, by the largest
of their seven ratios (one of them, rounded to bf16 at the end, can land
on fp32's value by the same luck).

Cases: the plain versions of K-block, K-convt and K-in at bf16 (the CPU
path of ``fused_resblock``, ``fused_convt_in``, ``instance_norm_act``)
against ``nemar_tpu.ops.conv_fused.fused_resblock`` (the TPU kernels B1f
and B1b in interpret mode: ``resblock_reference``'s conv, with its fp32
preferred type, has no transpose at bf16),
``nemar_tpu.ops.attic.convt_fused.convt_in_reference`` and
``nemar_tpu.ops.norm.instance_norm_act`` (its Pallas kernel in interpret
mode, with its analytic VJP), forward and VJP; the NeMAR model's test path
(every output and the flow of one batch); one default-recipe step (the
seven losses and every parameter's gradient) and one step of
``--gan_mode wgangp --grad_accum 2 --ema_decay 0.999`` (JAX's penalty
draws fed to the port), with the parameters after each within 2 lr of
JAX's (an Adam step is at most lr: a gradient element near 0 may take it
either way). The biases of convolutions followed by an instance norm have
a gradient of roundoff in both packages and are held only to be small.

Then the dtypes: parameters, gradients, Adam's moments, the EMA shadows
and the image pool stay fp32, the grid is fp32, and every convolution and
dense layer inside G, R and D computes in bf16.

The model: ResNet-6 G at ngf 8, ndf 8, depth-3 UNet STN at stn_ngf 8,
32^2, batch 2. JAX compiles two programs, one per dtype, each holding the
test path and both recipes' steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_a5_step as a5
import test_torch_nemar_pallas_all as pa
import test_torch_nemar_train as tt
from nemar_tpu.data.synthetic_dataset import SyntheticDataset
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.ops import norm as jax_norm
from nemar_tpu.ops.attic.convt_fused import convt_in_reference
from nemar_tpu.ops.conv_fused import fused_resblock as jax_fused_resblock
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.parallel import replicate
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.ops.conv_fused import fused_resblock
from nemar_tpu_torch.ops.convt_fused import fused_convt_in
from nemar_tpu_torch.ops.norm import instance_norm_act
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

BF16 = torch.bfloat16
SLICE = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "bf16",
         "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3", "--synthetic_size", "2", "--batch_size", "2",
         "--bf16"]
A5 = ["--gan_mode", "wgangp", "--grad_accum", "2", "--ema_decay", "0.999"]
RECIPES = {"default": [], "a5": A5}
OUTPUTS = ["fake_B", "reg_fakeB", "warped_A", "fake_B2", "flow", "reg"]


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else t,
                      dtype=np.float64)


# bf16's relative spacing: the noise floor of a scalar's e (module doc)
Q = 2.0**-8
# a tensor of at most this many elements is held as a scalar
FEW = 8


def held(name, port16, port32, jax16, jax32, check_b=True) -> tuple:
    """(a) and, with ``check_b``, (b) of the module's doc for one tensor,
    with Q's floor for a scalar or a tensor of at most FEW elements; a
    tensor that is 0 in JAX's fp32 run (a gradient zero by symmetry) must be
    0 in the port's bf16 run. Returns (e, b, the bound (b) uses)."""
    p16, p32, j16, j32 = map(_np, (port16, port32, jax16, jax32))
    scale = float(np.abs(j32).max())
    if scale == 0:
        assert not np.any(j16) and not np.any(p16), f"{name}: not 0 as in JAX's fp32 run"
        return 0.0, 0.0, 0.0
    e = float(np.abs(j16 - j32).max()) / scale
    a = float(np.abs(p16 - j16).max()) / scale
    b = float(np.abs(p16 - p32).max()) / scale
    few = p16.size <= FEW
    ea, eb = (max(e, Q), min(e, Q)) if few else (e, e)
    assert a <= 2 * ea + 1e-6, f"{name}: port vs JAX at bf16 {a:.3g} > 2 e, e = {ea:.3g}"
    if check_b:
        assert b >= eb / 4, f"{name}: port bf16 vs fp32 {b:.3g} < e / 4, e = {eb:.3g}"
    return e, b, eb / 4


# ---------------------------------------------------------------------------
# the kernels' plain versions at bf16
# ---------------------------------------------------------------------------


def _port_vjp(fn, inputs, g, dtype):
    """(output, gradients) of the port's op at ``dtype``, from numpy."""
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in inputs]
    out = fn(*ts)
    out.backward(torch.tensor(g).to(dtype))
    return out, [t.grad for t in ts]


def _jax_vjp(fn, inputs, g, dtype):
    ins = [jnp.asarray(a, dtype) for a in inputs]
    out, vjp = jax.vjp(fn, *ins)
    return out, vjp(jnp.asarray(g, dtype))


OPS = {
    "K-block": (lambda x, w1, w2: fused_resblock(x, w1, w2),
                jax_fused_resblock,
                [(1, 8, 8, 128), (3, 3, 128, 128), (3, 3, 128, 128)], (1, 8, 8, 128)),
    "K-convt": (lambda x, w: fused_convt_in(x, w),
                lambda x, w: convt_in_reference(x, w),
                [(2, 5, 4, 16), (3, 3, 16, 8)], (2, 10, 8, 8)),
    "K-in": (lambda x: instance_norm_act(x, "leaky_relu"),
             lambda x: jax_norm.instance_norm_act(x, "leaky_relu", impl="pallas"),
             [(2, 7, 6, 12)], (2, 7, 6, 12)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_kernel_plain_versions_at_bf16_match_jax(op):
    """Each kernel's plain version at bf16 (its CPU path, forward and
    backward) against the JAX function at bf16, by (a) and (b)."""
    port_fn, jax_fn, shapes, out_shape = OPS[op]
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal(s).astype(np.float32) * (0.05 if i else 1.0)
              for i, s in enumerate(shapes)]
    g = rng.standard_normal(out_shape).astype(np.float32)
    p16 = _port_vjp(port_fn, inputs, g, BF16)
    p32 = _port_vjp(port_fn, inputs, g, torch.float32)
    j16 = _jax_vjp(jax_fn, inputs, g, jnp.bfloat16)
    j32 = _jax_vjp(jax_fn, inputs, g, jnp.float32)
    assert p16[0].dtype == BF16 and all(t.dtype == BF16 for t in p16[1])
    held(f"{op} forward", p16[0], p32[0], j16[0], j32[0])
    for i in range(len(inputs)):
        held(f"{op} d input {i}", p16[1][i], p32[1][i], j16[1][i], j32[1][i])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _port_model(root, name, dtype_flags, recipe, params):
    argv = [*SLICE, *RECIPES[recipe], "--gpu_ids", "-1", "--checkpoints_dir",
            str(root / "port" / f"{recipe}_{name}")]
    model = create_model(TrainOptions().parse([a for a in argv if a not in dtype_flags]))
    for n, tree in params.items():
        net = getattr(model, f"net{n}")
        net.load_state_dict(flax_to_torch(tree, net))
    model.setup(model.opt)
    model.set_epoch(1)
    return model


# the JAX model's attributes each recipe's step reads at trace time
JAX_RECIPE_ATTRS = {"default": {"gan_mode": "lsgan", "grad_accum": 1, "ema_decay": 0.0},
                    "a5": {"gan_mode": "wgangp", "grad_accum": 2, "ema_decay": 0.999}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs: per dtype, the test path's outputs on the first batch
    and each recipe's step on it (losses, recorded gradients, parameters,
    EMA shadows, the penalty's alphas); the params and the batch. One JAX
    model (its init is most of the set-up) takes both recipes: their
    attributes are set while the program is traced."""
    root = tmp_path_factory.mktemp("bf16")
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--checkpoints_dir",
                                    str(root / "jax"), *SLICE, *A5])
    jm = jax_create_model(jopt)
    jm.setup(jopt)
    tx, tx_r = jm.tx, jm.tx_R
    recs = {recipe: [] for recipe in RECIPES}
    rng = np.random.default_rng(0)
    params = {n: pa._redraw_biases(jax.device_get(getattr(jm.state, f"params_{n}")), rng)
              for n in "GDR"}
    head = params["R"]["params"][f"Conv_{len(params['R']['params']) - 1}"]
    head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    ds = SyntheticDataset(jopt)
    batch = {k: np.stack([ds[i][k] for i in range(2)]) for k in ("A", "B")}
    jm.set_input(batch)
    a, b = jm.real_A, jm.real_B
    p = {n: jax.tree.map(jnp.asarray, t) for n, t in params.items()}
    states, draws = {}, {}
    for recipe, attrs in JAX_RECIPE_ATTRS.items():
        states[recipe] = replicate(jm.state.replace(
            step=jnp.zeros((), jnp.int32), params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": tx.init(p["G"]), "R": tx_r.init(p["R"])},
            opt_D=tx.init(p["D"]), rng=jax.random.key(a5.SEED),
            ema=(jax.tree.map(jnp.copy, {"G": p["G"], "R": p["R"]})
                 if attrs["ema_decay"] > 0 else None)), jm.mesh)
        draws[recipe] = a5._jax_draws(states[recipe].rng, 2, attrs["grad_accum"], False,
                                      b.dtype)[2]

    def program(st_default, st_a5):
        out = jm._forward_all(st_default, a, b)
        steps = {}
        for (recipe, attrs), st in zip(JAX_RECIPE_ATTRS.items(), (st_default, st_a5)):
            for k, v in attrs.items():
                setattr(jm, k, v)
            jm.tx = tt._recording(tx, "GD", recs[recipe])
            jm.tx_R = tt._recording(tx_r, "R", recs[recipe])
            steps[recipe] = jm._train_step_impl(st, a, b, jnp.float32(tt.LR), jm._gan_w_scalar(),
                                                jm._r_gate_scalar())
        return out, steps

    result = {}
    for dtype, bf16 in (("fp32", False), ("bf16", True)):
        jm.bf16 = bf16
        for rec in recs.values():
            rec.clear()
        # a fresh function per dtype: jit caches by the function
        out, steps = jax.jit(lambda s1, s2: program(s1, s2))(states["default"], states["a5"])
        jax.block_until_ready(steps)
        per = {"out": {k: np.asarray(v) for k, v in out.items()}}
        for recipe, (state, metrics) in steps.items():
            grads = {}
            for tag, tree in recs[recipe]:
                key = "R" if tag == "R" else ("G" if "ResnetBlock_0" in tree["params"] else "D")
                grads.setdefault(key, []).append(tree)
            assert all(len(v) == 1 for v in grads.values()), "one update per net and step"
            per[recipe] = ({k: float(v) for k, v in metrics.items()},
                           {k: v[0] for k, v in grads.items()},
                           {n: jax.device_get(getattr(state, f"params_{n}")) for n in "GDR"},
                           jax.device_get(state.ema))
        result[dtype] = per
    return root, params, batch, draws, result


def _port_run(root, params, batch, draws, recipe, dtype):
    """The port's model of the recipe at ``dtype`` ('fp32' or 'bf16'): its
    test-path outputs (default recipe) and one step."""
    model = _port_model(root, dtype, ["--bf16"] if dtype == "fp32" else [], recipe, params)
    model.set_input(batch)
    out = None
    if recipe == "default":
        with torch.no_grad():
            out = model._forward_parts(model.real_A, model.real_B)
    model._gp_alpha = lambda n, it=iter(draws[recipe]): next(it)
    model.optimize_parameters()
    return model, out


def _nhwc(key, t):
    """The port's output ``key`` in the JAX layout: images NCHW -> NHWC."""
    return t if key in ("flow", "reg") else t.permute(0, 2, 3, 1)


def test_test_path_matches_jax_bf16(runs):
    """Every output of the test path and the flow, from one batch."""
    root, params, batch, draws, jx = runs
    got = {d: _port_run(root, params, batch, draws, "default", d)[1] for d in ("fp32", "bf16")}
    for k in OUTPUTS:
        held(k, _nhwc(k, got["bf16"][k]), _nhwc(k, got["fp32"][k]), jx["bf16"]["out"][k],
             jx["fp32"]["out"][k])
        assert got["bf16"][k].dtype == torch.float32, k


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_step_matches_jax_bf16(runs, recipe):
    """One step of the recipe: the losses and every parameter's gradient by
    (a) and (b), the parameters after it within 2 lr of JAX's bf16 step,
    the EMA shadows (a5) likewise. Both start from the same parameters and
    a first Adam step moves an element by at most about lr, so those two
    bounds guard only against gross errors. The update itself is held
    elementwise where the gradient's sign lies above bf16's noise (|g| >
    (4 e + 1e-6) of the largest, e the tensor's JAX bf16-vs-fp32 error, as
    (a) bounds the port's bf16 gradient to 2 e of JAX's, and > 1e-4): there
    a first Adam step moves the element by lr x lr_ratio x g / (|g| + 1e-8)
    in both packages, so the two updates agree within 1% of lr x lr_ratio;
    every net has such elements."""
    root, params, batch, draws, jx = runs
    ports = {d: _port_run(root, params, batch, draws, recipe, d)[0] for d in ("fp32", "bf16")}
    (l16, g16, new16, ema16), (l32, g32, _, _) = jx["bf16"][recipe], jx["fp32"][recipe]
    got16, got32 = (ports[d].get_current_losses() for d in ("bf16", "fp32"))
    b_losses = [held(f"loss {k}", got16[k], got32[k], l16[k], l32[k], check_b=False)
                for k in l16]
    assert max(b for _, b, _ in b_losses) >= max(bound for _, _, bound in b_losses), b_losses
    if recipe == "a5":
        assert "D_gp" in got16
    skip = tt._in_biases(ports["bf16"])
    model = ports["bf16"]
    held_updates = {}
    # 2 lr, and the parameters' own fp32 roundoff
    bound = 2 * tt.LR * (1 + 1e-6) + 1e-7
    for n in "GDR":
        net16, net32 = getattr(model, f"net{n}"), getattr(ports["fp32"], f"net{n}")
        ref16, ref32 = flax_to_torch(g16[n], net16), flax_to_torch(g32[n], net16)
        p32 = dict(net32.named_parameters())
        ref_new = flax_to_torch(new16[n], net16)
        before = flax_to_torch(params[n], net16)
        ratio = model.optimizers[n].param_groups[0]["lr_ratio"]
        held_updates[n] = 0
        for key, p in net16.named_parameters():
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            assert p.dtype == grad.dtype == torch.float32, (n, key)
            if key in skip[n]:  # roundoff: small beside the conv's weight gradient
                w = float(ref32[key.replace(".bias", ".weight")].abs().max())
                assert float(grad.abs().max()) <= 0.05 * w, (n, key)
            else:
                held(f"grad {n}.{key}", grad, p32[key].grad, ref16[key], ref32[key])
            err = float((p.detach() - ref_new[key]).abs().max())
            assert err <= bound * ratio, (n, key, err)
            scale = float(ref32[key].abs().max())
            if key in skip[n] or scale == 0:
                continue
            e = float((ref16[key] - ref32[key]).abs().max()) / scale
            sure = (ref32[key].abs() > (4 * e + 1e-6) * scale) & (ref32[key].abs() > 1e-4)
            step, ref_step = p.detach() - before[key], ref_new[key] - before[key]
            off = float((step - ref_step)[sure].abs().max()) if sure.any() else 0.0
            assert off <= 0.01 * tt.LR * ratio, (n, key, off)
            held_updates[n] += int(sure.sum())
    assert all(held_updates.values()), held_updates
    if recipe == "a5":
        for n in "GR":
            ref = flax_to_torch(ema16[n], getattr(model, f"net{n}"))
            for key, shadow in model.ema[n].items():
                assert shadow.dtype == torch.float32
                # the shadow moves by (1 - decay) of the parameter's step
                assert float((shadow - ref[key]).abs().max()) <= bound * 1e-3 + 1e-7, (n, key)


def test_dtypes_under_bf16(tmp_path):
    """Parameters, gradients, Adam's moments, EMA shadows and the pool stay
    fp32; the grid is fp32; every module of G, R and D that runs (each
    conv and dense layer called as a module, each trunk block, the nets
    themselves) computes in bf16 (forward hooks on the port's modules,
    through the bf16 copies the model calls them with)."""
    argv = [*SLICE, *A5, "--pool_size", "2", "--gpu_ids", "-1",
            "--checkpoints_dir", str(tmp_path)]
    model = create_model(TrainOptions().parse(argv))
    model.setup(model.opt)
    seen = {}
    def record(key):
        def hook(mod, args, out):
            for t in out if isinstance(out, tuple) else (out,):
                if isinstance(t, torch.Tensor):
                    seen.setdefault(key, set()).add(t.dtype)
        return hook

    hooks = [mod.register_forward_hook(record(f"{n}.{name}"))
             for n, net in model.nets().items() for name, mod in net.named_modules()]
    rng = np.random.default_rng(1)
    batch = {"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
             "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}
    for _ in range(2):
        model.set_input(batch)
        model.optimize_parameters()
    for h in hooks:
        h.remove()
    # every module but those whose weights the fused ops take (the trunk
    # blocks' convs, the transposed convs, G's head) runs as a module;
    # the WGAN-GP penalty's pass runs D in fp32, as the JAX package's
    g_weights_only = ("ConvTranspose_0", "ConvTranspose_1", "Conv_3")
    want = {f"{n}.{name}" for n, net in model.nets().items() for name, _ in net.named_modules()
            if not (n == "G" and (name.startswith("ResnetBlock_") and "." in name
                                  or name in g_weights_only))}
    assert set(seen) == want, want ^ set(seen)
    assert all(BF16 in dts for dts in seen.values()), seen
    assert all(seen[k] == {BF16} for k in seen if not k.startswith("D")), seen
    for n, net in model.nets().items():
        for key, p in net.named_parameters():
            assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        for st in model.optimizers[n].state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for s in model.ema.values() for v in s.values())
    assert model.pool[0].dtype == torch.float32 and int(model.pool[1]) == 2
    ca, cb = model.cast(model.real_A), model.cast(model.real_B)
    with torch.no_grad():
        (warped,), reg, aux = model.compute(model.netR)(ca, cb, (ca,))
    assert aux["grid"].dtype == torch.float32
    assert aux["flow"].dtype == warped.dtype == reg.dtype == BF16


def test_science_recipe_takes_bf16_at_256():
    """``nemar_tpu_torch.science --bf16`` adds ``--bf16`` at res >= 256, as
    ``scripts/science_final.py`` does on a TPU; below 256, and by default,
    the recipe stays fp32."""
    from nemar_tpu_torch.science import parse_args, recipe_flags

    for argv, want in ((["120", "20", "20", "0", "256", "unet", "fresh", "--bf16"], True),
                       (["120", "20", "20", "0", "256", "unet", "fresh"], False),
                       (["45", "10", "15", "0", "64", "unet", "--bf16"], False)):
        r = parse_args(argv)
        assert ("--bf16" in recipe_flags(r, 0)) == want, argv
        assert r.tag.endswith("_bf16") == want


def test_inference_keeps_bf16_copies_until_a_parameter_changes(tmp_path):
    """Without autograd ``compute`` makes a net's bf16 copies once and
    reuses them, with the outputs of a fresh cast; an in-place change of a
    parameter (an optimizer step, a load) makes new ones; a call with
    autograd casts anew and keeps nothing."""
    argv = [*SLICE, "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path)]
    model = create_model(TrainOptions().parse(argv))
    model.setup(model.opt)
    x = model.cast(torch.from_numpy(
        np.random.default_rng(4).uniform(-1, 1, (1, 1, 32, 32)).astype(np.float32)))
    fresh = model.compute(model.netG)(x)
    assert model._bf16_copies == {}
    with torch.no_grad():
        out = model.compute(model.netG)(x)
        kept = model._bf16_copies[model.netG][1]
        model.compute(model.netG)(x)
        assert model._bf16_copies[model.netG][1] is kept
        torch.testing.assert_close(out, fresh.detach(), rtol=0, atol=0)
        p = next(model.netG.parameters())
        p.add_(1.0)
        model.compute(model.netG)(x)
        again = model._bf16_copies[model.netG][1]
    assert again is not kept
    torch.testing.assert_close(again[next(iter(again))], p.to(BF16), rtol=0, atol=0)
