"""``--steps_per_execution k`` on the port (ROADMAP.md A9b): the NeMAR
model's ``optimize_parameters_scan``, the train loop's chunks and the
refusals of the other models.

  * In float64, the port's chunk of 4 and then a tail of 2 against the JAX
    package's ``optimize_parameters_scan`` from the same parameters and
    fresh Adam states (lsgan, ``--pool_size 0``): every parameter within
    1e-10 after the 6 steps (the biases a norm follows, whose gradient is
    roundoff in both packages, within 1.1 lr a step of their start, as
    ``test_torch_model_families.py`` holds them), the step count, and the
    mean losses of each chunk within 1e-9 relative.
  * With the pool (pre-filled, so steps swap), WGAN-GP, EMA and
    ``--grad_accum 2``, in fp32: the chunk equals as many
    ``optimize_parameters`` calls bit for bit (parameters, Adam's state,
    the shadows, the pool, the CPU generator's state), its losses the
    means of theirs, real_A and real_B the last batch.
  * ``train._train_epochs`` with spe 4 fires its periodic actions where the
    JAX package's loop fires them (both run on one recording model), and
    ``nemar_tpu_torch.train`` over 6 batches takes 6 steps and prints the
    chunk's mean losses.
  * cycle_gan and pix2pix refuse ``--steps_per_execution 2`` by name.
  * On the card (``cuda``, skipped here): the graph's replays equal the
    eager chunk bit for bit at a tiny size.
"""

import importlib

import numpy as np
import pytest
import torch

from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

TINY = ["--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "4",
        "--ndf", "4", "--stn_ngf", "4", "--stn_depth", "3", "--batch_size", "2"]
A5 = ["--pool_size", "50", "--gan_mode", "wgangp", "--ema_decay", "0.9", "--grad_accum", "2"]


def _opt(root, *flags):
    return TrainOptions().parse([*TINY, "--dataset_mode", "synthetic", "--gpu_ids", "-1",
                                 "--checkpoints_dir", str(root), "--name", "spe", *flags])


def _model(root, *flags):
    model = create_model(_opt(root, *flags))
    model.setup(model.opt)
    model.set_epoch(1)
    return model


def _jax():
    """The JAX side's modules, imported by the tests that use them (the
    card's test run, ``-m cuda``, has no JAX)."""
    return tuple(importlib.import_module(m) for m in (
        "jax", "jax.numpy", "test_torch_model_families", "test_torch_nemar_pallas_all", "train"))


def test_chunk_and_tail_match_jax_scan_float64(tmp_path):
    jax, jnp, mf, pa, _ = _jax()
    jm = mf._jax_model(tmp_path, [*TINY, "--pool_size", "0"])
    rng = np.random.default_rng(5)
    params = {n: mf._draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    batches = mf._batches(6, 1, 3, 32, 6)
    chunks = [batches[:4], batches[4:]]
    jax_losses = []
    with pa.jax_float64():
        p = {n: mf._f64(t) for n, t in params.items()}
        state = mf._one_device(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])))
        scan = jax.jit(lambda *a: jm._train_scan_impl(*a))
        for chunk in chunks:
            a = jnp.asarray(np.stack([bt["A"] for bt in chunk]), jnp.float64)
            b = jnp.asarray(np.stack([bt["B"] for bt in chunk]), jnp.float64)
            state, metrics = scan(state, a, b, jnp.float64(mf.LR), jm._gan_w_scalar(),
                                  jm._r_gate_scalar())
            jax_losses.append({k: float(v) for k, v in metrics.items()})
        jax.block_until_ready(state)

    model = mf._port_model(tmp_path, [*TINY, "--pool_size", "0"], params)
    start = {n: flax_to_torch(params[n], model.nets()[n], mf.F64) for n in "GDR"}
    for chunk, want in zip(chunks, jax_losses):
        model.optimize_parameters_scan(chunk)
        mf._hold_losses(model.get_current_losses(), {k: want[k] for k in model.loss_names})
    assert model.step == int(state.step) == 6
    for n in "GDR":
        net = model.nets()[n]
        ref = flax_to_torch(jax.device_get(getattr(state, f"params_{n}")), net, mf.F64)
        skip = mf._norm_biases(net)
        for key, p in net.named_parameters():
            if key in skip:
                bound = 1.1 * mf.LR * 6
                assert float((p.detach() - start[n][key]).abs().max()) <= bound, (n, key)
                assert float((ref[key] - start[n][key]).abs().max()) <= bound, (n, key)
                continue
            err = float((p.detach() - ref[key]).abs().max())
            assert err <= 1e-10, (n, key, err)


def _full_state(model) -> dict:
    out = {f"{n}.{k}": p.detach().clone() for n, net in model.nets().items()
           for k, p in net.named_parameters()}
    for n, o in model.optimizers.items():
        for i, st in o.state_dict()["state"].items():
            out.update({f"adam_{n}.{i}.{k}": v.clone() for k, v in st.items()})
    out.update({f"{n}_ema.{k}": v.clone() for n, s in (model.ema or {}).items()
                for k, v in s.items()})
    if model.pool is not None:
        out["pool.images"], out["pool.count"] = (t.clone() for t in model.pool)
    out["rng"] = model.rng.get_state()
    return out


def test_chunk_equals_steps_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    batches = [{"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
                "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)} for _ in range(6)]
    fill = torch.from_numpy(rng.uniform(-1, 1, (50, 3, 32, 32)).astype(np.float32))
    runs = []
    for name in ("steps", "chunks"):
        model = _model(tmp_path / name, *A5)
        model.pool[0].copy_(fill)  # full: the steps swap
        model.pool[1].fill_(50)
        runs.append(model)
    steps, chunks = runs
    losses = []
    for b in batches[:4]:
        steps.set_input(b)
        steps.optimize_parameters()
        losses.append(steps._losses)
    for b in batches[4:]:
        steps.set_input(b)
        steps.optimize_parameters()
    chunks.optimize_parameters_scan(batches[:4])
    for k in chunks.loss_names:  # the mean of the chunk's steps, summed in order
        want = (losses[0][k] + losses[1][k] + losses[2][k] + losses[3][k]) / 4
        assert torch.equal(chunks._losses[k], want), k
    chunks.optimize_parameters_scan(batches[4:])
    assert chunks.step == steps.step == 6
    want, got = _full_state(steps), _full_state(chunks)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(chunks.real_A, steps.real_A) and torch.equal(chunks.real_B, steps.real_B)
    assert chunks.real_A.stride() == steps.real_A.stride()
    assert "D_gp" in chunks._losses


class _Recorder:
    """A model and a visualizer that record what the train loops call."""

    def __init__(self):
        self.calls = []
        self.steps = 0

    def __getattr__(self, name):
        if name in ("set_epoch", "set_input", "update_learning_rate", "reset", "plot_current_losses",
                    "display_current_results"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def optimize_parameters(self):
        self.steps += 1
        self.calls.append(("step", self.steps))

    def optimize_parameters_scan(self, batches):
        self.steps += len(batches)
        self.calls.append(("chunk", self.steps))

    def forward(self):
        self.calls.append(("display", self.steps))

    test = forward

    def get_current_losses(self):
        self.calls.append(("print", self.steps))
        return {}

    def get_current_visuals(self):
        return {}

    def save_networks(self, suffix):
        self.calls.append(("save", str(suffix), self.steps))

    def print_current_losses(self, *args):
        pass


@pytest.mark.parametrize("spe,n_batches", [(4, 6), (3, 10), (1, 5)])
def test_train_loop_fires_where_the_jax_loop_fires(tmp_path, spe, n_batches):
    opt = _opt(tmp_path, "--steps_per_execution", str(spe), "--display_freq", "6",
               "--print_freq", "10", "--save_latest_freq", "14", "--save_epoch_freq", "1",
               "--n_epochs", "2", "--n_epochs_decay", "0")
    jax_train = _jax()[-1]
    dataset = [{"A": None, "B": None}] * n_batches
    calls = []
    for loop in (lambda m: jax_train._train_epochs(opt, dataset, n_batches * 2, m, m, 0, spe),
                 lambda m: port_train._train_epochs(opt, dataset, n_batches * 2, m, m)):
        rec = _Recorder()
        loop(rec)
        calls.append(rec.calls)
        assert rec.steps == 2 * n_batches
    assert calls[0] == calls[1]
    assert any(c[0] == "print" for c in calls[1]) and any(c[0] == "display" for c in calls[1])


def test_train_entry_point_runs_chunks_and_prints_their_means(tmp_path, capsys):
    """12 pairs in batches of 2 with spe 4: a chunk of 4 and a tail of 2;
    --print_freq 8 fires after the chunk, with the mean of its 4 steps'
    losses, which a second model's 4 steps on the same batches give."""
    args = [*TINY, "--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
            str(tmp_path), "--name", "spe_main", "--synthetic_size", "12", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--print_freq", "8", "--display_freq", "0",
            "--save_epoch_freq", "0", "--save_latest_freq", "0", "--serial_batches"]
    model = port_train.main([*args, "--steps_per_execution", "4"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("(epoch: ")]
    assert model.step == 6 and len(lines) == 1 and lines[0].startswith("(epoch: 1, iters: 8,")
    ref = create_model(TrainOptions().parse(args))
    ref.setup(ref.opt)
    ref.set_epoch(1)
    sums = None
    for data in list(create_dataset(ref.opt))[:4]:
        ref.set_input(data)
        ref.optimize_parameters()
        sums = ref._losses if sums is None else {k: sums[k] + v for k, v in ref._losses.items()}
    for k in ref.loss_names:
        assert f"{k}: {float(sums[k] / 4):.3f} " in lines[0], (k, lines[0])


@pytest.mark.parametrize("model", ["cycle_gan", "pix2pix"])
def test_other_models_refuse_steps_per_execution(tmp_path, model):
    opt = TrainOptions().parse(["--model", model, "--dataset_mode", "synthetic", "--gpu_ids",
                                "-1", "--checkpoints_dir", str(tmp_path), "--input_nc", "3",
                                "--output_nc", "3", "--steps_per_execution", "2"])
    with pytest.raises(NotImplementedError,
                       match=f"the JAX package has no fused step for the {model} model"):
        create_model(opt)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("flags", [
    A5,
    ["--stn_type", "affine", "--bf16", "--freeze_g", "--stn_grad_clip", "0.5", "--ema_decay",
     "0.9"],
    ["--stn_multiscale", "--border_mask", "--recon_pyramid", "1", "--remat", "--pool_size", "4",
     "--ema_decay", "0.9"],
], ids=["a5", "affine_bf16_freeze_g", "multiscale_remat"])
def test_graph_replays_equal_the_eager_chunk(tmp_path, flags):
    """The step's flags on the card: the graph's replays (chunks of 4, 4, 2)
    equal the same chunks run eagerly, bit for bit."""
    rng = np.random.default_rng(4)
    batches = [{"A": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32),
                "B": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)} for _ in range(10)]
    runs = []
    for name in ("graph", "eager"):
        opt = TrainOptions().parse([*TINY, *flags, "--dataset_mode", "synthetic", "--gpu_ids", "0",
                                    "--checkpoints_dir", str(tmp_path / name),
                                    "--steps_per_execution", "4"])
        model = create_model(opt)
        model.setup(opt)
        model.set_epoch(1)
        runs.append(model)
    for chunk in (batches[:4], batches[4:8], batches[8:]):
        runs[0].optimize_parameters_scan(chunk)
        runs[1].optimize_parameters_scan_eager(chunk)
        assert all(torch.equal(runs[0]._losses[k], runs[1]._losses[k]) for k in runs[0]._losses)
    assert runs[0]._step_graphs and all(g.graph is not None
                                        for g in runs[0]._step_graphs.values())
    want, got = _full_state(runs[1]), _full_state(runs[0])
    for key in want:
        assert torch.equal(got[key].cpu(), want[key].cpu()), key
