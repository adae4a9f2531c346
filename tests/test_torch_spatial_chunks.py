"""``--steps_per_execution k`` under ``--mesh_spatial s`` (ROADMAP.md A10c
item 4): NeMAR's chunk of steps in bands, the JAX package's
``_train_scan_impl`` on its ('data', 'spatial') mesh, where the chunk goes
in as ``P(None, 'data')`` and GSPMD splits H inside each step.

The ranks run on the CPU over gloo (``parallel.launch``) at 32^2, ngf, ndf
and stn_ngf 4, stn_depth 3 (D's stride-1 layers give bands of 2 and 1
rows, then 2 and none). Held:

  * (a) in float64, the port's chunk of 4 and then a tail of 2 at (data 1,
    spatial 2) against the JAX package's ``_train_scan_impl`` on its (data
    1, spatial 2) mesh, from the same parameters and fresh Adam (lsgan,
    ``--pool_size 0``), by ``test_torch_steps_per_execution``'s rule: every
    parameter within 1e-10 (the biases a norm follows within 1.1 lr a step
    of their start), the step count, and each chunk's mean losses within
    1e-9 relative;
  * (b) with the pool (pre-filled, so steps swap), WGAN-GP, EMA and
    ``--grad_accum 2``: the band chunk and tail equal as many band
    ``optimize_parameters`` calls bit for bit (parameters, Adam's state,
    the shadows, the pool's band, the generator's state; the chunk's
    losses the means of the steps' band shares; real_A and real_B the last
    batch's band), the two ranks bit-identical (the pool's gathered
    frames too), and in float64 one process's chunk and tail by
    ``test_torch_spatial._hold_ranks``'s rule;
  * (c) the chunk against band steps, bit for bit, in fp32 at --stn_depth
    5, whose deepest level of one row lies in bands of 1 and none;
  * (d) ``python -m nemar_tpu_torch.train --num_devices 2 --mesh_spatial 2
    --steps_per_execution 4`` over 6 batches: a chunk and a tail, 6 steps,
    the chunk's mean losses printed; a ``--continue_train`` second epoch
    equals the uninterrupted two-epoch run bit for bit.
"""

import numpy as np
import torch

import test_torch_parallel as tp
import test_torch_spatial as ts
from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.parallel import spatial
from nemar_tpu_torch.utils.convert import flax_to_torch

F64 = torch.float64
RUN = ["--dataset_mode", "synthetic", "--gpu_ids", "-1"]
TINY = ["--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "4", "--ndf",
        "4", "--stn_ngf", "4", "--stn_depth", "3", "--batch_size", "2"]
A5 = ["--pool_size", "50", "--gan_mode", "wgangp", "--ema_decay", "0.9", "--grad_accum", "2"]
BANDS = ["--num_devices", "2", "--mesh_spatial", "2"]


def _batches(n, size, seed):
    rng = np.random.default_rng(seed)
    return [{"A": rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32),
             "B": rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)} for _ in range(n)]


def _model(argv, dtype, states=None):
    model = create_model(TrainOptions().parse(argv))
    model.to_dtype(dtype)
    for name, sd in (states or {}).items():
        model.nets()[name].load_state_dict(sd)
    model.setup(model.opt)
    model.set_epoch(1)
    return model


# ---------------------------------------------------------------------------
# (a) against the JAX package's scan on its spatial mesh
# ---------------------------------------------------------------------------
def _jax_chunks_rank(argv, states, chunks, spatial_size):
    """The port's chunks in float64 from ``states`` -> (each chunk's
    global mean losses, {net: {key: parameter}}, the step count)."""
    parallel.set_mesh(spatial_size)
    model = _model(argv, F64, states)
    losses = []
    for chunk in chunks:
        model.optimize_parameters_scan(chunk)
        losses.append(dict(model.get_current_losses()))
    return losses, {n: {k: p.detach().clone() for k, p in net.named_parameters()}
                    for n, net in model.nets().items()}, model.step


def test_band_chunk_and_tail_match_jax_scan_float64(tmp_path):
    import jax
    import jax.numpy as jnp
    import test_torch_model_families as mf
    import test_torch_nemar_pallas_all as pa
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from nemar_tpu.parallel import replicate

    flags = [*TINY, "--pool_size", "0"]
    jm = mf._jax_model(tmp_path, [*flags, *BANDS])
    assert dict(jm.mesh.shape) == {"data": 1, "spatial": 2}
    rng = np.random.default_rng(5)
    params = {n: mf._draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    batches = _batches(6, 32, 6)
    chunks = [batches[:4], batches[4:]]
    jax_losses = []
    with pa.jax_float64():
        p = {n: mf._f64(t) for n, t in params.items()}
        state = replicate(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])), jm.mesh)
        scan = jax.jit(lambda *a: jm._train_scan_impl(*a))
        # the chunk as optimize_parameters_scan puts it: batch on 'data',
        # the same on every spatial device
        sd = NamedSharding(jm.mesh, P(None, "data"))
        for chunk in chunks:
            a, b = (jax.device_put(np.stack([bt[k] for bt in chunk]).astype(np.float64), sd)
                    for k in "AB")
            state, metrics = scan(state, a, b, jnp.float64(mf.LR), jm._gan_w_scalar(),
                                  jm._r_gate_scalar())
            jax_losses.append({k: float(v) for k, v in metrics.items()})
        jax.block_until_ready(state)

    argv = [*RUN, *flags, "--checkpoints_dir", str(tmp_path / "port"), "--name", "port"]
    host = create_model(TrainOptions().parse(argv))
    host.to_dtype(F64)
    start = {n: flax_to_torch(params[n], host.nets()[n], F64) for n in "GDR"}
    ranks = ts._launch(_jax_chunks_rank, 2, [*argv, *BANDS], start, chunks, 2)
    (losses, nets, step), (losses1, nets1, step1) = ranks
    assert losses == losses1 and step == step1 == int(state.step) == 6
    for got, want in zip(losses, jax_losses):
        mf._hold_losses(got, {k: want[k] for k in host.loss_names})
    for n in "GDR":
        ref = flax_to_torch(jax.device_get(getattr(state, f"params_{n}")), host.nets()[n], F64)
        skip = mf._norm_biases(host.nets()[n])
        for key, value in nets[n].items():
            assert torch.equal(value, nets1[n][key]), (n, key)
            if key in skip:
                bound = 1.1 * mf.LR * 6
                assert float((value - start[n][key]).abs().max()) <= bound, (n, key)
                assert float((ref[key] - start[n][key]).abs().max()) <= bound, (n, key)
                continue
            err = float((value - ref[key]).abs().max())
            assert err <= 1e-10, (n, key, err)


# ---------------------------------------------------------------------------
# (b), (c) the band chunk against band steps and one process
# ---------------------------------------------------------------------------
def _state(model) -> dict:
    """Every tensor of the training state, the pool's band and its gathered
    frames (on every rank alike) among them."""
    out = {f"{n}.{k}": p.detach().clone() for n, net in model.nets().items()
           for k, p in net.named_parameters()}
    for n, o in model.optimizers.items():
        for i, st in o.state_dict()["state"].items():
            out.update({f"adam_{n}.{i}.{k}": v.clone() for k, v in st.items()})
    out.update({f"{n}_ema.{k}": v.clone() for n, s in model.ema.items() for k, v in s.items()})
    out["pool.band"], out["pool.count"] = (t.clone() for t in model.pool)
    band = model.band_of(model.opt.crop_size)
    out["pool.frames"] = (model.pool[0] if band is None
                          else spatial.gather_frame(model.pool[0], band))
    out["rng"] = model.rng.get_state()
    return out


def _chunks_rank(argv, fill, batches, spatial_size, dtype, steps_too=True):
    """At this rank: a model whose pool holds its band of ``fill`` (full:
    the steps swap) runs ``batches`` as a chunk of 4 and a tail; with
    ``steps_too`` a second one runs them as band ``optimize_parameters``
    calls. -> {run: (state, losses after the chunk and after the tail,
    real_A, real_B, {net: {key: (param, grad)}})}."""
    parallel.set_mesh(spatial_size)
    out = {}
    for run in ("chunks", "steps") if steps_too else ("chunks",):
        model = _model([*argv, "--name", run], dtype)
        band = model.band_of(fill.shape[2])
        rows = slice(None) if band is None else slice(band.r0, band.r1)
        model.pool[0].copy_(torch.from_numpy(fill[:, :, rows]))
        model.pool[1].fill_(len(fill))
        losses = []
        if run == "chunks":
            for chunk in (batches[:4], batches[4:]):
                model.optimize_parameters_scan(chunk)
                losses.append(dict(model._losses))
        else:
            sums = None
            for i, b in enumerate(batches):
                model.set_input(b)
                model.optimize_parameters()
                sums = (model._losses if sums is None or i == 4
                        else {k: sums[k] + v for k, v in model._losses.items()})
                if i in (3, 5):  # the mean of the chunk's steps, summed in order
                    losses.append({k: v / (4 if i == 3 else 2) for k, v in sums.items()})
        nets = {n: {k: (p.detach().clone(), None if p.grad is None else p.grad.clone())
                    for k, p in net.named_parameters()} for n, net in model.nets().items()}
        out[run] = (_state(model), losses, model.real_A.clone(), model.real_B.clone(), nets,
                    dict(model.get_current_losses()))
    return out


def _fill(size, seed=9):
    return np.random.default_rng(seed).uniform(-1, 1, (50, 3, size, size)).astype(np.float32)


def _hold_chunks_against_steps(ranks):
    """Each rank's band chunk against its band steps, bit for bit, and the
    ranks against each other."""
    for r in ranks:
        chunk, steps = r["chunks"], r["steps"]
        assert chunk[0].keys() == steps[0].keys()
        for key, v in steps[0].items():
            assert torch.equal(chunk[0][key], v), key
        for got, want in zip(chunk[1], steps[1]):
            assert got.keys() == want.keys() and "D_gp" in got
            assert all(torch.equal(got[k], want[k]) for k in want), (got, want)
        assert torch.equal(chunk[2], steps[2]) and torch.equal(chunk[3], steps[3])
        assert chunk[2].stride() == steps[2].stride()
    s0, s1 = ranks[0]["chunks"][0], ranks[1]["chunks"][0]
    for key, v in s0.items():
        if key != "pool.band":
            assert torch.equal(v, s1[key]), key
    assert ranks[0]["chunks"][5] == ranks[1]["chunks"][5]


def test_band_chunk_with_an_empty_band_equals_band_steps(tmp_path):
    """fp32 at --stn_depth 5: the STN's deepest level of one row lies in
    bands of 1 and none (D's last layers in bands of 2 and 1, then 2 and
    none, as at every depth here)."""
    argv = [*RUN, *TINY, *A5, "--stn_depth", "5", "--checkpoints_dir", str(tmp_path), *BANDS]
    ranks = ts._launch(_chunks_rank, 2, argv, _fill(32), _batches(6, 32, 3), 2, torch.float32)
    _hold_chunks_against_steps(ranks)


def test_band_chunk_equals_one_process_float64(tmp_path):
    """The float64 band chunk and tail (both ranks) against one process's,
    by ``test_torch_spatial._hold_ranks``'s rule (the last step's
    gradients, every parameter, the global mean losses of the tail), and
    the pool's frames within 1e-10; the chunk bit for bit its band steps
    here too."""
    argv = [*RUN, *TINY, *A5, "--checkpoints_dir", str(tmp_path)]
    fill, batches = _fill(32).astype(np.float64), _batches(6, 32, 4)
    one = _chunks_rank(argv, fill, batches, 1, F64, steps_too=False)["chunks"]
    ranks = ts._launch(_chunks_rank, 2, [*argv, *BANDS], fill, batches, 2, F64)
    _hold_chunks_against_steps(ranks)
    ts._hold_ranks([(r["chunks"][4], r["chunks"][5]) for r in ranks], one[4], one[5],
                   create_model(TrainOptions().parse(argv)))
    err = float((ranks[0]["chunks"][0]["pool.frames"] - one[0]["pool.frames"]).abs().max())
    assert err <= 1e-10, err


# ---------------------------------------------------------------------------
# (d) the entry point
# ---------------------------------------------------------------------------
TRAIN = [*RUN, *TINY, "--synthetic_size", "12", "--n_epochs", "1", "--n_epochs_decay", "0",
         "--display_freq", "8", "--print_freq", "8", "--save_epoch_freq", "1",
         "--save_latest_freq", "0", "--serial_batches", "--no_flip", "--pool_size", "4",
         "--gan_mode", "wgangp", "--steps_per_execution", "4", *BANDS]


def test_train_entry_point_in_bands(tmp_path, capfd):
    """12 pairs in batches of 2 at spe 4 over (data 1, spatial 2): a chunk
    of 4 and a tail of 2; --print_freq 8 fires after the chunk with its
    mean losses (rank 0 prints), and --display_freq 8 runs the gathered
    forward; a second epoch resumed with --continue_train equals the
    uninterrupted two-epoch run's, bit for bit."""
    argv = [*TRAIN, "--checkpoints_dir", str(tmp_path), "--name", "split"]
    digests = tp._main(argv)
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    assert len(digests) == 2 and digests[0] == digests[1]
    assert len(lines) == 1 and lines[0].startswith("(epoch: 1, iters: 8,"), lines
    assert all(f" {k}: " in lines[0] for k in ("D", "D_gp", "G_GAN", "G_recon", "G")), lines
    state = torch.load(tmp_path / "split" / "1_state.pth", weights_only=True)
    assert state["step"] == 6 and tuple(state["pool"]["images"].shape) == (4, 3, 32, 32)
    resumed = tp._main([*argv, "--n_epochs", "2", "--continue_train", "--epoch_count", "2"])
    whole = tp._main([*TRAIN, "--checkpoints_dir", str(tmp_path), "--name", "whole",
                      "--n_epochs", "2"])
    assert resumed == whole and resumed[0] == resumed[1]
    got, want = (torch.load(tmp_path / name / "2_state.pth", weights_only=True)
                 for name in ("split", "whole"))
    assert got["step"] == want["step"] == 12
    assert torch.equal(got["pool"]["images"], want["pool"]["images"])
    assert torch.equal(got["rng"], want["rng"])
