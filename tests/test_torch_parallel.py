"""Data parallelism on the port (``nemar_tpu_torch.parallel``): a run over
W ranks equals the one-process run on the same global batch, as the JAX
package's mesh gives it (``nemar_tpu/parallel/mesh.py``).

The ranks run on the CPU over gloo, through the entry point's path
(``train.main``'s: the options, ``parallel.devices``, one launched
``train._train_rank`` per device; one case through ``python -m
nemar_tpu_torch.train --gpu_ids -1 --num_devices 2``), in float64
(``train._train(opt, torch.float64)``). Held, from the checkpoints rank 0
writes against the one-process run's: every parameter (and EMA shadow)
within 1e-10 and every Adam moment within 1e-9 relative (the tolerances of
the float64 step tests, ``tests/test_torch_model_families.py``: the
reduction order differs; one step's gradients agree to ~1e-15 relative),
the step counts, the lr, the generator's state and the pool; and the
ranks' states bit-identical (``state_digest``). Adam turns a gradient of
roundoff into a move of up to lr: the biases of convolutions a norm
follows (all of whose gradient is roundoff) are held to moving by at
most 1.1 lr a step in each run, as there, and so are the few elements of
a weight whose gradient is within roundoff of zero (at most 2 + 1e-4 of
its elements, the exception of ``tests/test_torch_nemar_train.py``). The port's 2-rank NeMAR
step is also held against the JAX package's step on a 2-device mesh
(``--num_devices 2``). Every launch has a timeout, so a hang fails.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.models.stn.affine_stn import AffineSTN
from nemar_tpu_torch.models.stn.unet_stn import UnetSTN
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
LR = 2e-4
TIMEOUT = 120.0  # seconds, a launch; each collective too
PARAM_TOL, MOMENT_TOL = 1e-10, 1e-9
RUN = ["--dataset_mode", "synthetic", "--n_epochs", "1", "--n_epochs_decay", "0",
       "--save_epoch_freq", "1", "--display_freq", "0", "--print_freq", "4"]
NEMAR = ["--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf",
         "8", "--stn_ngf", "8", "--stn_depth", "3", "--batch_size", "4", "--synthetic_size", "8"]
CONFIGS = {
    "nemar": NEMAR,
    # the A5 flags: microbatches of 2 rows (one a rank), one global pool,
    # the penalty's alphas for the global rows
    "nemar_a5": [*NEMAR, "--grad_accum", "2", "--pool_size", "4", "--gan_mode", "wgangp",
                 "--ema_decay", "0.999"],
    # a chunk of 2 steps (eager on the CPU)
    "nemar_spe": [*NEMAR, "--steps_per_execution", "2"],
    # a batch that 2 ranks do not divide is replicated on both
    "nemar_tail": [*NEMAR, "--batch_size", "3", "--synthetic_size", "6", "--pool_size", "2",
                   "--border_mask"],
    # batch norm over the global batch, dropout masks drawn for it; the
    # display's forward every step
    "pix2pix": ["--model", "pix2pix", "--netG", "unet_128", "--crop_size", "128",
                "--load_size", "128", "--ngf", "4", "--ndf", "4", "--batch_size", "2",
                "--synthetic_size", "4", "--input_nc", "3", "--output_nc", "3",
                "--display_freq", "2"],
    # two global pools
    "cycle_gan": ["--model", "cycle_gan", "--netG", "resnet_6blocks", "--crop_size", "32",
                  "--load_size", "32", "--ngf", "8", "--ndf", "8", "--batch_size", "2",
                  "--synthetic_size", "6", "--pool_size", "2", "--input_nc", "3",
                  "--output_nc", "3"],
}


def _argv(root, name, flags, ranks, *extra):
    return [*RUN, *flags, "--gpu_ids", "-1", "--num_devices", str(ranks),
            "--checkpoints_dir", str(root), "--name", name, *extra]


def _main(argv, rank_fn=port_train._train_rank):
    """``train.main(argv)`` with the model in float64 and every launch
    bounded by TIMEOUT: one process -> the model; several -> the ranks'
    ``state_digest``s."""
    opt = TrainOptions().parse(argv)
    devs = parallel.devices(opt)
    if len(devs) == 1:
        return port_train._train(opt, F64)
    return parallel.launch(rank_fn, devs, args=(opt, F64), timeout=TIMEOUT,
                           pg_timeout=TIMEOUT)


def _norm_biases(net) -> set:
    """The biases of ``net``'s convolutions that a norm follows (their
    gradient is roundoff): as ``tests/test_torch_model_families.py``."""
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
    if isinstance(net, networks.PixelDiscriminator):
        return {"Conv_1.bias"}
    if isinstance(net, AffineSTN):
        return {f"Conv_{i}.bias" for i in range(net.n_downs)}
    assert isinstance(net, UnetSTN)
    heads = set(net.head_index.values())  # the flow heads: no norm follows
    return {f"Conv_{i}.bias" for i in range(net.n_convs) if i not in heads}


def _load(root, name, suffix, model):
    """{file stem: object} of the checkpoint ``suffix`` of run ``name``."""
    out = {}
    for n in [*model.nets(), *model.shadow_states()]:
        out[n] = torch.load(root / name / f"{suffix}_net_{n}.pth", weights_only=True)
    out["state"] = torch.load(root / name / f"{suffix}_state.pth", weights_only=True)
    return out


def _rel(a, b) -> float:
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / den if den else float(
        torch.linalg.vector_norm(a))


def _hold_same_state(got: dict, want: dict, model, steps: int) -> None:
    """Rank 0's checkpoint ``got`` against the one-process run's ``want``."""
    skip = {n: _norm_biases(net) for n, net in model.nets().items()}
    bound = 2 * 1.1 * LR * steps
    for n in [*model.nets(), *model.shadow_states()]:
        for k, v in want[n].items():
            diff = (got[n][k] - v).abs()
            if k in skip[n.removesuffix("_ema")]:
                assert float(diff.max()) <= bound, (n, k, float(diff.max()))
                continue
            # Adam turns a gradient element within roundoff of zero into an
            # update anywhere within +-lr: such elements (at most 2 + 1e-4
            # of a tensor's, as in test_torch_nemar_train.py) are held to
            # the Adam bound, the rest to PARAM_TOL
            loose = int((diff > PARAM_TOL).sum())
            assert loose <= 2 + 1e-4 * v.numel() and float(diff.max()) <= bound, \
                (n, k, loose, float(diff.max()))
    gs, ws = got["state"], want["state"]
    assert (gs["step"], gs["current_lr"]) == (ws["step"], ws["current_lr"])
    for key in ("rng", "pool", "pools"):
        if key in ws:
            torch.testing.assert_close(gs[key], ws[key], rtol=0, atol=PARAM_TOL)
    for o, opt_state in ws["optimizers"].items():
        # the optimizer's parameters in order: which are norm biases
        params = [(n, k) for n in model.nets() for k, _ in model.nets()[n].named_parameters()]
        mine = {id(p): i for i, p in enumerate(
            p for net in model.nets().values() for p in net.parameters())}
        order = [mine[id(p)] for g in model.optimizers[o].param_groups for p in g["params"]]
        for i, st in opt_state["state"].items():
            n, k = params[order[i]]
            other = gs["optimizers"][o]["state"][i]
            assert float(other["step"]) == float(st["step"])
            if k in skip[n]:
                continue
            for m in ("exp_avg", "exp_avg_sq"):
                assert _rel(other[m], st[m]) <= MOMENT_TOL, (o, n, k, m, _rel(other[m], st[m]))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_two_ranks_equal_one_process(tmp_path, config):
    flags = CONFIGS[config]
    one = _main(_argv(tmp_path, "one", flags, 1))
    digests = _main(_argv(tmp_path, "two", flags, 2))
    assert len(digests) == 2 and digests[0] == digests[1]
    steps = one.step
    assert steps >= 2
    _hold_same_state(_load(tmp_path, "two", 1, one), _load(tmp_path, "one", 1, one), one, steps)


def _local_bn_rank(opt, dtype):
    """A rank whose batch norm takes its own rows' statistics alone."""
    networks.batch_norm_global = networks.batch_norm_local
    return port_train._train_rank(opt, dtype)


def test_the_check_sees_per_rank_batch_statistics(tmp_path):
    """The same pix2pix run with each rank normalising over its own row:
    the parameters move off the one-process run's, far past the
    tolerance, so the equality above holds because the statistics are
    global."""
    flags = CONFIGS["pix2pix"]
    one = _main(_argv(tmp_path, "one", flags, 1))
    _main(_argv(tmp_path, "local", flags, 2), _local_bn_rank)
    got, want = _load(tmp_path, "local", 1, one), _load(tmp_path, "one", 1, one)
    err = max(float((got["G"][k] - v).abs().max()) for k, v in want["G"].items()
              if k not in _norm_biases(one.netG))
    assert err > 1e3 * PARAM_TOL, err


def test_resume_at_one_rank_from_two(tmp_path):
    """2 steps at 2 ranks, saved; resumed in one process with
    --continue_train for 2 more: the uninterrupted one-process run's 4.
    (--serial_batches --no_flip: a fresh loader starts the data stream
    over, so the runs see the same batches in epoch 2 only when the
    epochs' batches are the same.)"""
    flags = [*CONFIGS["nemar_a5"], "--n_epochs", "2", "--serial_batches", "--no_flip"]
    one = _main(_argv(tmp_path, "one", flags, 1))
    _main(_argv(tmp_path, "split", flags, 2, "--n_epochs", "1"))
    resumed = _main(_argv(tmp_path, "split", flags, 1, "--continue_train", "--epoch_count",
                          "2"))
    assert resumed.step == one.step == 4
    _hold_same_state(_load(tmp_path, "split", 2, one), _load(tmp_path, "one", 2, one), one, 4)


def _units_rank():
    """The collectives and the batch's split at rank r of 2."""
    r, w = parallel.rank(), parallel.world()
    assert (w, parallel.backend()) == (2, "gloo")
    # a batch of 4 in 2 microbatches: row r of each; a batch of 3: all of it
    assert parallel.shard_slices(4, 2) == [slice(r, r + 1), slice(2 + r, 3 + r)]
    assert parallel.shard_slices(3) == [slice(0, 3)]
    batch = {"A": np.arange(8.0).reshape(4, 2), "A_paths": list("abcd"), "other": 5}
    local = parallel.shard_rows(batch, 2)
    np.testing.assert_array_equal(local["A"], batch["A"][[r, 2 + r]])
    assert local["A_paths"] == ["ab"[r], "cd"[r]] and local["other"] == 5
    x = torch.full((1, 3), float(r))
    assert torch.equal(parallel.all_gather_rows(x), torch.tensor([[0.0] * 3, [1.0] * 3]))
    # the gradients' mean; a None grad stays None
    a, b = torch.zeros(3, requires_grad=True), torch.zeros(2, requires_grad=True)
    a.grad = torch.full((3,), 2.0 * r + 1)
    parallel.all_reduce_grads([b, a])
    assert b.grad is None and torch.equal(a.grad, torch.full((3,), 2.0))
    # the sum's backward sums the ranks' gradients
    y = torch.tensor([1.0 + r], requires_grad=True)
    s = parallel.sum_over_ranks(y * (r + 1))
    (g,) = torch.autograd.grad(s.sum() * (r + 1), y)
    assert float(s) == 5.0 and float(g) == 3.0 * (r + 1)
    assert parallel.mean_over_ranks({"l": torch.tensor(float(r))}) == {"l": 0.5}
    # a CUDA graph of the step cannot capture gloo's collectives: refused
    from nemar_tpu_torch.models import step_graph

    graph = step_graph.StepGraph.__new__(step_graph.StepGraph)
    with pytest.raises(NotImplementedError, match="gloo"):
        graph.run(None, None, 1.0, 1.0, graph=True)
    return r


def test_collectives_at_two_ranks():
    assert parallel.launch(_units_rank, ["cpu", "cpu"], timeout=TIMEOUT,
                           pg_timeout=TIMEOUT) == [0, 1]
    assert (parallel.world(), parallel.rank(), parallel.device()) == (1, 0, None)


def _raising_rank():
    if parallel.rank() == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()  # rank 0 waits for the one that failed


def test_a_rank_that_raises_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*rank 1 fails"):
        parallel.launch(_raising_rank, ["cpu", "cpu"], timeout=TIMEOUT, pg_timeout=TIMEOUT)


def test_refusals(tmp_path):
    """Ids without CUDA raise (no CPU fallback); --num_devices keeps the
    first ids. --mesh_spatial was refused (ROADMAP A10b) until it was
    ported: the model now builds at --mesh_spatial 2, and the entry point
    refuses a spatial axis that does not divide the devices, with the JAX
    package's ``make_mesh`` error (``tests/test_torch_spatial.py`` holds
    the spatial runs)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for CPU-only machines")
    argv = [*RUN, *NEMAR, "--checkpoints_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="is_available"):
        port_train.main([*argv, "--gpu_ids", "0,1"])
    opt = TrainOptions().parse([*argv, "--gpu_ids", "0,1"])
    assert opt.gpu_ids == [0, 1]
    with pytest.raises(RuntimeError, match="gpu_ids 0,1"):
        create_model(opt)
    assert TrainOptions().parse([*argv, "--gpu_ids", "0,1,2", "--num_devices", "2"]).gpu_ids \
        == [0, 1]
    opt = TrainOptions().parse([*argv, "--gpu_ids", "-1", "--mesh_spatial", "2"])
    assert create_model(opt).spatial
    with pytest.raises(ValueError, match="spatial=2 must divide device count 1"):
        port_train.main([*argv, "--gpu_ids", "-1", "--mesh_spatial", "2"])


def test_cli_two_ranks(tmp_path):
    """``python -m nemar_tpu_torch.train --gpu_ids -1 --num_devices 2``
    (fp32): rank 0's checkpoints, the global losses printed once, the two
    ranks' states bit-identical."""
    cmd = [sys.executable, "-m", "nemar_tpu_torch.train",
           *_argv(tmp_path, "cli", CONFIGS["nemar"], 2)]
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    assert len(re.findall(r"^\(epoch: 1, iters: 4,", done.stdout, re.M)) == 1
    digests = re.findall(r"state digests: \['(\w+)', '(\w+)'\]", done.stdout)
    assert digests and digests[0][0] == digests[0][1]
    assert (tmp_path / "cli" / "1_net_G.pth").exists()


def _port_step_rank(flags, states, batch):
    """One float64 step of the port's NeMAR at this rank from ``states``
    on the global ``batch``: -> ({net: {key: (param, grad)}}, losses)."""
    opt = TrainOptions().parse(flags)
    model = create_model(opt)
    model.to_dtype(F64)
    for n, sd in states.items():
        model.nets()[n].load_state_dict(sd)
    model.setup(opt)
    model.set_epoch(1)
    model.set_input(batch)
    model.optimize_parameters()
    nets = {n: {k: (p.detach().clone(), None if p.grad is None else p.grad.clone())
                for k, p in net.named_parameters()} for n, net in model.nets().items()}
    return nets, dict(model.get_current_losses())


def test_border_mask_step_two_ranks(tmp_path):
    """--border_mask's loss, a sum over the valid pixels over their count,
    over the global batch: one float64 step at 2 ranks (the count summed
    over the ranks) against one process, losses and gradients within 1e-9
    relative. (Against the JAX package the masked step differs at 1e-7 in
    float64: the port warps the mask's ones in fp32, as its fp32 runs do.)
    Over several steps Adam's first step makes the runs part at ~1e-8, so
    one step is held here."""
    argv = [*RUN, *NEMAR, "--border_mask", "--dataset_mode", "synthetic", "--gpu_ids", "-1",
            "--checkpoints_dir", str(tmp_path)]
    rng = np.random.default_rng(12)
    batch = {k: rng.uniform(-1, 1, (4, 32, 32, c)).astype(np.float32)
             for k, c in (("A", 1), ("B", 3))}
    want_nets, want = _port_step_rank(argv, {}, batch)
    ranks = parallel.launch(_port_step_rank, ["cpu", "cpu"], args=(argv, {}, batch),
                            timeout=TIMEOUT, pg_timeout=TIMEOUT)
    host = create_model(TrainOptions().parse(argv))
    for nets, losses in ranks:
        assert all(abs(losses[k] - v) <= 1e-9 * abs(v) + 1e-15 for k, v in want.items()), losses
        for n, params in want_nets.items():
            skip = _norm_biases(host.nets()[n])  # gradients of roundoff
            for k, (_, g) in params.items():
                if g is not None and k not in skip:
                    assert _rel(nets[n][k][1], g) <= 1e-9, (n, k)


def test_two_rank_step_matches_jax_two_devices(tmp_path):
    """One NeMAR step under --norm batch (the trap: statistics over the
    global batch) at global batch 4: the port's 2 ranks against the JAX
    package's step on a 2-device mesh, both in float64 from the same
    parameters and the same numpy batch; losses and gradients within
    1e-9, parameters within 1e-10 (``test_torch_model_families``'s
    ``_hold_step``)."""
    import jax
    import jax.numpy as jnp
    import test_torch_model_families as fam
    import test_torch_nemar_pallas_all as pa
    import test_torch_nemar_train as tt
    from nemar_tpu.parallel import replicate, shard_batch

    flags = [*fam.NEMAR_BATCH, "--batch_size", "4"]
    jm = fam._jax_model(tmp_path, [*flags, "--num_devices", "2"])
    assert jm.mesh.shape["data"] == 2
    rng = np.random.default_rng(11)
    params = {n: fam._draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    rec = []
    jm.tx, jm.tx_R = tt._recording(jm.tx, "GD", rec), tt._recording(jm.tx_R, "R", rec)
    batch = {k: rng.uniform(-1, 1, (4, 32, 32, c)).astype(np.float32)
             for k, c in (("A", 1), ("B", 3))}
    with pa.jax_float64():
        p = {n: fam._f64(t) for n, t in params.items()}
        state = replicate(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])), jm.mesh)
        sharded = shard_batch(jm.mesh, {k: np.asarray(v, np.float64) for k, v in batch.items()})
        assert len(sharded["A"].sharding.device_set) == 2
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, sharded["A"], sharded["B"], jnp.float64(LR), jm._gan_w_scalar(),
            jm._r_gate_scalar())
        jax.block_until_ready(state)
    grads = {}
    for tag, t in rec:
        grads["R" if tag == "R" else ("G" if "ResnetBlock_0" in t["params"] else "D")] = t

    host = create_model(TrainOptions().parse(
        [*flags, "--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
         str(tmp_path / "port"), "--name", "port"]))
    host.to_dtype(F64)
    states = {n: flax_to_torch(params[n], host.nets()[n], F64) for n in "GDR"}
    argv = [*flags, "--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir",
            str(tmp_path / "port"), "--name", "port"]
    ranks = parallel.launch(_port_step_rank, ["cpu", "cpu"], args=(argv, states, batch),
                            timeout=TIMEOUT, pg_timeout=TIMEOUT)
    (nets, losses), (nets1, losses1) = ranks
    assert losses == losses1
    fam._hold_losses(losses, {k: float(metrics[k]) for k in host.loss_names})
    for n in "GDR":
        net = host.nets()[n]
        for k, p in net.named_parameters():
            value, grad = nets[n][k]
            assert torch.equal(value, nets1[n][k][0])  # bit-identical across the ranks
            p.data.copy_(value)
            p.grad = grad
        fam._hold_step(n, net, grads[n], jax.device_get(getattr(state, f"params_{n}")),
                       states[n], 1)
