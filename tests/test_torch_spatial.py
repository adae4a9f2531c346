"""``--mesh_spatial`` on the port: the image height in bands over the ranks
of a spatial group (``nemar_tpu_torch/parallel/spatial.py``), as the JAX
package's ('data', 'spatial') mesh splits it (``nemar_tpu/parallel/
mesh.py``). A run at ``--num_devices W --mesh_spatial s`` equals the
one-process run on the same global batch.

The ranks run on the CPU over gloo (``parallel.launch``), in float64, at
64^2 with ngf 8, ndf 8, stn_ngf 8 and stn_depth 3 (every level's bands
even; the uneven, one-row and empty bands of other heights, 32^2 the JAX
package's own, are ``tests/test_torch_spatial_geometry.py``'s), and the
primitives and band forms on small frames. Held:

  * ``exchange_rows``, ``gather_frame`` and ``fold_halo_rows``, forward and
    adjoint, at s = 2 and 4: the exchange against the padded frame of one
    process, exactly; its adjoint by the dot-product identity summed over
    the ranks (<E x, g> = <x, E^T g>, within 1e-14 of the sum of the
    products' magnitudes: one set of products summed in two orders); the
    gather and the fold exactly;
  * each band form's plain version (K-in forward and backward, K-block,
    K-convt, K-head, the warp, the UNet's convolutions and TV) against the
    whole-frame plain version cut to the band, outputs and input gradients
    within 1e-12, weight gradients (the band's shares summed over the
    ranks) within 1e-12 relative: the same sums in another order;
  * one NeMAR step at (W, s) = (2, 2) and (4, 2), with --pool_size,
    --grad_accum 2 and --ema_decay, against one process: losses within
    1e-9 relative, every gradient within 1e-9 relative (the biases a norm
    follows, whose gradients are roundoff, to 1e-9 of their weight's),
    every parameter within 1e-10 (the float64 tolerances of
    ``test_torch_parallel.py``), the ranks' parameters bit-identical;
  * the 2-rank spatial step against the JAX package's step on a (data 1,
    spatial 2) mesh of its virtual CPU devices;
  * a checkpoint written at (2, 2) resumed in one process, and ``test
    --eval_registration`` at spatial 2 against one process;
  * the flags held in bands accepted (--steps_per_execution > 1 the last
    of them), the other models built and run in bands, an undivided
    height refused; the geometries once refused (a
    band thinner than a halo it must send, an empty output band, a height
    the levels split unevenly) held (``tests/test_torch_spatial_geometry.py``
    holds them in full).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_parallel as tp
from nemar_tpu_torch import parallel
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.models.stn.unet_stn import smoothness_loss, smoothness_loss_band
from nemar_tpu_torch.ops.conv_fused import resblock_band_plain, resblock_plain
from nemar_tpu_torch.ops.conv_head import conv_head_band, conv_head_plain
from nemar_tpu_torch.ops.convt_fused import convt_band_plain, convt_in_plain
from nemar_tpu_torch.ops.norm import instance_norm_act_band, instance_norm_act_plain
from nemar_tpu_torch.ops.warp import grid_sample, identity_grid
from nemar_tpu_torch.options import TestOptions, TrainOptions
from nemar_tpu_torch.parallel import spatial

F64 = torch.float64
TIMEOUT = tp.TIMEOUT
RUN = ["--dataset_mode", "synthetic", "--gpu_ids", "-1"]
SPATIAL = ["--model", "nemar", "--crop_size", "64", "--load_size", "64", "--ngf", "8", "--ndf",
           "8", "--stn_ngf", "8", "--stn_depth", "3"]
A5 = ["--pool_size", "4", "--grad_accum", "2", "--ema_decay", "0.5"]


def _group_sum(t):
    """t summed over the spatial group, in rank order."""
    return spatial.gather_parts(t).sum(dim=0)


def _launch(fn, ranks, *args):
    return parallel.launch(fn, ["cpu"] * ranks, args=args, timeout=TIMEOUT, pg_timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------
def _pad_frame(x, top, bottom, mode):
    """The one-process padding of an NCHW frame in H: reflect, or zeros."""
    if mode == "reflect":
        return F.pad(x, (0, 0, top, bottom), mode="reflect")
    return F.pad(x, (0, 0, top, bottom))


def _primitives_rank(s):
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(3)
    frame = torch.from_numpy(rng.standard_normal((2, 3, 16, 5)))
    band = spatial.Band.split(16, s, j)
    worst = 0.0
    for top, bottom, mode in ((1, 1, "reflect"), (3, 3, "reflect"), (1, 0, "zeros"),
                              (1, 2, "zeros"), (0, 1, "zeros")):
        x = frame[:, :, band.r0:band.r1].clone().requires_grad_()
        tops, bottoms = (top,) * s, (bottom,) * s
        got = spatial.exchange_rows(x, band, tops, bottoms, dim=2, mode=mode)
        full = frame.clone().requires_grad_()
        want = _pad_frame(full, top, bottom, mode)[:, :, band.r0:band.r1 + top + bottom]
        assert torch.equal(got, want), (top, bottom, mode)
        # the adjoint: each rank's own upstream gradient of its padded band;
        # <exchange(x), g> summed over the ranks equals <x, adjoint(g)>
        g = torch.from_numpy(np.random.default_rng(4 + j).standard_normal(tuple(got.shape)))
        (gx,) = torch.autograd.grad(got, x, g)
        lhs = float(_group_sum((got.detach() * g).sum()))
        rhs = float(_group_sum((x.detach() * gx).sum()))
        scale = float(_group_sum((got.detach() * g).abs().sum()))
        worst = max(worst, abs(lhs - rhs) / scale)
    # gather_frame and its adjoint (a sum over the ranks of each one's
    # gradient of the frame)
    x = frame[:, :, band.r0:band.r1].clone().requires_grad_()
    whole = spatial.gather_frame(x, band)
    assert torch.equal(whole, frame)
    (gx,) = torch.autograd.grad(whole, x, torch.full_like(frame, float(j + 1)))
    assert torch.equal(gx, torch.full_like(x, s * (s + 1) / 2))
    # fold_halo_rows: the halo rows of a padded gradient go to their
    # owners, and at the frame's edges onto the rows they reflect; every
    # halo row is zeroed
    blocks = torch.from_numpy(np.random.default_rng(5).standard_normal((s, 16 // s + 2, 2, 5)))
    folded = spatial.fold_halo_rows(blocks[j].clone(), band, dim=0)
    want = blocks[j].clone()
    if j > 0:
        want[1] += blocks[j - 1][-1]
    else:
        want[2] += blocks[j][0]
    if j < s - 1:
        want[-2] += blocks[j + 1][0]
    else:
        want[-3] += blocks[j][-1]
    want[0] = want[-1] = 0
    assert torch.equal(folded, want)
    return worst


@pytest.mark.parametrize("s", [2, 4])
def test_exchange_and_gather_against_one_process(s):
    assert max(_launch(_primitives_rank, s, s)) <= 1e-14


def _bands_rank(s):
    """Each band form's plain version against the frame's, cut to the band."""
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(7)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape))  # noqa: E731
    errs = {}

    def hold(name, band_fn, frame_fn, inputs, weights, band, out_band, dim):
        """band_fn on the band of ``inputs`` (frames; dim the rows) against
        frame_fn on them: outputs, input gradients, weight gradients."""
        xs = [i.narrow(dim, band.r0, band.rows).clone().requires_grad_() for i in inputs]
        ws = [w.clone().requires_grad_() for w in weights]
        out = band_fn(*xs, *ws)
        fx = [i.clone().requires_grad_() for i in inputs]
        fw = [w.clone().requires_grad_() for w in weights]
        ref = frame_fn(*fx, *fw)
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(tuple(ref.shape)))
        gb = g.narrow(dim, out_band.r0, out_band.rows)
        got_g = torch.autograd.grad(out, xs + ws, gb)
        ref_g = torch.autograd.grad(ref, fx + fw, g)
        e = float((out - ref.narrow(dim, out_band.r0, out_band.rows)).detach().abs().max())
        for a, b in zip(got_g[:len(xs)], ref_g[:len(xs)]):
            e = max(e, float((a - b.narrow(dim, band.r0, band.rows)).abs().max()))
        for a, b in zip(got_g[len(xs):], ref_g[len(xs):]):
            total = _group_sum(a)
            e = max(e, float((total - b).abs().max()) / float(b.abs().max()))
        errs[name] = e

    band16 = spatial.Band.split(16, s, j)
    for act in ("none", "relu", "leaky_relu"):
        hold(f"K-in {act}", lambda x: instance_norm_act_band(x, band16, act),
             lambda x: instance_norm_act_plain(x, act), [t(2, 16, 6, 5)], [], band16, band16, 1)
    hold("K-block", lambda x, w1, w2: resblock_band_plain(x, w1, w2, band16), resblock_plain,
         [t(2, 16, 6, 8)], [t(3, 3, 8, 8) * 0.2, t(3, 3, 8, 8) * 0.2], band16, band16, 1)
    band8 = spatial.Band.split(8, s, j) if 8 % s == 0 and 8 // s >= 2 else None
    if band8 is not None:
        hold("K-convt", lambda x, w: convt_band_plain(x, w, band8), convt_in_plain,
             [t(2, 8, 5, 6)], [t(3, 3, 6, 4) * 0.2], band8, band8.up(2), 1)
    hold("K-head", lambda x, w: conv_head_band(x, w, band16), conv_head_plain,
         [t(1, 16, 9, 4)], [t(7, 7, 4, 3) * 0.1], band16, band16, 1)
    # the warp: the sources' frames gathered, the band's rows of the grid
    ident = identity_grid(16, 7, False, F64)

    def warp_band(img, flow):
        frame = spatial.gather_frame(img, band16, dim=1)
        return grid_sample(frame, ident[band16.r0:band16.r1][None] + flow, "bilinear", "zeros",
                           False)

    hold("K-warp", warp_band, lambda img, flow: grid_sample(img, ident[None] + flow, "bilinear",
                                                            "zeros", False),
         [t(2, 16, 7, 3), t(2, 16, 7, 2) * 0.1], [], band16, band16, 1)
    # the cuDNN convolutions over the band and their halos (the UNet's and
    # D's), and the TV
    for k, stride, pad in ((3, 2, 1), (3, 1, 1), (4, 2, 1), (4, 1, 1)):
        conv = torch.nn.Conv2d(3, 4, k, stride=stride, padding=pad).double()
        with torch.no_grad():  # the same weights on every rank
            conv.weight.copy_(t(4, 3, k, k) * 0.2)
            conv.bias.copy_(t(4))
        out_band = band16.conv(k, stride, pad)[0]
        hold(f"conv k{k} s{stride}", lambda x: networks.conv_band(conv, x, band16)[0], conv,
             [t(2, 3, 16, 6)], [], band16, out_band, 2)
    flow = t(2, 16, 7, 2)
    fb = flow[:, band16.r0:band16.r1].clone().requires_grad_()
    ff = flow.clone().requires_grad_()
    share = smoothness_loss_band(fb, band16)
    total = _group_sum(share.detach())
    (gb,) = torch.autograd.grad(share, fb)
    want = smoothness_loss(ff)
    (gf,) = torch.autograd.grad(want, ff)
    errs["TV"] = max(float((total - want).abs()),
                     float((gb - gf[:, band16.r0:band16.r1]).abs().max()))
    return errs


@pytest.mark.parametrize("s", [2, 4])
def test_band_forms_against_the_frame(s):
    for errs in _launch(_bands_rank, s, s):
        assert all(e <= 1e-12 for e in errs.values()), {k: e for k, e in errs.items()
                                                        if not e <= 1e-12}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _step_rank(argv, states, batch, spatial_size, alphas=None):
    """One float64 NeMAR step from ``states`` on the global ``batch`` at
    this rank (the penalty's alpha, per microbatch, from ``alphas`` when
    given): -> ({net: {key: (param, grad)}}, losses)."""
    parallel.set_mesh(spatial_size)
    opt = TrainOptions().parse(argv)
    model = create_model(opt)
    model.to_dtype(F64)
    for n, sd in states.items():
        model.nets()[n].load_state_dict(sd)
    model.setup(opt)
    model.set_epoch(1)
    if alphas is not None:
        model._gp_alpha = lambda n, it=iter(alphas): next(it)
    model.set_input(batch)
    model.optimize_parameters()
    nets = {n: {k: (p.detach().clone(), None if p.grad is None else p.grad.clone())
                for k, p in net.named_parameters()} for n, net in model.nets().items()}
    return nets, dict(model.get_current_losses())


def _random_states(argv):
    """Parameters drawn away from the init (R's heads non-zero, so the warp
    moves), as state_dicts."""
    model = create_model(TrainOptions().parse(argv))
    model.to_dtype(F64)
    rng = np.random.default_rng(21)
    with torch.no_grad():
        for net in model.nets().values():
            for k, p in net.named_parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)))
                        * (0.05 if k.endswith("bias") else 0.1))
    return {n: {k: v.clone() for k, v in net.state_dict().items()}
            for n, net in model.nets().items()}


def _batch(n, size=64, seed=12):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, size, size, c)).astype(np.float32)
            for k, c in (("A", 1), ("B", 3))}


def _hold_ranks(ranks, want_nets, want, host, roundoff=None):
    """Every rank's losses, gradients and parameters after one step against
    the one-process step's; the ranks' parameters bit-identical. A bias a
    norm follows has a gradient of roundoff, which Adam turns into a move
    of up to lr: its gradient is held to 1e-9 of its weight's and its move
    to 1.1 lr; so are the few elements of a weight whose gradient is within
    roundoff of zero (at most 2 + 1e-4 of them, ``test_torch_parallel``'s
    rule), and ``roundoff``'s parameters ({net: keys}: a gradient that is 0
    but for roundoff, such as D's last bias under wgangp, where the real
    and the fake terms cancel). A bias whose weight's gradient is 0 (a
    norm over one pixel a channel gives 0, as the UNet's bottom level of
    one row at --stn_depth 5 and 32^2) is held to 1e-9 of its net's whole
    gradient."""
    first = ranks[0][0]
    bound = 1.1 * tp.LR
    for nets, losses in ranks:
        for k, v in want.items():
            assert abs(losses[k] - v) <= 1e-9 * abs(v) + 1e-15, (k, losses[k], v)
        for n, params in want_nets.items():
            skip = tp._norm_biases(host.nets()[n]) | set((roundoff or {}).get(n, ()))
            for k, (p, g) in params.items():
                assert torch.equal(nets[n][k][0], first[n][k][0]), (n, k)  # across the ranks
                diff = (nets[n][k][0] - p).abs()
                loose = 0 if k in skip else int((diff > 1e-10).sum())
                assert loose <= 2 + 1e-4 * p.numel() and float(diff.max()) <= bound, \
                    (n, k, loose, float(diff.max()))
                if g is None:
                    continue
                if k in skip:
                    weight = params[k.replace(".bias", ".weight")][1]
                    scale = float(torch.linalg.vector_norm(weight)) or float(
                        torch.linalg.vector_norm(torch.cat([
                            q.reshape(-1) for _, q in params.values() if q is not None])))
                    assert float((nets[n][k][1] - g).abs().max()) <= 1e-9 * scale, (n, k)
                else:
                    assert tp._rel(nets[n][k][1], g) <= 1e-9, (n, k, tp._rel(nets[n][k][1], g))


@pytest.mark.parametrize("devices,batch", [(2, 2), (4, 4)])
def test_spatial_step_equals_one_process(tmp_path, devices, batch):
    argv = [*RUN, *SPATIAL, *A5, "--batch_size", str(batch), "--checkpoints_dir",
            str(tmp_path)]
    states = _random_states(argv)
    data = _batch(batch)
    want_nets, want = _step_rank(argv, states, data, 1)
    ranks = _launch(_step_rank, devices, [*argv, "--num_devices", str(devices),
                                          "--mesh_spatial", "2"], states, data, 2)
    _hold_ranks(ranks, want_nets, want, create_model(TrainOptions().parse(argv)))


# the registration recipe's UNet arm (science.recipe_flags) at this size
RECIPE_UNET = ["--stn_multiscale", "--stn_level_scale", "0.25", "--stn_bounded_flow", "0.15",
               "--stn_smooth_order", "2", "--recon_pyramid", "3", "--border_mask"]
# NeMAR's step flags in bands: the penalty's double backward, --remat, the
# warp's options
STEP_FLAGS = ["--gan_mode", "wgangp", "--remat", "--stn_padding_mode", "border",
              "--stn_align_corners"]


@pytest.mark.parametrize("recipe", [[], RECIPE_UNET, STEP_FLAGS],
                         ids=["default", "recipe_unet", "wgangp_remat_border_align"])
def test_two_rank_spatial_step_matches_jax(tmp_path, recipe):
    """The port's (data 1, spatial 2) step against the JAX package's on a
    (data 1, spatial 2) mesh (``shard_batch(..., shard_spatial=True)``),
    both in float64 from the same parameters and numpy batch; losses and
    gradients within 1e-9, parameters within 1e-10 (``_hold_step``), with
    the default flags, with the recipe's UNet arm and with wgangp, --remat
    and the warp's border padding and align_corners (the penalty's alpha
    JAX's draw, fed to the port; its D_gp JAX's D - (D_real + D_fake) / 2;
    D's last bias, whose gradient is 0 there, 0 here too). The JAX package
    routes its warp to the one-hot matmul path that GSPMD shards; the
    function is the same."""
    hold_against_jax(tmp_path, [*SPATIAL, *recipe, "--batch_size", "2"], 64,
                     "wgangp" in recipe)


def hold_against_jax(tmp_path, flags, size, wgangp=False):
    """``test_two_rank_spatial_step_matches_jax``'s comparison of the port's
    (data 1, spatial 2) step with ``flags`` on a batch of 2 at ``size``^2
    against the JAX package's."""
    import jax
    import jax.numpy as jnp
    import test_torch_a5_step as a5
    import test_torch_model_families as fam
    import test_torch_nemar_pallas_all as pa
    import test_torch_nemar_train as tt
    from flax import traverse_util  # noqa: F401  (flax present: the JAX model's)
    from nemar_tpu.parallel import replicate, shard_batch
    from nemar_tpu_torch.utils.convert import flax_to_torch

    jm = fam._jax_model(tmp_path, [*flags, "--num_devices", "2", "--mesh_spatial", "2"])
    assert dict(jm.mesh.shape) == {"data": 1, "spatial": 2}
    rng = np.random.default_rng(11)
    params = {n: fam._draw(getattr(jm.state, f"params_{n}"), rng) for n in "GDR"}
    rec = []
    jm.tx, jm.tx_R = tt._recording(jm.tx, "GD", rec), tt._recording(jm.tx_R, "R", rec)
    batch = _batch(2, size, 13)
    with pa.jax_float64():
        p = {n: fam._f64(t) for n, t in params.items()}
        state = replicate(jm.state.replace(
            params_G=p["G"], params_D=p["D"], params_R=p["R"],
            opt_G={"G": jm.tx.init(p["G"]), "R": jm.tx_R.init(p["R"])},
            opt_D=jm.tx.init(p["D"])), jm.mesh)
        sharded = shard_batch(jm.mesh, {k: np.asarray(v, np.float64) for k, v in batch.items()},
                              shard_spatial=True)
        assert len(sharded["A"].sharding.device_set) == 2
        _, _, alphas = a5._jax_draws(state.rng, 2, 1, False, jnp.float64)
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, sharded["A"], sharded["B"], jnp.float64(tp.LR), jm._gan_w_scalar(),
            jm._r_gate_scalar())
        jax.block_until_ready(state)
    grads = {}
    for tag, t in rec:
        # G's trunk block: ResnetBlock_0, or CheckpointResnetBlock_0 under --remat
        g = any(k.endswith("ResnetBlock_0") for k in t["params"])
        grads["R" if tag == "R" else ("G" if g else "D")] = t
    argv = [*RUN, *flags, "--checkpoints_dir", str(tmp_path / "port"), "--name", "port"]
    host = create_model(TrainOptions().parse(argv))
    host.to_dtype(F64)
    states = {n: flax_to_torch(params[n], host.nets()[n], F64) for n in "GDR"}
    ranks = _launch(_step_rank, 2, [*argv, "--num_devices", "2", "--mesh_spatial", "2"], states,
                    batch, 2, alphas if wgangp else None)
    (nets, losses), (nets1, losses1) = ranks
    assert losses == losses1
    want = {k: float(metrics[k]) for k in host.loss_names if k != "D_gp"}
    if wgangp:
        want["D_gp"] = want["D"] - 0.5 * (want["D_real"] + want["D_fake"])
        assert want["D_gp"] > 0
        losses = {k: losses[k] for k in want}
    fam._hold_losses(losses, want)
    # under wgangp D's last bias has a gradient of 0 in JAX (-mean real +
    # mean fake) and of roundoff here: held as the norms' biases are
    zero = {f"Conv_{host.netD.n_layers + 1}.bias"} if wgangp else set()
    for n in "GDR":
        net = host.nets()[n]
        for k, prm in net.named_parameters():
            value, grad = nets[n][k]
            assert torch.equal(value, nets1[n][k][0])
            prm.data.copy_(value)
            prm.grad = grad
        if n != "D" or not zero:
            fam._hold_step(n, net, grads[n], jax.device_get(getattr(state, f"params_{n}")),
                           states[n], 1)
            continue
        ref_g = flax_to_torch(grads[n], net, F64)
        ref_p = flax_to_torch(jax.device_get(state.params_D), net, F64)
        skip = tp._norm_biases(net) | zero
        for k, prm in net.named_parameters():
            if k in skip:
                scale = float(torch.linalg.vector_norm(ref_g[k.replace(".bias", ".weight")]))
                assert max(float(ref_g[k].abs().max()), float(prm.grad.abs().max())) \
                    <= pa.TOL64 * scale, (n, k)
                for p in (prm.detach(), ref_p[k]):
                    assert float((p - states[n][k]).abs().max()) <= 1.1 * tp.LR, (n, k)
                continue
            assert pa._rel(prm.grad, ref_g[k]) <= pa.TOL64, (n, k, pa._rel(prm.grad, ref_g[k]))
            assert float((prm.detach() - ref_p[k]).abs().max()) <= 1e-10, (n, k)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
TRAIN = [*RUN, *SPATIAL, *A5, "--batch_size", "2", "--synthetic_size", "4", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--save_epoch_freq", "1", "--display_freq", "0",
         "--print_freq", "4", "--serial_batches", "--no_flip"]


def _train_argv(root, name, devices, *extra):
    return [*TRAIN, "--num_devices", str(devices), "--checkpoints_dir", str(root), "--name",
            name, *extra]


def test_resume_in_one_process_from_spatial(tmp_path):
    """An epoch at (W, s) = (2, 2), saved by rank 0 (the pool's frames
    gathered), resumed in one process with --continue_train for a second:
    the uninterrupted one-process run's two epochs."""
    one = tp._main(_train_argv(tmp_path, "one", 1, "--n_epochs", "2"))
    digests = tp._main(_train_argv(tmp_path, "split", 2, "--mesh_spatial", "2"))
    assert digests[0] == digests[1]
    saved = torch.load(tmp_path / "split" / "1_state.pth", weights_only=True)
    assert tuple(saved["pool"]["images"].shape) == (4, 3, 64, 64)
    resumed = tp._main(_train_argv(tmp_path, "split", 1, "--n_epochs", "2", "--continue_train",
                                   "--epoch_count", "2"))
    assert resumed.step == one.step == 4
    tp._hold_same_state(tp._load(tmp_path, "split", 2, one), tp._load(tmp_path, "one", 2, one),
                        one, 4)


def test_eval_registration_at_spatial_two(tmp_path):
    """``test --eval_registration`` at --mesh_spatial 2 (2 CPU ranks, one
    spatial group) from a one-process checkpoint: the one-process
    summary, and rank 0's gallery."""
    tp._main(_train_argv(tmp_path, "run", 1))
    argv = ["--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path),
            "--name", "run", "--epoch", "1", "--eval_registration", *SPATIAL, "--num_test", "2",
            "--synthetic_size", "2", "--results_dir", str(tmp_path / "results")]
    want = port_test.main(argv)
    got = port_test.main([*argv, "--mesh_spatial", "2", "--results_dir",
                          str(tmp_path / "spatial")])
    # the summary is rounded to 4 decimals: one unit either way
    assert set(want) == {"ncc", "psnr", "l1", "epe_px"} and set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= 1e-4 for k in want), (got, want)
    assert (tmp_path / "spatial" / "run" / "test_1" / "eval.json").exists()


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------
# held in bands since the step flags' slice (tests/test_torch_spatial_flags.py),
# the template models' (tests/test_torch_spatial_templates.py: --norm batch to
# unet_256) and the chunks' (tests/test_torch_spatial_chunks.py)
HELD = [["--gan_mode", "wgangp"], ["--gan_mode", "vanilla"], ["--remat"], ["--g_batch"],
        ["--freeze_g"], ["--stn_field_source", "fake"], ["--stn_padding_mode", "border"],
        ["--stn_padding_mode", "reflection"], ["--stn_align_corners"],
        ["--netG", "resnet_9blocks"], ["--netD", "n_layers"], ["--norm", "batch"],
        ["--netD", "pixel"], ["--netG", "unet_256"], ["--steps_per_execution", "2"]]


@pytest.mark.parametrize("flag", HELD, ids=lambda f: " ".join(f))
def test_held_flags_accepted_under_spatial(tmp_path, flag):
    opt = TrainOptions().parse([*RUN, *SPATIAL, "--checkpoints_dir", str(tmp_path),
                                "--mesh_spatial", "2", *flag])
    create_model(opt)


# a G each model runs at 32^2 (pix2pix's template unet_256 needs 256^2)
OTHER_G = {"pix2pix": "resnet_6blocks", "cycle_gan": "resnet_6blocks"}


@pytest.mark.parametrize("model", ["pix2pix", "cycle_gan"])
def test_other_models_refused_under_spatial(tmp_path, model):
    """Refused under --mesh_spatial until the template models' slice: now
    each builds and takes a step at (data 1, spatial 2), the two ranks
    bit-identical (``tests/test_torch_spatial_templates.py`` holds the
    steps against one process and the JAX mesh)."""
    argv = [*RUN, "--model", model, "--netG", OTHER_G[model], "--crop_size", "32",
            "--load_size", "32", "--ngf", "4", "--ndf", "4", "--input_nc", "3", "--output_nc",
            "3", "--checkpoints_dir", str(tmp_path), "--mesh_spatial", "2", "--num_devices",
            "2", "--batch_size", "2", "--synthetic_size", "2", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--save_epoch_freq", "0", "--display_freq", "0"]
    digests = tp._main(argv)
    assert len(digests) == 2 and digests[0] == digests[1]


def _request_rank(argv, x):
    """The test model of ``argv`` (seeded weights) at this rank answering x."""
    parallel.set_mesh(TestOptions().parse(argv).mesh_spatial)
    model = create_model(TestOptions().parse(argv))
    model.set_input({"A": x, "A_paths": ["x"]})
    model.test()
    return dict(model.get_current_visuals())


def test_test_model_refused_under_spatial(tmp_path):
    """Refused under --mesh_spatial until the template models' slice: now
    the test model builds and answers a request at spatial 2, each rank
    the whole frames, within fp32 roundoff of one process's."""
    argv = [*RUN, "--model", "test", "--netG", "resnet_6blocks", "--crop_size", "32",
            "--load_size", "32", "--ngf", "4", "--input_nc", "3", "--output_nc", "3",
            "--checkpoints_dir", str(tmp_path), "--no_dropout"]
    x = np.random.default_rng(6).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want = _request_rank(argv, x)
    for got in _launch(_request_rank, 2, [*argv, "--mesh_spatial", "2"], x):
        assert list(got) == ["real", "fake"]
        assert all(float(np.abs(got[k] - want[k]).max()) <= 1e-5 for k in want)


def test_geometry_refusals(tmp_path):
    """s must divide the device count (the JAX package's make_mesh error)
    and the image height (its device_put of an H sharded on 'spatial');
    every other height is held (``test_band_geometry_held``)."""
    with pytest.raises(ValueError, match="must divide device count 3"):
        port_train.main([*RUN, *SPATIAL, "--checkpoints_dir", str(tmp_path), "--num_devices",
                         "3", "--mesh_spatial", "2"])
    with pytest.raises(ValueError, match="must divide device count 1"):
        port_train.main([*RUN, *SPATIAL, "--checkpoints_dir", str(tmp_path), "--mesh_spatial",
                         "2"])
    with pytest.raises(ValueError, match="does not divide the image height 30"):
        spatial.Band.split(30, 4, 0)


# geometries Band.conv refused until the band geometry's slice, held since:
# (bands, conv (k, stride, pad)) -> (output bounds, tops, bottoms); an empty
# output band reads the k rows of the row it would hold next
GEOMETRY_HELD = {
    # D at 32^2 over 2 ranks: 3 rows in bands of 2 and 1 -> 2 rows, bands
    # of 2 and none: rank 0 reads rows 2-3 (row 2 rank 1's band of 1, row
    # 3 padding), rank 1 the rows 1-4 of the row it would hold next
    "D 32^2, 3 -> 2 rows": ((((0, 2), (2, 3)), (4, 1, 1)), (((0, 2), (2, 2)), (1, 1), (2, 2))),
    # a band of 1 row sends 2
    "thin k5": ((((0, 1), (1, 8)), (5, 1, 2)), (((0, 1), (1, 8)), (2, 2), (2, 2))),
    # a halo of 3 rows reflected at the frame's edge from a band of 3
    "reflect k7 of 6 rows": ((((0, 3), (3, 6)), (7, 1, 3)), (((0, 3), (3, 6)), (3, 3), (3, 3))),
    # 40^2's STN at s = 2: 5 rows in 3 | 2 -> 3 rows in 2 | 1
    "40^2 STN k3 s2": ((((0, 3), (3, 5)), (3, 2, 1)), (((0, 2), (2, 3)), (1, 0), (1, 1))),
    # over 3 ranks, the middle band empty
    "empty middle k3": ((((0, 1), (1, 1), (1, 4)), (3, 1, 1)),
                        (((0, 1), (1, 1), (1, 4)), (1, 1, 1), (1, 2, 1))),
}


@pytest.mark.parametrize("name", list(GEOMETRY_HELD))
def test_band_geometry_held(tmp_path, name):
    """Each geometry Band.conv refused before is taken, with the bounds,
    tops and bottoms of its ownership rule (output row i is the band's
    that holds input row stride * i); and a height the levels split
    unevenly (40^2: G's and the STN's 5-row levels over 2 ranks) builds."""
    (bounds, conv), want = GEOMETRY_HELD[name]
    h = bounds[-1][1]
    out, tops, bottoms = spatial.Band(bounds, 0, h).conv(*conv)
    assert (out.bounds, tops, bottoms) == want
    if name == "40^2 STN k3 s2":
        opt = TrainOptions().parse([*RUN, *SPATIAL, "--crop_size", "40", "--load_size", "40",
                                    "--checkpoints_dir", str(tmp_path), "--mesh_spatial", "2"])
        create_model(opt)
