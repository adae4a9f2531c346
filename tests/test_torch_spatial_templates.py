"""The template models in bands (``--mesh_spatial``): ``--norm batch`` and
``none``, the UNet G, the pixel D, then ``pix2pix``, ``cycle_gan`` and
``test`` on the port's spatial mesh, as the JAX package runs them on its
('data', 'spatial') mesh (``nemar_tpu/models/base_model.py``: every model
is sharded on H alike).

The ranks run on the CPU over gloo (``parallel.launch``), in float64.
Held:

  * each new band form's plain version against the whole-frame plain
    version cut to the band, at s = 2 and 3, on the uneven, one-row and
    empty partitions of a 16-row frame (``test_torch_spatial_geometry.
    BOUNDS``), outputs and input gradients within 1e-12, weight gradients
    (the band's shares summed over the ranks) within 1e-12 of the largest:
    batch norm and no norm (``norm_act_band``), the plain ``ResnetBlock``
    (with dropout under batch norm), the k3 and k4 transposed convolutions
    (``conv_transpose_band``), the UNet G (batch norm with dropout on, and
    no norm), the n-layer D under batch norm and the pixel D; the frame's
    batch norm is the one-process one (``batch_norm_local``);
  * the dropout masks in bands: the one-process masks' rows bit for bit,
    with the global batch's rows too, and every rank's generator where the
    one-process draw leaves it;
  * one step at (data 1, spatial 2) and (2, 2) against one process, by
    ``test_torch_spatial._hold_ranks``'s rule: pix2pix (unet_128, 128^2,
    ngf 4, batch norm, dropout on), cycle_gan (resnet_6blocks, 32^2, ngf 8,
    a pool of 2) and NeMAR under --norm batch, --norm none, --netD pixel
    and --netG unet_128;
  * pix2pix (``test_torch_model_families.PIX2PIX``, --no_dropout) and two
    cycle_gan steps (``CYCLE``, JAX's pool draws fed) at (data 1, spatial
    2) against the JAX package's steps on its (data 1, spatial 2) mesh, by
    ``test_pix2pix_step_matches_jax``'s and ``test_cycle_gan_steps_match_
    jax``'s rules;
  * ``test.py --model test --mesh_spatial 2`` serving a cycle_gan G_A: its
    requests within 1e-12 of one process's (float64), and the gallery the
    entry point writes within one 8-bit level of the one-process one;
  * a cycle_gan epoch saved in bands: the checkpoint read in one process
    and written again is the same bit for bit, pools included (a
    checkpoint is the same at any width), and its second epoch in one
    process is the uninterrupted one-process run's (``test_torch_parallel.
    _hold_same_state``).
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_parallel as tp
import test_torch_spatial as ts
import test_torch_spatial_geometry as tg
from nemar_tpu_torch import parallel
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.options import TestOptions, TrainOptions
from nemar_tpu_torch.parallel import spatial

F64 = torch.float64
RUN = ts.RUN
PIX2PIX = ["--model", "pix2pix", "--netG", "unet_128", "--crop_size", "128", "--load_size",
           "128", "--ngf", "4", "--ndf", "4", "--input_nc", "3", "--output_nc", "3"]
CYCLE = ["--model", "cycle_gan", "--netG", "resnet_6blocks", "--crop_size", "32", "--load_size",
         "32", "--ngf", "8", "--ndf", "8", "--pool_size", "2", "--input_nc", "3", "--output_nc",
         "3"]
NEMAR = ["--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3"]
# (flags, size, channels of A)
CELLS = {
    "pix2pix": (PIX2PIX, 128, 3),
    "cycle_gan": (CYCLE, 32, 3),
    "nemar_norm_batch": ([*NEMAR, "--norm", "batch"], 32, 1),
    "nemar_norm_none": ([*NEMAR, "--norm", "none"], 32, 1),
    "nemar_pixel_d": ([*NEMAR, "--netD", "pixel"], 32, 1),
    "nemar_unet_128": ([*NEMAR, "--netG", "unet_128", "--crop_size", "128", "--load_size", "128",
                        "--ngf", "4", "--ndf", "4"], 128, 1),
}


@contextlib.contextmanager
def _one_process_norms():
    """Inside, batch norm takes the statistics of the tensor it is given
    (``batch_norm_local``), as one process does, though a process group is
    up: the whole-frame references of the band forms."""
    batch_norm = networks.batch_norm_global
    networks.batch_norm_global = networks.batch_norm_local
    try:
        yield
    finally:
        networks.batch_norm_global = batch_norm


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the band forms' plain versions
# ---------------------------------------------------------------------------
def _hold(errs, name, band_fn, frame_fn, frame, params, band, gen=None):
    """band_fn (this rank's band of ``frame`` and its Band -> the output's
    band, or (it, its Band)) against frame_fn on the frame, cut to the
    band: outputs and the input's gradient absolute, the gradients of
    ``params`` ((band's, frame's) pairs: the band's shares summed over the
    ranks) relative to the largest of them. ``gen``: reseeded before each (the
    same dropout draws)."""
    x = frame.narrow(2, band.r0, band.rows).clone().requires_grad_()
    fx = frame.clone().requires_grad_()
    if gen is not None:
        gen.manual_seed(5)
    out = band_fn(x, band)
    out, ob = out if isinstance(out, tuple) else (out, band)
    with _one_process_norms():
        if gen is not None:
            gen.manual_seed(5)
        ref = frame_fn(fx)
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(tuple(ref.shape)))
        ref_g = torch.autograd.grad(ref, [fx, *(q for _, q in params)], g, allow_unused=True)
    got_g = torch.autograd.grad(out, [x, *(p for p, _ in params)], g.narrow(2, ob.r0, ob.rows),
                                allow_unused=True)
    e = max(tg._err(out.detach(), ref.narrow(2, ob.r0, ob.rows)),
            tg._err(got_g[0], ref_g[0].narrow(2, band.r0, band.rows)))
    # (a bias a batch norm follows has a gradient of roundoff: the scale is
    # the module's largest gradient)
    pairs = [(torch.zeros_like(p) if a is None else a, torch.zeros_like(p) if b is None else b)
             for (p, _), a, b in zip(params, got_g[1:], ref_g[1:])]
    scale = max([float(b.abs().max()) for _, b in pairs] + [1e-300])
    for a, b in pairs:
        e = max(e, tg._err(ts._group_sum(a), b) / scale)
    errs[name] = e


def _pair(make, rng):
    """Two copies of the module ``make()`` with the same seeded weights
    (the band's and the frame's)."""
    a, b = make().double(), make().double()
    with torch.no_grad():
        for p in a.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))) * 0.3)
    b.load_state_dict(a.state_dict())
    return _cl_module(a), _cl_module(b)


def _cl_module(m):
    return m.to(memory_format=torch.channels_last)


def _params(a, b):
    return list(zip(a.parameters(), b.parameters()))


def _forms_rank(s):
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(17)
    frame = lambda *shape: _cl(torch.from_numpy(rng.standard_normal(shape)))  # noqa: E731
    errs = {}
    gen = torch.Generator()
    for bounds in tg.BOUNDS[s]:
        band = spatial.Band(bounds, j, tg.H)
        tag = str(bounds)
        for norm in ("batch", "none"):
            for act in ("relu", "leaky_relu", "none"):
                _hold(errs, f"norm {norm} {act} {tag}",
                      lambda x, b: networks.norm_act_band(x, b, act, norm),
                      lambda x: networks.norm_act(x, act, norm), frame(2, 3, tg.H, 5), [], band)
        for norm, drop in (("batch", True), ("none", False)):
            blk, ref = _pair(lambda: networks.ResnetBlock(4, norm, drop, gen), rng)
            _hold(errs, f"ResnetBlock {norm} dropout {drop} {tag}", blk, ref,
                  frame(2, 4, tg.H, 6), _params(blk, ref), band, gen)
        for k, p, crop in ((3, 0, True), (4, 1, False)):
            ct, ref = _pair(lambda: torch.nn.ConvTranspose2d(3, 2, k, stride=2, padding=p), rng)
            _hold(errs, f"ConvTranspose k{k} {tag}",
                  lambda x, b: networks.conv_transpose_band(ct, x, b),
                  lambda x: ref(x)[:, :, :2 * tg.H, :10] if crop else ref(x),
                  frame(2, 3, tg.H, 5), _params(ct, ref), band)
        for norm, drop in (("batch", True), ("none", False)):
            g, ref = _pair(lambda: networks.UnetGenerator(3, 2, 4, 4, norm, drop, gen), rng)
            _hold(errs, f"UNet G {norm} dropout {drop} {tag}", g, ref, frame(2, 3, tg.H, 16),
                  _params(g, ref), band, gen)
        d, ref = _pair(lambda: networks.NLayerDiscriminator(3, 4, 2, "batch"), rng)
        _hold(errs, f"n-layer D batch {tag}", d, ref, frame(2, 3, tg.H, 12), _params(d, ref), band)
        d, ref = _pair(lambda: networks.PixelDiscriminator(3, 4, "batch"), rng)
        _hold(errs, f"pixel D batch {tag}", d, ref, frame(2, 3, tg.H, 7), _params(d, ref), band)
    return errs


@pytest.mark.parametrize("s", [2, 3])
def test_band_forms_on_uneven_thin_and_empty_bands(s):
    for errs in ts._launch(_forms_rank, s, s):
        assert len(errs) == len(tg.BOUNDS[s]) * 14
        assert all(e <= 1e-12 for e in errs.values()), {k: e for k, e in errs.items()
                                                        if not e <= 1e-12}


def _dropout_rank(s):
    """-> per case whether this rank's masked band is the one-process
    masked frame's rows bit for bit, and its generator where the frame's
    draw leaves it."""
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(19)
    out = {}
    gen = torch.Generator()
    drop = networks.Dropout(0.5, gen)
    for bounds in tg.BOUNDS[s]:
        band = spatial.Band(bounds, j, tg.H)
        x = _cl(torch.from_numpy(rng.standard_normal((4, 6, tg.H, 5))))
        gen.manual_seed(3)
        drop.rows = None
        want, after = drop(x), gen.get_state()
        gen.manual_seed(3)
        got = drop(_cl(x[:, :, band.r0:band.r1]), band)
        out[str(bounds)] = (torch.equal(got, want[:, :, band.r0:band.r1])
                            and torch.equal(gen.get_state(), after))
        # rows 2..3 of a global batch of 4, as a data rank holds them
        gen.manual_seed(3)
        drop.rows = (4, slice(2, 4))
        got = drop(_cl(x[2:, :, band.r0:band.r1]), band)
        out[f"rows {bounds}"] = torch.equal(got, want[2:, :, band.r0:band.r1])
    return out


@pytest.mark.parametrize("s", [2, 3])
def test_dropout_masks_in_bands_are_the_frames_rows(s):
    for out in ts._launch(_dropout_rank, s, s):
        assert len(out) == 2 * len(tg.BOUNDS[s]) and all(out.values()), out


# ---------------------------------------------------------------------------
# the steps against one process
# ---------------------------------------------------------------------------
def _pairs(n, size, nc_a, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, size, size, c)).astype(np.float32)
            for k, c in (("A", nc_a), ("B", 3))}


_ONE = {}


def _cell_inputs(root):
    """Per cell: (argv, states, batch, the one-process step), the
    one-process steps computed once a process."""
    out = {}
    for name, (flags, size, nc_a) in CELLS.items():
        argv = [*RUN, *flags, "--batch_size", "2", "--checkpoints_dir", str(root / name)]
        if name not in _ONE:
            states, batch = ts._random_states(argv), _pairs(2, size, nc_a, 23)
            _ONE[name] = (states, batch, ts._step_rank(argv, states, batch, 1))
        out[name] = (argv, *_ONE[name])
    return out


@pytest.mark.parametrize("devices", [2, 4], ids=["data1_spatial2", "data2_spatial2"])
def test_template_steps_equal_one_process(tmp_path, devices):
    """One step of each cell at (data W / 2, spatial 2) against one process
    (``test_torch_spatial._hold_ranks``); the ranks' parameters
    bit-identical."""
    cells = _cell_inputs(tmp_path)
    runs = [([*argv, "--num_devices", str(devices), "--mesh_spatial", "2"], states, batch)
            for argv, states, batch, _ in cells.values()]
    ranks = ts._launch(tg._steps_rank, devices, runs, 2)
    for c, (argv, _, _, (want_nets, want)) in enumerate(cells.values()):
        ts._hold_ranks([r[c] for r in ranks], want_nets, want,
                       create_model(TrainOptions().parse(argv)))


# ---------------------------------------------------------------------------
# against the JAX package's (data 1, spatial 2) mesh
# ---------------------------------------------------------------------------
def _jax_mesh_model(root, flags):
    import test_torch_model_families as fam

    jm = fam._jax_model(root, [*flags, "--num_devices", "2", "--mesh_spatial", "2"])
    assert dict(jm.mesh.shape) == {"data": 1, "spatial": 2}
    return jm


def _jax_sharded(jm, batch):
    from nemar_tpu.parallel import shard_batch

    sharded = shard_batch(jm.mesh, {k: np.asarray(v, np.float64) for k, v in batch.items()},
                          shard_spatial=True)
    assert len(sharded["A"].sharding.device_set) == 2
    return sharded["A"], sharded["B"]


def _port_argv(root, flags):
    return [*RUN, *flags, "--checkpoints_dir", str(root / "port"), "--name", "port"]


def _hold_rank_nets(host, ranks, names):
    """Rank 0's parameters and gradients into the host model's nets (the
    ranks' bit-identical)."""
    (nets, _), (nets1, _) = ranks
    for n in names:
        for k, prm in host.nets()[n].named_parameters():
            value, grad = nets[n][k]
            assert torch.equal(value, nets1[n][k][0]), (n, k)
            prm.data.copy_(value)
            prm.grad = grad


def test_pix2pix_step_matches_jax_mesh(tmp_path):
    """pix2pix (unet_128, 128^2, ngf 4, batch 2, --norm batch --no_dropout,
    vanilla) at (data 1, spatial 2) against the JAX package's step on its
    (data 1, spatial 2) mesh, both in float64 from the same parameters:
    losses and gradients within 1e-9, parameters within 1e-10
    (``test_pix2pix_step_matches_jax``'s rule). The UNet's innermost level
    of one row is split 1 | 0."""
    import jax
    import jax.numpy as jnp
    import test_torch_model_families as fam
    import test_torch_nemar_pallas_all as pa
    import test_torch_nemar_train as tt
    from nemar_tpu.parallel import replicate
    from nemar_tpu_torch.utils.convert import flax_to_torch

    flags = [*fam.PIX2PIX]
    jm = _jax_mesh_model(tmp_path, flags)
    rng = np.random.default_rng(0)
    params = {"G": fam._draw(jm.state.params_G, rng), "D": fam._draw(jm.state.params_D, rng)}
    rec = []
    jm.tx = tt._recording(jm.tx, "GD", rec)
    (batch,) = fam._batches(1, 3, 3, 128, 1)
    with pa.jax_float64():
        p = {n: fam._f64(t) for n, t in params.items()}
        state = replicate(jm.state.replace(params_G=p["G"], params_D=p["D"],
                                           opt_G=jm.tx.init(p["G"]), opt_D=jm.tx.init(p["D"])),
                          jm.mesh)
        state, metrics = jax.jit(lambda *a: jm._train_step_impl(*a))(
            state, *_jax_sharded(jm, batch), jnp.float64(fam.LR))
        jax.block_until_ready(state)
    grads = {("G" if "ConvTranspose_0" in t["params"] else "D"): t for _, t in rec}
    assert set(grads) == {"G", "D"}

    argv = _port_argv(tmp_path, flags)
    host = create_model(TrainOptions().parse(argv))
    host.to_dtype(F64)
    states = {n: flax_to_torch(params[n], host.nets()[n], F64) for n in "GD"}
    ranks = ts._launch(ts._step_rank, 2, [*argv, "--num_devices", "2", "--mesh_spatial", "2"],
                       states, batch, 2)
    assert ranks[0][1] == ranks[1][1]
    fam._hold_losses(ranks[0][1], {k: float(metrics[k]) for k in host.loss_names})
    _hold_rank_nets(host, ranks, "GD")
    for n in "GD":
        fam._hold_step(n, host.nets()[n], grads[n],
                       jax.device_get(getattr(state, f"params_{n}")), states[n], 1)


def _cycle_rank(argv, states, batches, draws):
    """Two cycle_gan steps at this rank, the pools' draws fed: per step
    ({net: {key: (param, grad)}}, losses, {pool: (its frames, count)})."""
    parallel.set_mesh(2)
    opt = TrainOptions().parse(argv)
    model = create_model(opt)
    model.to_dtype(F64)
    for n, sd in states.items():
        model.nets()[n].load_state_dict(sd)
    model.setup(opt)
    model.set_epoch(1)
    band = model.band_of(opt.crop_size)
    out = []
    for batch, step_draws in zip(batches, draws):
        model._pool_draws = lambda n, it=iter(step_draws): next(it)
        model.set_input(batch)
        model.optimize_parameters()
        nets = {n: {k: (p.detach().clone(), None if p.grad is None else p.grad.clone())
                    for k, p in net.named_parameters()} for n, net in model.nets().items()}
        pools = {k: (spatial.gather_frame(p[0], band), int(p[1]))
                 for k, p in model.pools.items()}
        out.append((nets, dict(model.get_current_losses()), pools))
    return out


def test_cycle_gan_steps_match_jax_mesh(tmp_path):
    """Two cycle_gan steps (resnet_6blocks, 32^2, ngf 8, batch 2, a pool of
    2: it fills in the first step, the second swaps) at (data 1, spatial 2)
    against the JAX package's on its (data 1, spatial 2) mesh, the port fed
    JAX's pool draws: losses, gradients, parameters and the pools' frames
    after each step (``test_cycle_gan_steps_match_jax``'s rule)."""
    import jax
    import jax.numpy as jnp
    import test_torch_model_families as fam
    import test_torch_nemar_pallas_all as pa
    import test_torch_nemar_train as tt
    from nemar_tpu.parallel import replicate
    from nemar_tpu.utils.image_pool import PoolState
    from nemar_tpu_torch.utils.convert import flax_to_torch

    flags = [*fam.CYCLE]
    jm = _jax_mesh_model(tmp_path, flags)
    rng = np.random.default_rng(2)
    names = ("G_A", "G_B", "D_A", "D_B")
    params = {n: fam._draw(getattr(jm.state, f"params_{n}"), rng) for n in names}
    rec = []
    jm.tx = tt._recording(jm.tx, "GD", rec)
    batches = fam._batches(2, 3, 3, 32, 3)
    out, all_draws = [], []
    with pa.jax_float64():
        p = {n: fam._f64(t) for n, t in params.items()}
        empty = PoolState(jnp.zeros((fam.POOL, 32, 32, 3), jnp.float64), jnp.int32(0))
        state = replicate(jm.state.replace(
            **{f"params_{n}": p[n] for n in names},
            opt_G=jm.tx.init({"A": p["G_A"], "B": p["G_B"]}),
            opt_D=jm.tx.init({"A": p["D_A"], "B": p["D_B"]}), pool_A=empty, pool_B=empty),
            jm.mesh)
        step = jax.jit(lambda *a: jm._train_step_impl(*a))
        for batch in batches:
            all_draws.append(fam._cycle_draws(jax.device_get(state.rng), 2)[1])
            rec.clear()
            # replicated again: the step's input shardings, one compile
            state, metrics = step(replicate(state, jm.mesh), *_jax_sharded(jm, batch),
                                  jnp.float64(fam.LR))
            jax.block_until_ready(state)
            grads = {}
            for _, t in rec:
                kind = "G" if "ResnetBlock_0" in t["A"]["params"] else "D"
                grads.update({f"{kind}_{k}": t[k] for k in "AB"})
            out.append(({k: float(v) for k, v in metrics.items()}, grads,
                        {n: jax.device_get(getattr(state, f"params_{n}")) for n in names},
                        {k: (np.asarray(getattr(state, f"pool_{k}").images),
                             int(getattr(state, f"pool_{k}").count)) for k in "AB"}))
    swaps = [bool(u and i < fam.POOL) for draws in all_draws[1] for u, i in zip(*draws)]
    assert any(swaps), "the second step swaps nothing: the pool's path to D is not reached"

    argv = _port_argv(tmp_path, flags)
    host = create_model(TrainOptions().parse(argv))
    host.to_dtype(F64)
    start = {n: flax_to_torch(params[n], host.nets()[n], F64) for n in names}
    ranks = ts._launch(_cycle_rank, 2, [*argv, "--num_devices", "2", "--mesh_spatial", "2"],
                       start, batches, all_draws)
    for i, (losses, grads, new, pools) in enumerate(out):
        steps = [r[i] for r in ranks]
        assert steps[0][1] == steps[1][1]
        fam._hold_losses(steps[0][1], {k: losses[k] for k in host.loss_names})
        _hold_rank_nets(host, [s[:2] for s in steps], names)
        for n in names:
            fam._hold_step(n, host.nets()[n], grads[n], new[n], start[n], i + 1)
        for k in "AB":
            images, count = steps[0][2][k]
            assert torch.equal(images, steps[1][2][k][0])
            assert count == pools[k][1] == fam.POOL
            np.testing.assert_allclose(images.permute(0, 2, 3, 1).numpy(), pools[k][0],
                                       rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# test.py, and a checkpoint across widths
# ---------------------------------------------------------------------------
SERVE = ["--model", "test", "--model_suffix", "_A", "--netG", "resnet_6blocks", "--ngf", "8",
         "--crop_size", "32", "--load_size", "32", "--input_nc", "3", "--output_nc", "3",
         "--no_dropout", "--dataset_mode", "synthetic", "--gpu_ids", "-1"]


def _serve_rank(argv, requests, spatial_size):
    """The test model of ``argv`` at this rank (as test.py's ``_test_rank``
    builds it) answering each request in float64: -> the visuals."""
    parallel.set_mesh(spatial_size)
    opt = TestOptions().parse(argv)
    model = create_model(opt)
    model.setup(opt)
    model.netG.double()
    out = []
    for x in requests:
        model.set_input({"A": x, "A_paths": ["x"]})
        model.real = model.real.double()
        model.test()
        out.append(dict(model.get_current_visuals()))
    return out


def _images(root):
    from PIL import Image

    folder = root / "cyc" / "test_latest" / "images"
    return {f: np.asarray(Image.open(folder / f), np.int64) for f in sorted(os.listdir(folder))}


def test_test_model_at_spatial_two_equals_one_process(tmp_path):
    """``test.py --model test --model_suffix _A --mesh_spatial 2`` on a
    cycle_gan G_A the port saved: the requests' visuals within 1e-12 of one
    process's in float64, and the entry point's gallery within one 8-bit
    level of the one-process gallery."""
    train = create_model(TrainOptions().parse([*RUN, *CYCLE, "--checkpoints_dir", str(tmp_path),
                                               "--name", "cyc"]))
    train.setup(train.opt)
    train.save_networks("latest")
    argv = [*SERVE, "--checkpoints_dir", str(tmp_path), "--name", "cyc"]
    rng = np.random.default_rng(29)
    requests = [rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    want = _serve_rank(argv, requests, 1)
    for got in ts._launch(_serve_rank, 2, argv, requests, 2):
        for g, w in zip(got, want):
            assert list(g) == ["real", "fake"]
            assert all(float(np.abs(g[k] - w[k]).max()) <= 1e-12 for k in w)
    gallery = [*argv, "--num_test", "2", "--synthetic_size", "2"]
    port_test.main([*gallery, "--results_dir", str(tmp_path / "one")])
    port_test.main([*gallery, "--results_dir", str(tmp_path / "two"), "--mesh_spatial", "2"])
    one, two = _images(tmp_path / "one"), _images(tmp_path / "two")
    assert len(one) == 4 and list(one) == list(two)
    assert all(int(np.abs(one[f] - two[f]).max()) <= 1 for f in one)


CYCLE_TRAIN = [*RUN, *CYCLE, "--batch_size", "2", "--synthetic_size", "4", "--n_epochs", "1",
               "--n_epochs_decay", "0", "--save_epoch_freq", "1", "--display_freq", "0",
               "--print_freq", "4", "--serial_batches", "--no_flip"]


def _cycle_argv(root, name, devices, *extra):
    return [*CYCLE_TRAIN, "--num_devices", str(devices), "--checkpoints_dir", str(root), "--name",
            name, *extra]


def _same(a, b) -> bool:
    """a and b equal bit for bit (tensors) or by value, nested."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


def test_cycle_gan_resume_in_one_process_from_spatial(tmp_path):
    """A cycle_gan epoch at (data 1, spatial 2), saved by rank 0 with the
    pools' frames gathered: read in one process and written again it is
    the same checkpoint bit for bit (nets, Adams, step, the generator, the
    pools); resumed in one process with --continue_train for a second
    epoch it is the uninterrupted one-process run's two epochs."""
    one = tp._main(_cycle_argv(tmp_path, "one", 1, "--n_epochs", "2"))
    digests = tp._main(_cycle_argv(tmp_path, "split", 2, "--mesh_spatial", "2"))
    assert digests[0] == digests[1]
    saved = torch.load(tmp_path / "split" / "1_state.pth", weights_only=True)
    assert {k: tuple(p["images"].shape) for k, p in saved["pools"].items()} == \
        {k: (2, 3, 32, 32) for k in "AB"}
    opt = TrainOptions().parse([*_cycle_argv(tmp_path, "split", 1, "--continue_train",
                                             "--epoch", "1")])
    again = create_model(opt)
    again.to_dtype(F64)
    again.setup(opt)
    again.save_networks("again")
    for stem in ("state", "net_G_A", "net_G_B", "net_D_A", "net_D_B"):
        a = torch.load(tmp_path / "split" / f"1_{stem}.pth", weights_only=True)
        b = torch.load(tmp_path / "split" / f"again_{stem}.pth", weights_only=True)
        assert _same(a, b), stem
    resumed = tp._main(_cycle_argv(tmp_path, "split", 1, "--n_epochs", "2", "--continue_train",
                                   "--epoch_count", "2"))
    assert resumed.step == one.step == 4
    tp._hold_same_state(tp._load(tmp_path, "split", 2, one), tp._load(tmp_path, "one", 2, one),
                        one, 4)
