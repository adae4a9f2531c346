"""The band geometry of ``--mesh_spatial`` on the port: every height the JAX
package's spatial mesh runs (``nemar_tpu/parallel/mesh.py``: GSPMD splits
H over the axis whatever the levels' heights), so bands that are uneven,
one row or empty, halos served by any rank, and rows re-cut where two
levels meet (``nemar_tpu_torch/parallel/spatial.py``: ``Band``,
``exchange_rows``, ``reband``, ``fold_halo_rows``).

The ranks run on the CPU over gloo (``parallel.launch``), in float64.
Held:

  * the primitives at s = 2, 3 and 4, on partitions of a 16-row frame with
    uneven, one-row and empty bands: ``exchange_rows`` (reflect and zeros,
    halos of up to 3 rows across one-row bands, per-rank counts from
    ``Band.conv``) against the padded frame of one process, exactly;
    ``reband`` between such partitions exactly; both adjoints by the
    dot-product identity summed over the ranks (within 1e-14 of the sum of
    the products' magnitudes); ``fold_halo_rows`` equal to the exchange's
    adjoint; the moves twice differentiable (``torch.autograd.
    gradgradcheck`` at s = 2 and 3, on every rank the frame replicated);
  * each band form's plain version (K-in forward and backward, K-block,
    K-convt, K-head, the convolutions of the UNet and D, the TV of order 1
    and 2, the pyramid's re-cut pools) against the whole-frame plain
    version cut to the band, at uneven, one-row and empty bands, within
    ``test_band_forms_against_the_frame``'s 1e-12;
  * one NeMAR step at (data 1, spatial 2) and (2, 2) against one process,
    within ``test_torch_parallel.py``'s float64 tolerances, at the JAX
    package's own spatial configuration (``__graft_entry__.py``: 32^2, ngf,
    ndf and stn_ngf 8, --stn_depth 3; D's bands of 2 and 1 rows, then 2
    and none), 32^2 at --stn_depth 5 (the STN's bottom level of one row:
    an empty band), 40^2 at --stn_depth 3 (the STN's 5 rows in 3 | 2,
    up-sampled to 6 | 4 against a skip of 5 | 5; D's last level 3 | 0),
    36^2 at --stn_depth 2 (G's trunk of 5 | 4 rows, its output 20 | 16
    re-cut to 18 | 18), 32^2 with --recon_pyramid 5 (bands of one row
    pooled, re-cut first) and the graft configuration under wgangp;
  * the graft configuration at (data 1, spatial 2) against the JAX
    package's step on its (data 1, spatial 2) virtual CPU mesh.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_spatial as ts
from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.models.stn.unet_stn import smoothness_loss, smoothness_loss_band
from nemar_tpu_torch.ops.conv_fused import resblock_band_plain, resblock_plain
from nemar_tpu_torch.ops.conv_head import conv_head_band, conv_head_plain
from nemar_tpu_torch.ops.convt_fused import convt_band_plain, convt_in_plain
from nemar_tpu_torch.ops.norm import instance_norm_act_band, instance_norm_act_plain
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.parallel import spatial

F64 = torch.float64
H = 16
# partitions of a 16-row frame over s ranks: uneven, one-row and empty bands
BOUNDS = {
    2: [((0, 9), (9, 16)), ((0, 1), (1, 16)), ((0, 15), (15, 16)), ((0, 0), (0, 16)),
        ((0, 16), (16, 16)), ((0, 8), (8, 16))],
    3: [((0, 1), (1, 2), (2, 16)), ((0, 7), (7, 7), (7, 16)), ((0, 14), (14, 15), (15, 16)),
        ((0, 5), (5, 11), (11, 16))],
    4: [((0, 1), (1, 1), (1, 2), (2, 16)), ((0, 5), (5, 6), (6, 6), (6, 16)),
        ((0, 0), (0, 13), (13, 14), (14, 16)), ((0, 4), (4, 8), (8, 12), (12, 16))],
}
HALOS = ((1, 1, "reflect"), (3, 3, "reflect"), (1, 0, "zeros"), (1, 2, "zeros"),
         (0, 2, "zeros"), (3, 3, "zeros"))
CONVS = ((3, 2, 1), (3, 1, 1), (4, 2, 1), (4, 1, 1), (7, 1, 3))


def _padded(frame, top, bottom, mode):
    """The one-process padding of an NCHW frame in H."""
    if mode == "reflect":
        return F.pad(frame, (0, 0, top, bottom), mode="reflect")
    return F.pad(frame, (0, 0, top, bottom))


def _products(y, g, x, gx):
    """This rank's <y, g>, <x, gx> and sum of |y g|: the dot-product
    identity's terms, summed over the group at the end (one all-gather)."""
    return [float((y * g).sum()), float((x * gx).sum()), float((y * g).abs().sum())]


class _Replicated(torch.autograd.Function):
    """A frame every rank holds (the same values) -> this rank's band of
    it; the adjoint gathers the bands' gradients into the frame's, so that
    a function of the replicated frame has, on every rank, the frame's
    gradient (what ``gradgradcheck`` perturbs on every rank at once)."""

    @staticmethod
    def forward(ctx, frame, band):
        ctx.band = band
        return frame.narrow(2, band.r0, band.rows).clone()

    @staticmethod
    def backward(ctx, g):
        return _Gathered.apply(g, ctx.band), None


class _Gathered(torch.autograd.Function):
    """The bands -> the frame on every rank; its adjoint keeps this rank's
    band of the (replicated) gradient: ``_Replicated``'s pair."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        parts = spatial._gather(spatial._pad_rows(x, 2, band.most))
        return torch.cat([p.narrow(2, 0, b - a) for p, (a, b) in zip(parts, band.bounds)], dim=2)

    @staticmethod
    def backward(ctx, g):
        return _Replicated.apply(g, ctx.band), None


def _primitives_rank(s):
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(3)
    frame = torch.from_numpy(rng.standard_normal((2, 3, H, 5)))
    terms = []  # the dot-product identity's, every case's
    bounds = BOUNDS[s]
    for b_i, bb in enumerate(bounds):
        band = spatial.Band(bb, j, H)
        x0 = frame[:, :, band.r0:band.r1]
        cases = [((t,) * s, (u,) * s, m, t, u) for t, u, m in HALOS]
        for k, stride, pad in CONVS:
            _, tops, bottoms = band.conv(k, stride, pad)
            cases.append((tops, bottoms, "zeros", max(tops + (0,)), max(bottoms + (0,))))
        for tops, bottoms, mode, pt, pb in cases:
            x = x0.clone().requires_grad_()
            got = spatial.exchange_rows(x, band, tops, bottoms, dim=2, mode=mode)
            # the rows [r0 - top, r1 + bottom) of the frame padded by pt, pb
            want = _padded(frame, pt, pb, mode)[:, :, pt + band.r0 - tops[j]:
                                                 pt + band.r1 + bottoms[j]]
            assert torch.equal(got, want), (bb, j, tops, bottoms, mode)
            g = torch.from_numpy(np.random.default_rng(4 + j).standard_normal(tuple(got.shape)))
            (gx,) = torch.autograd.grad(got, x, g)
            terms.append(_products(got.detach(), g, x0, gx))
            if (tops, bottoms, mode) == ((1,) * s, (1,) * s, "reflect"):
                # fold_halo_rows: the padded gradient's rows folded in place
                d = g.clone()
                spatial.fold_halo_rows(d, band, dim=2)
                assert torch.equal(d[:, :, 1:1 + band.rows], gx)
                assert not d[:, :, :1].any() and not d[:, :, 1 + band.rows:].any()
        # reband to the next two partitions, and back
        for cc in (bounds[(b_i + 1) % len(bounds)], bounds[(b_i + 2) % len(bounds)]):
            dst = spatial.Band(cc, j, H)
            x = x0.clone().requires_grad_()
            got = spatial.reband(x, band, dst)
            assert torch.equal(got, frame[:, :, dst.r0:dst.r1]), (bb, cc, j)
            g = torch.from_numpy(np.random.default_rng(9 + j).standard_normal(tuple(got.shape)))
            (gx,) = torch.autograd.grad(got, x, g)
            terms.append(_products(got.detach(), g, x0, gx))
            assert torch.equal(spatial.reband(got.detach(), dst, band), x0)
        if b_i != 1 or s == 4:
            continue
        # twice differentiable: the exchange (3 rows, reflect) across a
        # one-row band and a reband of a replicated tiny frame,
        # gradgradcheck'd on every rank at once (at s = 2 and 3)
        tiny = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 1, H, 1)))
        tiny.requires_grad_()
        other = spatial.Band(bounds[(b_i + 1) % len(bounds)], j, H)

        def moved(f):
            x = _Replicated.apply(f, band)
            y = spatial.exchange_rows(x, band, (3,) * s, (3,) * s, dim=2, mode="reflect")
            z = spatial.reband(x * x, band, other)
            return (_Gathered.apply(y[:, :, 3:3 + band.rows] + y[:, :, :band.rows], band),
                    _Gathered.apply(z, other))

        assert torch.autograd.gradgradcheck(moved, (tiny,), eps=1e-6, atol=1e-8, rtol=1e-6)
    lhs, rhs, scale = ts._group_sum(torch.tensor(terms, dtype=F64)).unbind(1)
    return float(((lhs - rhs).abs() / scale).max())


@pytest.mark.parametrize("s", [2, 3, 4])
def test_primitives_on_uneven_thin_and_empty_bands(s):
    assert max(ts._launch(_primitives_rank, s, s)) <= 1e-14


# ---------------------------------------------------------------------------
# the band forms' plain versions
# ---------------------------------------------------------------------------
# (a 16-row frame's partition, an 8-row one for K-convt's input)
FORMS = {
    2: [("uneven", ((0, 9), (9, 16)), ((0, 5), (5, 8))),
        ("thin", ((0, 1), (1, 16)), ((0, 1), (1, 8))),
        ("empty first", ((0, 0), (0, 16)), ((0, 0), (0, 8))),
        ("empty last", ((0, 16), (16, 16)), ((0, 8), (8, 8)))],
    3: [("thin, empty", ((0, 1), (1, 1), (1, 16)), ((0, 1), (1, 1), (1, 8))),
        ("uneven, thin", ((0, 7), (7, 8), (8, 16)), ((0, 3), (3, 4), (4, 8)))],
}


def _err(a, b):
    return float((a - b).detach().abs().max()) if a.numel() else 0.0


def _forms_rank(s):
    """Each band form's plain version against the frame's, cut to the band:
    {case: error}, outputs and input gradients absolute, weight gradients
    (the band's shares summed over the ranks) relative to the largest."""
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(7)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape))  # noqa: E731
    errs = {}

    def hold(name, band_fn, frame_fn, inputs, weights, band, out_band, dim):
        xs = [i.narrow(dim, band.r0, band.rows).clone().requires_grad_() for i in inputs]
        ws = [w.clone().requires_grad_() for w in weights]
        out = band_fn(*xs, *ws)
        fx = [i.clone().requires_grad_() for i in inputs]
        fw = [w.clone().requires_grad_() for w in weights]
        ref = frame_fn(*fx, *fw)
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(tuple(ref.shape)))
        got_g = torch.autograd.grad(out, xs + ws, g.narrow(dim, out_band.r0, out_band.rows),
                                    allow_unused=True)
        ref_g = torch.autograd.grad(ref, fx + fw, g)
        e = _err(out.detach(), ref.narrow(dim, out_band.r0, out_band.rows))
        for a, b in zip(got_g[:len(xs)], ref_g[:len(xs)]):
            e = max(e, _err(a, b.narrow(dim, band.r0, band.rows)))
        for a, b in zip(got_g[len(xs):], ref_g[len(xs):]):
            a = torch.zeros_like(b) if a is None else a
            e = max(e, _err(ts._group_sum(a), b) / float(b.abs().max()))
        errs[name] = e

    for tag, b16, b8 in FORMS[s]:
        band, band8 = spatial.Band(b16, j, 16), spatial.Band(b8, j, 8)
        for act in ("none", "leaky_relu"):
            hold(f"K-in {act} {tag}", lambda x: instance_norm_act_band(x, band, act),
                 lambda x: instance_norm_act_plain(x, act), [t(2, 16, 6, 5)], [], band, band, 1)
        hold(f"K-block {tag}", lambda x, w1, w2: resblock_band_plain(x, w1, w2, band),
             resblock_plain, [t(2, 16, 6, 8)], [t(3, 3, 8, 8) * 0.2, t(3, 3, 8, 8) * 0.2],
             band, band, 1)
        hold(f"K-convt {tag}", lambda x, w: convt_band_plain(x, w, band8), convt_in_plain,
             [t(2, 8, 5, 6)], [t(3, 3, 6, 4) * 0.2], band8, band8.up(2), 1)
        hold(f"K-head {tag}", lambda x, w: conv_head_band(x, w, band), conv_head_plain,
             [t(1, 16, 9, 4)], [t(7, 7, 4, 3) * 0.1], band, band, 1)
        for k, stride, pad in CONVS[:4]:
            conv = torch.nn.Conv2d(3, 4, k, stride=stride, padding=pad).double()
            with torch.no_grad():  # the same weights on every rank
                conv.weight.copy_(t(4, 3, k, k) * 0.2)
                conv.bias.copy_(t(4))
            hold(f"conv k{k} s{stride} {tag}", lambda x: networks.conv_band(conv, x, band)[0],
                 conv, [t(2, 3, 16, 6)], [], band, band.conv(k, stride, pad)[0], 2)
        for order in (1, 2):
            flow = t(2, 16, 7, 2)
            fb = flow[:, band.r0:band.r1].clone().requires_grad_()
            ff = flow.clone().requires_grad_()
            share = smoothness_loss_band(fb, band, order=order)
            (gb,) = torch.autograd.grad(share, fb)
            want = smoothness_loss(ff, order=order)
            (gf,) = torch.autograd.grad(want, ff)
            errs[f"TV order {order} {tag}"] = max(
                abs(float(ts._group_sum(share.detach()) - want)),
                _err(gb, gf[:, band.r0:band.r1]))
        # the pyramid: each level's bands re-cut to even bounds, then pooled
        x, bd = t(2, 3, 16, 16), band
        xb, e = x[:, :, bd.r0:bd.r1], 0.0
        for _ in range(4):
            even = bd.aligned(2)
            xb, bd = spatial.pool2(spatial.reband(xb, bd, even)), even.pooled(2)
            x = F.avg_pool2d(x, 2)
            e = max(e, _err(xb, x[:, :, bd.r0:bd.r1]),
                    abs(float(ts._group_sum(spatial.frame_mean(xb, bd)) - x.mean())))
        errs[f"pyramid {tag}"] = e
    return errs


@pytest.mark.parametrize("s", [2, 3])
def test_band_forms_on_uneven_thin_and_empty_bands(s):
    for errs in ts._launch(_forms_rank, s, s):
        assert all(e <= 1e-12 for e in errs.values()), {k: e for k, e in errs.items()
                                                        if not e <= 1e-12}


# ---------------------------------------------------------------------------
# the step at the JAX package's spatial geometries
# ---------------------------------------------------------------------------
# __graft_entry__.py's network flags, the JAX package's own spatial run
GRAFT = ["--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "8", "--ndf",
         "8", "--stn_ngf", "8", "--stn_depth", "3", "--stn_type", "unet", "--pool_size", "0"]


def _sized(size, depth):
    return [*GRAFT, "--crop_size", str(size), "--load_size", str(size), "--stn_depth",
            str(depth)]


CASES = {
    "graft": (GRAFT, 32),
    "depth_5": (_sized(32, 5), 32),
    "40_depth_3": (_sized(40, 3), 40),
    "36_depth_2": (_sized(36, 2), 36),
    "pyramid_5": ([*GRAFT, "--recon_pyramid", "5"], 32),
    "graft_wgangp": ([*GRAFT, "--gan_mode", "wgangp"], 32),
}
_ONE = {}


def _case_inputs(root):
    """Per case: (argv, states, batch, the one-process step's (nets,
    losses)), the one-process steps computed once a process."""
    out = {}
    for name, (flags, size) in CASES.items():
        argv = [*ts.RUN, *flags, "--batch_size", "2", "--checkpoints_dir", str(root / name)]
        if name not in _ONE:
            states, batch = ts._random_states(argv), ts._batch(2, size, 15)
            _ONE[name] = (states, batch, ts._step_rank(argv, states, batch, 1))
        out[name] = (argv, *_ONE[name])
    return out


def _steps_rank(cells, spatial_size):
    return [ts._step_rank(argv, states, batch, spatial_size) for argv, states, batch in cells]


@pytest.mark.parametrize("devices", [2, 4], ids=["data1_spatial2", "data2_spatial2"])
def test_steps_at_uneven_thin_and_empty_bands_equal_one_process(tmp_path, devices):
    """One step of each case at (data W / 2, spatial 2) against one
    process, by ``test_spatial_step_equals_one_process``'s rule; the ranks'
    parameters bit-identical."""
    cases = _case_inputs(tmp_path)
    cells = [([*argv, "--num_devices", str(devices), "--mesh_spatial", "2"], states, batch)
             for argv, states, batch, _ in cases.values()]
    ranks = ts._launch(_steps_rank, devices, cells, 2)
    for c, (name, (argv, _, _, (want_nets, want))) in enumerate(cases.items()):
        host = create_model(TrainOptions().parse(argv))
        # under wgangp D's last bias has a gradient of roundoff (the real
        # and the fake terms cancel)
        zero = ({"D": {f"Conv_{host.netD.n_layers + 1}.bias"}} if "wgangp" in name else None)
        ts._hold_ranks([r[c] for r in ranks], want_nets, want, host, zero)


def test_graft_configuration_matches_jax(tmp_path):
    """The JAX package's own spatial configuration (__graft_entry__.py's
    network flags, 32^2) at (data 1, spatial 2) against its step on the
    (data 1, spatial 2) virtual CPU mesh, by
    ``test_two_rank_spatial_step_matches_jax``'s rule."""
    ts.hold_against_jax(tmp_path, [*GRAFT, "--batch_size", "2"], 32)


def test_eval_registration_at_an_empty_band(tmp_path):
    """``test --eval_registration`` at --mesh_spatial 2 of the graft
    configuration at --stn_depth 5 (the STN's bottom level of one row, rank
    1's band empty), from a one-process checkpoint: the one-process
    summary."""
    import test_torch_parallel as tp
    from nemar_tpu_torch import test as port_test

    net = [*GRAFT[:-2], "--stn_depth", "5"]
    tp._main([*ts.RUN, *net, "--pool_size", "0", "--batch_size", "2", "--synthetic_size", "2",
              "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1",
              "--display_freq", "0", "--print_freq", "4", "--serial_batches", "--no_flip",
              "--num_devices", "1", "--checkpoints_dir", str(tmp_path), "--name", "run"])
    argv = ["--dataset_mode", "synthetic", "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path),
            "--name", "run", "--epoch", "1", "--eval_registration", *net, "--num_test", "2",
            "--synthetic_size", "2", "--results_dir", str(tmp_path / "results")]
    want = port_test.main(argv)
    got = port_test.main([*argv, "--mesh_spatial", "2", "--results_dir",
                          str(tmp_path / "spatial")])
    # the summary is rounded to 4 decimals: one unit either way
    assert set(got) == set(want) == {"ncc", "psnr", "l1", "epe_px"}
    assert all(abs(got[k] - want[k]) <= 1e-4 for k in want), (got, want)
