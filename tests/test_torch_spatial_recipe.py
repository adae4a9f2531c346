"""The registration recipe under ``--mesh_spatial`` on the port: the flags
of ``scripts/science_final.py``'s arms (``nemar_tpu_torch/science.py:
recipe_flags``) in bands over the ranks of a spatial group, fp32 (float64
here) and ``--bf16``, each equal to the one-process run.

The ranks run on the CPU over gloo, at ``test_torch_spatial.py``'s size
(64^2, ngf, ndf and stn_ngf 8, stn_depth 3) and with its helpers. Held:

  * each new band form against the whole-frame version cut to the band, at
    s = 2 and 4, within 1e-12 of the reference's largest value (outputs,
    input gradients; shares summed over the group; parameter gradients of
    the net's largest): the multiscale resize (the band's rows of the weights
    against the gathered coarse field) and the composition, the level TVs
    and the order-2 TV, the UNet STN's field and TV with every recipe flag,
    --border_mask's mask and its count, the pyramid's pools, the affine
    STN's encoder and head (its last level at s = 4 on the gathered map);
  * one step of each arm's flags on a batch of 2 at (W, s) = (2, 2) and
    (4, 2) against one process, in float64, to ``test_torch_spatial._hold_ranks``' tolerances
    (losses and gradients 1e-9 relative, parameters 1e-10, the ranks'
    parameters bit-identical);
  * the plain bf16 band forms of K-in, K-block and K-convt (the CPU path
    and the card's yardstick) against the whole-frame bf16 plain versions,
    forward and VJP: the same bits for every output and input gradient,
    the weight gradients (the ranks' bf16 shares summed) within half a bf16
    spacing of each share's largest value and of the total's;
  * one ``--bf16`` step of the UNet arm at (2, 2) against the one-process
    bf16 step by ``test_torch_bf16.py``'s rule (a) (e: the one-process
    bf16-vs-fp32 difference, floored at Q = 2^-8 for a scalar), and by its
    rule (b) against the fp32 band step;
  * ``create_model`` under --mesh_spatial 2 takes the seven flags alone and
    together, and a band height that is not a multiple of 2^K under
    --recon_pyramid K (the bands re-cut to even bounds before each pool).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_spatial as ts
from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.models.stn.affine_stn import AffineSTN
from nemar_tpu_torch.models.stn.unet_stn import (UnetSTN, compose_flows_band, resize_bilinear,
                                                 smoothness_loss, smoothness_loss_band)
from nemar_tpu_torch.ops import conv_fused, convt_fused, norm
from nemar_tpu_torch.ops.warp import compose_flows, grid_sample
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.parallel import spatial

F64 = torch.float64
BF16 = torch.bfloat16
# the recipe's arms (science.recipe_flags at 256^2), at the test's size: the
# pyramid's 3 octaves keep a band of 16 rows (64^2 over 4 ranks of a
# spatial group ... 2 here: 32 rows) poolable
UNET = ["--stn_multiscale", "--stn_level_scale", "0.25", "--stn_bounded_flow", "0.15",
        "--stn_smooth_order", "2", "--recon_pyramid", "3", "--border_mask"]
AFFINE = ["--stn_type", "affine", "--recon_pyramid", "3", "--border_mask"]
ARMS = {"unet": UNET, "affine": AFFINE}


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


# ---------------------------------------------------------------------------
# the band forms
# ---------------------------------------------------------------------------
def _forms_rank(s):
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(31)
    errs = {}

    def err(a, b):  # relative to the reference's largest value
        b = b.detach()
        return float((a.detach() - b).abs().max()) / max(float(b.abs().max()), 1e-300)

    def grads_err(name, band_out, frame_out, band_in, frame_in, band, dim=1):
        g = torch.from_numpy(np.random.default_rng(32).standard_normal(tuple(frame_out.shape)))
        gb = g.narrow(dim, band.r0, band.rows)
        (gx,) = torch.autograd.grad(band_out, band_in, gb)
        (fx,) = torch.autograd.grad(frame_out, frame_in, g)
        errs[name] = max(err(band_out, frame_out.narrow(dim, band.r0, band.rows)),
                         err(gx, fx.narrow(dim, band_in_band[name].r0, band_in_band[name].rows)))

    band_in_band = {}
    b32 = spatial.Band.split(32, s, j)
    # the resize of a coarse field (8 rows: bands of 4 or 2) to 32 rows, and
    # the composition of the result with a field of the output's size
    coarse = _t(rng, 2, 8, 8, 2) * 0.1
    b8 = spatial.Band.split(8, s, j)
    cb = coarse[:, b8.r0:b8.r1].clone().requires_grad_()
    cf = coarse.clone().requires_grad_()
    got = resize_bilinear(spatial.gather_frame(cb, b8, dim=1), 32, 32, slice(b32.r0, b32.r1))
    want = resize_bilinear(cf, 32, 32)
    band_in_band["resize"] = b8
    grads_err("resize", got, want, cb, cf, b32)
    inner = _t(rng, 2, 32, 32, 2) * 0.1
    ib = inner[:, b32.r0:b32.r1].clone().requires_grad_()
    inf = inner.clone().requires_grad_()
    got = compose_flows_band(want.detach()[:, b32.r0:b32.r1], ib, b32)
    want_c = compose_flows(want.detach(), inf)
    band_in_band["compose"] = b32
    grads_err("compose", got, want_c, ib, inf, b32)
    # the TVs, order 1 and 2, l1 and l2, at a level's band
    for order in (1, 2):
        for kind in ("l1", "l2"):
            flow = _t(rng, 2, 32, 7, 2)
            fb = flow[:, b32.r0:b32.r1].clone().requires_grad_()
            ff = flow.clone().requires_grad_()
            share = smoothness_loss_band(fb, b32, kind, order)
            want = smoothness_loss(ff, kind, order)
            (gb,) = torch.autograd.grad(share, fb)
            (gf,) = torch.autograd.grad(want, ff)
            errs[f"TV {kind} order {order}"] = max(
                err(ts._group_sum(share.detach()), want),
                err(gb, gf[:, b32.r0:b32.r1]))
    # the UNet STN with every recipe flag: its field, grid, warps and TV
    b64 = spatial.Band.split(64, s, j)
    stn = UnetSTN(4, 8, 3, bounded_flow=0.15, multiscale=True, level_scale=0.25,
                  smooth_order=2, size=64).double()
    affine = AffineSTN(4, 8, 5, size=64).double()
    with torch.no_grad():
        for net in (stn, affine):
            for p in net.parameters():
                p.copy_(_t(rng, *p.shape) * 0.1)
    a, b = _t(rng, 2, 2, 64, 64), _t(rng, 2, 2, 64, 64)
    for name, net in (("unet", stn), ("affine", affine)):
        ab = [a[:, :, b64.r0:b64.r1].clone().requires_grad_(),
              b[:, :, b64.r0:b64.r1].clone().requires_grad_()]
        af = [a.clone().requires_grad_(), b.clone().requires_grad_()]
        (wb,), regb, auxb = net(ab[0], ab[1], (ab[0],), band=b64)
        (wf,), regf, auxf = net(af[0], af[1], (af[0],))
        g = torch.from_numpy(np.random.default_rng(33).standard_normal(tuple(wf.shape)))
        lb = (wb * g[:, :, b64.r0:b64.r1]).sum() + regb
        lf = (wf * g).sum() + regf
        gb = torch.autograd.grad(lb, ab + list(net.parameters()))
        gf = torch.autograd.grad(lf, af + list(net.parameters()))
        e = max(err(wb, wf[:, :, b64.r0:b64.r1]), err(ts._group_sum(regb.detach()), regf),
                err(auxb["flow"], auxf["flow"][:, b64.r0:b64.r1]),
                err(auxb["grid"], auxf["grid"][:, b64.r0:b64.r1]))
        for x, y in zip(gb[:2], gf[:2]):
            e = max(e, err(x, y[:, :, b64.r0:b64.r1]))
        # the parameters' gradients (the shares summed) over the net's largest
        # (a bias an instance norm follows has a gradient of roundoff)
        top = max(float(y.abs().max()) for y in gf[2:])
        for x, y in zip(gb[2:], gf[2:]):
            e = max(e, err(ts._group_sum(x), y) * max(float(y.abs().max()), 1e-300) / top)
        errs[name] = e
        if name == "unet":
            grid_band, grid_frame = auxb["grid"].detach(), auxf["grid"].detach()
    # --border_mask: the frame's ones at the band's grid; its count over the
    # group; the pyramid's 2x2 pools of the band (and of the mask)
    ones = torch.ones((2, 64, 64, 1), dtype=F64)
    mb = grid_sample(ones, grid_band, "bilinear", "zeros", False)
    mf = grid_sample(ones, grid_frame, "bilinear", "zeros", False)
    errs["mask"] = max(err(mb, mf[:, b64.r0:b64.r1]),
                       err(ts._group_sum(mb.sum()), mf.sum()))
    x = _t(rng, 2, 3, 64, 64)
    xb, band = x[:, :, b64.r0:b64.r1], b64
    e = 0.0
    for _ in range(3):
        even = band.aligned(2)
        xb, band = spatial.pool2(spatial.reband(xb, band, even)), even.pooled(2)
        x = F.avg_pool2d(x, 2)
        e = max(e, err(xb, x[:, :, band.r0:band.r1]))
        e = max(e, err(ts._group_sum(spatial.frame_mean(xb, band)), x.mean()))
    errs["pyramid"] = e
    return errs


def _all_forms_rank(s):
    return _forms_rank(s), _bf16_forms_rank(s)


@pytest.mark.parametrize("s", [2, 4])
def test_recipe_band_forms_against_the_frame(s):
    """The float64 band forms within 1e-12; the plain bf16 band forms'
    outputs and input gradients within one bf16 spacing of the tensor's
    largest value (the frame's statistics merged in another order can put
    a value on the other side of a rounding; measured: none), their weight
    gradients within their bound."""
    for errs, bf16 in ts._launch(_all_forms_rank, s, s):
        assert all(e <= 1e-12 for e in errs.values()), {k: e for k, e in errs.items()
                                                        if not e <= 1e-12}
        for name, (spacings, over) in bf16.items():
            assert spacings <= 1.0 and over <= 1.0, (name, spacings, over)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _arms_rank(argvs, states, batch, spatial_size):
    """``test_torch_spatial._step_rank`` for each (argv, states) of the
    arms, in one launch."""
    return [ts._step_rank(a, st, batch, spatial_size) for a, st in zip(argvs, states)]


@pytest.mark.parametrize("devices", [2, 4])
def test_recipe_step_equals_one_process(tmp_path, devices):
    """Each arm's step at (W, s) = (devices, 2) on a batch of 2."""
    argvs = [[*ts.RUN, *ts.SPATIAL, *flags, "--batch_size", "2", "--checkpoints_dir",
              str(tmp_path / arm)] for arm, flags in ARMS.items()]
    states = [ts._random_states(a) for a in argvs]
    data = ts._batch(2)
    ranks = ts._launch(_arms_rank, devices, [[*a, "--num_devices", str(devices),
                                              "--mesh_spatial", "2"] for a in argvs],
                       states, data, 2)
    for i, argv in enumerate(argvs):
        want_nets, want = ts._step_rank(argv, states[i], data, 1)
        ts._hold_ranks([r[i] for r in ranks], want_nets, want,
                       create_model(TrainOptions().parse(argv)))


# ---------------------------------------------------------------------------
# --bf16: the plain bf16 band forms, and the step
# ---------------------------------------------------------------------------
def _bf16_spacing(t):
    """The bf16 spacing of t's largest value (2^(e - 7) for a value in
    [2^e, 2^(e + 1)))."""
    top = float(t.detach().double().abs().max())
    return 0.0 if top == 0 else 2.0 ** (np.floor(np.log2(top)) - 7)


def _bf16_forms_rank(s):
    """The plain bf16 band forms (``instance_norm_act_band``,
    ``resblock_band_plain``, ``convt_band_plain`` at bf16: the CPU path of
    the band forms, the card's yardstick) against the whole-frame bf16
    plain versions (``instance_norm_act``, ``fused_resblock``,
    ``fused_convt_in`` on the CPU), forward and VJP: -> {name: (the largest
    output / input-gradient difference in bf16 spacings of the tensor's
    largest value, the weight gradients' difference over its bound)}."""
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(41)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).float()  # noqa: E731
    out = {}

    def hold(name, band_fn, frame_fn, inputs, weights, band, out_band):
        xs = [i.narrow(1, band.r0, band.rows).clone().requires_grad_() for i in inputs]
        ws = [w.clone().requires_grad_() for w in weights]
        y = band_fn(*xs, *ws)
        fx = [i.clone().requires_grad_() for i in inputs]
        fw = [w.clone().requires_grad_() for w in weights]
        ref = frame_fn(*fx, *fw)
        assert y.dtype == ref.dtype == BF16
        g = torch.from_numpy(np.random.default_rng(42).standard_normal(tuple(ref.shape))).to(BF16)
        got = torch.autograd.grad(y, xs + ws, g.narrow(1, out_band.r0, out_band.rows))
        want = torch.autograd.grad(ref, fx + fw, g)
        pairs = [(y, ref.narrow(1, out_band.r0, out_band.rows))]
        pairs += [(a, b.narrow(1, band.r0, band.rows)) for a, b in zip(got[:len(xs)], want)]
        spacings = max(float((a.detach().double() - b.detach().double()).abs().max())
                       / _bf16_spacing(b) for a, b in pairs[:1 + len(xs)])
        # a weight gradient is the ranks' bf16 shares summed: each share and
        # the total rounded once, so they differ by at most half a spacing
        # of each share's largest value and of the total's
        over = 0.0
        for a, b in zip(got[len(xs):], want[len(xs):]):
            shares = spatial.gather_parts(a.double())
            limit = 0.5 * (sum(_bf16_spacing(p) for p in shares) + _bf16_spacing(b))
            over = max(over, float((shares.sum(dim=0) - b.double()).abs().max()) / limit)
        out[name] = (spacings, over)

    band16 = spatial.Band.split(16, s, j)
    for act in ("relu", "leaky_relu", "none"):
        hold(f"K-in {act}", lambda x: norm.instance_norm_act_band(x, band16, act),
             lambda x: norm.instance_norm_act(x, act), [(t(2, 16, 6, 5) * 2 + 0.5).to(BF16)], [],
             band16, band16)
    hold("K-block", lambda x, w1, w2: conv_fused.resblock_band_plain(x, w1, w2, band16),
         conv_fused.fused_resblock, [t(2, 16, 6, 8).to(BF16)],
         [(t(3, 3, 8, 8) * 0.2).to(BF16), (t(3, 3, 8, 8) * 0.2).to(BF16)], band16, band16)
    band8 = spatial.Band.split(8, s, j)
    hold("K-convt", lambda x, w: convt_fused.convt_band_plain(x, w, band8),
         convt_fused.fused_convt_in, [t(2, 8, 5, 8).to(BF16)], [(t(3, 3, 8, 8) * 0.2).to(BF16)],
         band8, band8.up(2))
    return out


def _run_rank(argvs, states, batch, spatial_size):
    """For each argv of ``argvs`` one step (fp32 parameters; --bf16 as the
    argv says) from ``states`` on the global ``batch``: -> per argv
    ({net: {key: grad}}, losses)."""
    parallel.set_mesh(spatial_size)
    out = []
    for argv in argvs:
        opt = TrainOptions().parse(argv)
        model = create_model(opt)
        for n, sd in states.items():
            model.nets()[n].load_state_dict(sd)
        model.setup(opt)
        model.set_epoch(1)
        model.set_input(batch)
        model.optimize_parameters()
        out.append(({n: {k: None if p.grad is None else p.grad.clone()
                         for k, p in net.named_parameters()} for n, net in model.nets().items()},
                    dict(model.get_current_losses())))
    return out


def test_bf16_band_step_rule_a_and_b(tmp_path):
    import test_torch_bf16 as tb  # JAX's: here, not where the ranks import this file

    """The UNet arm's --bf16 step at (W, s) = (2, 2) on a batch of 1 (rank
    0; the ranks bit-identical) against the one-process --bf16 step by
    ``test_torch_bf16.held``'s rule (a), e being the one process's own
    bf16-vs-fp32 difference, for the seven losses and every gradient, and
    by its rule (b) against the fp32 band step: the band step computes in
    bf16 (the losses together by their largest ratio, as there). The
    biases an instance norm follows have a gradient of roundoff and are
    held, as there, within 5% of their conv's weight gradient; every other
    gradient by rules (a) and (b), a tensor of at most FEW elements (a flow
    head's bias among them) with e floored at Q."""
    argv = [*ts.RUN, *ts.SPATIAL, *UNET, "--batch_size", "1", "--checkpoints_dir",
            str(tmp_path)]
    states = {n: {k: v.float() for k, v in sd.items()}
              for n, sd in ts._random_states(argv).items()}
    data = ts._batch(1)
    argvs = [[*argv, "--bf16"], argv]
    runs = dict(zip(("one16", "one32"), _run_rank(argvs, states, data, 1)))
    ranks = ts._launch(_run_rank, 2, [[*a, "--num_devices", "2", "--mesh_spatial", "2"]
                                      for a in argvs], states, data, 2)
    for (g0, l0), (g1, l1) in zip(*ranks):
        assert l0 == l1
        for n, grads in g0.items():
            for k, g in grads.items():
                assert g is None and g1[n][k] is None or torch.equal(g, g1[n][k])
    runs.update(zip(("band16", "band32"), ranks[0]))
    ratios = []
    for k in runs["one32"][1]:
        p16, p32, j16, j32 = (torch.tensor(runs[r][1][k]) for r in ("band16", "band32", "one16",
                                                                   "one32"))
        _, b, bound = tb.held(k, p16, p32, j16, j32, check_b=False)
        ratios.append(b / bound if bound else np.inf)
    assert max(ratios) >= 1.0, ratios
    host = create_model(TrainOptions().parse(argv))
    for n, grads in runs["one32"][0].items():
        skip = ts.tp._norm_biases(host.nets()[n])
        for k, g32 in grads.items():
            if g32 is None:
                assert all(runs[r][0][n][k] is None for r in ("one16", "band16", "band32"))
                continue
            if k in skip:  # roundoff: small beside the conv's weight gradient
                w = float(grads[k.replace(".bias", ".weight")].abs().max())
                assert float(runs["band16"][0][n][k].abs().max()) <= 0.05 * w, (n, k)
                continue
            tb.held(f"{n}.{k}", *(runs[r][0][n][k] for r in ("band16", "band32", "one16")), g32)


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------
RECIPE_FLAGS = [["--bf16"], ["--stn_type", "affine"], ["--stn_multiscale"], ["--border_mask"],
                ["--recon_pyramid", "2"], ["--stn_bounded_flow", "0.15"],
                ["--stn_smooth_order", "2"], [*UNET, "--bf16"]]


@pytest.mark.parametrize("flags", RECIPE_FLAGS, ids=lambda f: " ".join(f))
def test_recipe_flags_accepted_under_spatial(tmp_path, flags):
    opt = TrainOptions().parse([*ts.RUN, *ts.SPATIAL, "--checkpoints_dir", str(tmp_path),
                                "--mesh_spatial", "2", *flags])
    create_model(opt)


def test_pyramid_band_height_refused(tmp_path):
    """--recon_pyramid K re-cuts the bands to even bounds before each 2x2
    pool: a band height (64 / 2 = 32 rows) not a multiple of 2^K (K = 6) is
    held under --mesh_spatial 2; a crop that 2^K does not divide (K = 7) is
    refused by name, in bands as in one process and in the JAX package."""
    opt = TrainOptions().parse([*ts.RUN, *ts.SPATIAL, "--checkpoints_dir", str(tmp_path),
                                "--mesh_spatial", "2", "--recon_pyramid", "6"])
    create_model(opt)
    opt = TrainOptions().parse([*ts.RUN, *ts.SPATIAL, "--checkpoints_dir", str(tmp_path),
                                "--mesh_spatial", "2", "--recon_pyramid", "7"])
    with pytest.raises(ValueError, match="recon_pyramid 7 needs --crop_size divisible by 128"):
        create_model(opt)

