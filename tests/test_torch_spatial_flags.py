"""NeMAR's step flags under ``--mesh_spatial`` on the port: the WGAN-GP
objective (a double backward through the band forms), vanilla, --remat,
--g_batch, --freeze_g, --stn_field_source fake, the warp's padding modes
and align_corners, resnet_9blocks and the n-layer D, each equal to the
one-process run.

The ranks run on the CPU over gloo, at ``test_torch_spatial.py``'s size
(64^2, ngf, ndf and stn_ngf 8, stn_depth 3) and with its helpers, in
float64. Held:

  * the band primitives' second derivatives (``exchange_rows``,
    ``gather_frame``, the differentiable ``gather_parts`` and
    ``group_sum``, each under a nonlinear loss on every rank: the gradient
    with its graph, then a Hessian-vector product) and K-in's band double
    backward (its plain path: d x, then the VJP of (x, g) -> d x) against
    the whole-frame functions cut to the band, at s = 2 and 4, within
    1e-12 of the reference's largest value;
  * the band penalty (``cal_gradient_penalty(band=)``: every rank's value,
    and D's parameter gradients summed over the ranks) against the
    one-process penalty, within 1e-12 of the reference's largest value;
  * one step at (W, s) = (2, 2) against one process, to
    ``test_torch_spatial._hold_ranks``' tolerances (losses and gradients
    1e-9 relative, parameters 1e-10, the ranks' parameters bit-identical),
    for each flag set of ``FLAG_SETS``; the band step under --remat bit for
    bit the band step without it.
"""

import numpy as np
import pytest
import torch

import test_torch_spatial as ts
import test_torch_spatial_recipe as tr
from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.ops.norm import instance_norm_act_band, instance_norm_act_plain
from nemar_tpu_torch.options import TrainOptions
from nemar_tpu_torch.parallel import spatial

def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def _err(a, b):
    """max |a - b| over the reference's largest value."""
    b = b.detach()
    return float((a.detach() - b).abs().max()) / max(float(b.abs().max()), 1e-300)


# ---------------------------------------------------------------------------
# the primitives, K-in and the penalty, differentiated twice
# ---------------------------------------------------------------------------
def _second_order(loss, x, v):
    """(d loss / d x with its graph, the Hessian-vector product with v)."""
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (hv,) = torch.autograd.grad((g * v).sum(), x)
    return g.detach(), hv


def _twice_rank(s):
    parallel.set_mesh(s)
    j = parallel.spatial_rank()
    rng = np.random.default_rng(51)
    errs = {}

    def hold(name, band_loss, frame_loss, frame, band, dim):
        """band_loss(x) is this rank's term of a loss whose sum over the
        ranks is frame_loss(X): its gradient and Hessian-vector product on
        the band against the frame's, cut to the band."""
        v = torch.from_numpy(np.random.default_rng(52).standard_normal(tuple(frame.shape)))
        x = frame.narrow(dim, band.r0, band.rows).clone().requires_grad_()
        got = _second_order(band_loss(x), x, v.narrow(dim, band.r0, band.rows))
        xf = frame.clone().requires_grad_()
        want = _second_order(frame_loss(xf), xf, v)
        errs[name] = max(_err(a, b.narrow(dim, band.r0, band.rows)) for a, b in zip(got, want))

    frame = _t(rng, 2, 3, 16, 5)
    band = spatial.Band.split(16, s, j)
    # each rank's own weights of its term (the same numbers on every rank)
    weights = [_t(np.random.default_rng(60 + r), 2, 3, 22, 5) for r in range(s)]
    for top, bottom, mode in ((1, 1, "reflect"), (3, 3, "reflect"), (1, 2, "zeros"),
                              (0, 1, "zeros"), (-1, 2, "zeros")):
        tops, bottoms = (top,) * s, (bottom,) * s

        def rows(r):  # rank r's rows of the padded frame
            b = spatial.Band.split(16, s, r)
            return slice(b.r0 + max(top, 0) - top, b.r1 + max(top, 0) + bottom)

        def band_loss(x):
            y = spatial.exchange_rows(x, band, tops, bottoms, dim=2, mode=mode)
            return (weights[j][:, :, :y.shape[2]] * torch.sin(y) * y).sum()

        def frame_loss(xf):
            p = ts._pad_frame(xf, max(top, 0), bottom, mode)
            return sum((weights[r][:, :, :rows(r).stop - rows(r).start]
                        * torch.sin(p[:, :, rows(r)]) * p[:, :, rows(r)]).sum()
                       for r in range(s))

        hold(f"exchange {top} {bottom} {mode}", band_loss, frame_loss, frame, band, 2)
    hold("gather_frame",
         lambda x: (weights[j][:, :, :16] * torch.sin(spatial.gather_frame(x, band)) ** 2).sum(),
         lambda xf: sum((weights[r][:, :, :16] * torch.sin(xf) ** 2).sum() for r in range(s)),
         frame, band, 2)

    def parts_loss(x):
        parts = spatial.gather_parts(torch.cos(x).sum(dim=(2, 3)), differentiable=True)
        return (torch.stack([weights[j][:, :, r, 0] for r in range(s)]) * parts.square()).sum()

    def parts_frame(xf):
        parts = torch.stack([torch.cos(xf[:, :, b.r0:b.r1]).sum(dim=(2, 3))
                             for b in (spatial.Band.split(16, s, r) for r in range(s))])
        return sum((torch.stack([weights[q][:, :, r, 0] for r in range(s)]) * parts.square()).sum()
                   for q in range(s))

    hold("gather_parts", parts_loss, parts_frame, frame, band, 2)
    hold("group_sum",
         lambda x: (weights[j][:, :, 0, 0] * torch.exp(
             spatial.group_sum(torch.sin(x).sum(dim=(2, 3))) / 8)).sum(),
         lambda xf: sum((weights[r][:, :, 0, 0] * torch.exp(torch.sin(xf).sum(dim=(2, 3)) / 8))
                        .sum() for r in range(s)), frame, band, 2)
    # K-in's band double backward (the plain path): d x with its graph, then
    # the VJP of (x, g) -> d x, against the frame's plain function
    x_frame = _t(rng, 2, 16, 6, 5) * 2 + 0.5
    g_frame, gg_frame = _t(rng, 2, 16, 6, 5), _t(rng, 2, 16, 6, 5)
    for act in ("none", "relu", "leaky_relu"):
        out = []
        for fn, sl in ((lambda x: instance_norm_act_band(x, band, act),
                        slice(band.r0, band.r1)),
                       (lambda x: instance_norm_act_plain(x, act), slice(None))):
            x = x_frame[:, sl].clone().requires_grad_()
            g = g_frame[:, sl].clone().requires_grad_()
            (dx,) = torch.autograd.grad(fn(x), x, g, create_graph=True)
            out.append((dx.detach(), *torch.autograd.grad(dx, (x, g), gg_frame[:, sl])))
        errs[f"K-in double bwd {act}"] = max(_err(a, b[:, band.r0:band.r1])
                                             for a, b in zip(*out))
    # the penalty: every rank's value, D's gradients summed over the ranks
    size = 64 if s == 2 else 128  # D's bands of at least 2 rows at every layer
    d = networks.NLayerDiscriminator(3, 8).double()
    with torch.no_grad():
        for p in d.parameters():
            p.copy_(_t(rng, *p.shape) * 0.1)
    real, fake = _t(rng, 2, 3, size, size), _t(rng, 2, 3, size, size)
    alpha = torch.from_numpy(rng.uniform(0, 1, (2, 1, 1, 1)))
    pb = spatial.Band.split(size, s, j)
    gp = networks.cal_gradient_penalty(d, real[:, :, pb.r0:pb.r1], fake[:, :, pb.r0:pb.r1],
                                       alpha, band=pb)
    # every rank holds the whole penalty, and its adjoint sums over the
    # ranks: each rank's gradient of a 1/s share is its part (the model's
    # loss takes that share); D's last bias does not reach the penalty
    got = torch.autograd.grad(gp / s, list(d.parameters()), allow_unused=True)
    want_gp = networks.cal_gradient_penalty(d, real, fake, alpha)
    want = torch.autograd.grad(want_gp, list(d.parameters()), allow_unused=True)
    assert [a is None for a in got] == [w is None for w in want] == [False] * 9 + [True]
    top = max(float(w.abs().max()) for w in want[:-1])
    errs["penalty"] = max(_err(gp, want_gp), *(
        float((ts._group_sum(a) - w).abs().max()) / top for a, w in zip(got[:-1], want[:-1])))
    return errs


@pytest.mark.parametrize("s", [2, 4])
def test_second_derivatives_against_the_frame(s):
    for errs in ts._launch(_twice_rank, s, s):
        assert all(e <= 1e-12 for e in errs.values()), {k: e for k, e in errs.items()
                                                        if not e <= 1e-12}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
FLAG_SETS = {
    "wgangp": ["--gan_mode", "wgangp"],
    "vanilla": ["--gan_mode", "vanilla"],
    "remat": ["--remat"],
    "g_batch": ["--g_batch"],
    "fake_freeze_g": ["--stn_field_source", "fake", "--freeze_g"],
    "border": ["--stn_padding_mode", "border"],
    "reflection_align_corners": ["--stn_padding_mode", "reflection", "--stn_align_corners"],
    "resnet_9blocks_n_layers": ["--netG", "resnet_9blocks", "--netD", "n_layers",
                                "--n_layers_D", "2"],
}
# the flag sets of each launch (several share one), and the band step each
# is held bit for bit against
LAUNCHES = {"objectives": (["wgangp", "vanilla", "remat", "default"], {"remat": "default"}),
            "paths": (["g_batch", "fake_freeze_g", "resnet_9blocks_n_layers"], {}),
            "warp": (["border", "reflection_align_corners"], {})}


def _roundoff(flags, host):
    """{net: keys} of the gradients that are 0 but for roundoff beyond the
    norms' biases: D's last bias under wgangp (-mean real + mean fake)."""
    if "wgangp" not in flags:
        return {}
    return {"D": {f"Conv_{host.netD.n_layers + 1}.bias"}}


def _argv(tmp_path, name):
    return [*ts.RUN, *ts.SPATIAL, *FLAG_SETS.get(name, []), "--batch_size", "2",
            "--checkpoints_dir", str(tmp_path / name)]


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_flag_steps_equal_one_process(tmp_path, launch):
    names, bits = LAUNCHES[launch]
    argvs = [_argv(tmp_path, n) for n in names]
    states = [ts._random_states(a) for a in argvs]
    data = ts._batch(2)
    ranks = ts._launch(tr._arms_rank, 2, [[*a, "--num_devices", "2", "--mesh_spatial", "2"]
                                          for a in argvs], states, data, 2)
    for i, (name, argv) in enumerate(zip(names, argvs)):
        if name == "default":  # held by test_torch_spatial.py
            continue
        want_nets, want = ts._step_rank(argv, states[i], data, 1)
        host = create_model(TrainOptions().parse(argv))
        ts._hold_ranks([r[i] for r in ranks], want_nets, want, host,
                       _roundoff(FLAG_SETS[name], host))
    for name, other in bits.items():
        # the same step without the flag, bit for bit (the same states:
        # --remat changes no parameter's draw)
        a, b = names.index(name), names.index(other)
        for r in ranks:
            (nets_a, losses_a), (nets_b, losses_b) = r[a], r[b]
            assert losses_a == losses_b
            for n, params in nets_a.items():
                for k, (p, g) in params.items():
                    assert torch.equal(p, nets_b[n][k][0]), (n, k)
                    assert (g is None) == (nets_b[n][k][1] is None)
                    assert g is None or torch.equal(g, nets_b[n][k][1]), (n, k)


# ---------------------------------------------------------------------------
# a JAX tree of a --remat run
# ---------------------------------------------------------------------------
def test_remat_tree_converts_as_the_plain_tree():
    """flax's ``nn.remat`` names G's trunk blocks ``CheckpointResnetBlock_i``
    (the JAX package under --remat): ``flax_to_torch`` reads them as
    ``ResnetBlock_i``, so the same draws convert to the same state_dict as
    the tree of G without --remat."""
    import jax
    import jax.numpy as jnp
    from nemar_tpu.models import networks as jnet
    from nemar_tpu_torch.utils.convert import flax_to_torch

    shapes = [jax.eval_shape(lambda r=r: jnet.define_G(1, 3, 4, "resnet_6blocks", use_remat=r)
                             .init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)), False))
              for r in (False, True)]
    rng = np.random.default_rng(3)
    plain = jax.tree.map(lambda leaf: rng.standard_normal(leaf.shape).astype(np.float32),
                         shapes[0])
    # the --remat tree: the same leaves under nn.remat's names
    remat = {"params": {("Checkpoint" + k if k.startswith("ResnetBlock") else k): v
                        for k, v in plain["params"].items()}}
    assert "CheckpointResnetBlock_0" in shapes[1]["params"]
    assert jax.tree.structure(remat) == jax.tree.structure(shapes[1])
    net = networks.define_G(1, 3, 4, "resnet_6blocks", use_remat=True)
    got, want = flax_to_torch(remat, net), flax_to_torch(plain, net)
    assert got.keys() == want.keys() == net.state_dict().keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
