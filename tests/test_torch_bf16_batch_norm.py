"""Batch norm under ``--bf16`` across ranks (``networks.batch_norm_global``):
the statistics of the global batch, or of the frame in bands, as the JAX
package's ``jnp.mean`` takes them on a sharded batch: the sums and the
pixel count in fp32, summed over the ranks in fp32, the mean and the
variance cast to bf16 once (``nemar_tpu/models/networks.py:_norm_act``:
``convert f32, reduce_sum, div by the count, convert bf16``).

Held, on CPU ranks over gloo (``parallel.launch``):

  * at 2 ranks, each with rows of 2 x 31 x 31 = 1922 pixels a channel (a
    count bf16 cannot hold: it rounds to 1920), the count, the mean and
    the variance the function divides and casts (the all-reduced sums it
    hands on) within 1e-6 relative of float64 sums over the exact count;
    its bf16 output within one bf16 spacing of the JAX package's
    ``_norm_act(x, 'batch', 'none')`` in bf16 and of the one-process port
    (``batch_norm_local``), both over the global batch;
  * one NeMAR step under ``--norm batch --netD pixel --bf16`` at (data 2)
    and at (data 1, spatial 2) against the one-process ``--bf16`` step by
    ``test_torch_bf16.held``'s rule (a), e being the one process's own
    bf16-vs-fp32 difference (as ``test_torch_spatial_recipe`` holds the
    band step), the losses and every gradient; the ranks bit-identical.
    The biases a batch norm follows have a gradient that is 0 but for
    roundoff, which bf16 makes large (up to a tenth of the conv's weight
    gradient here): each is held within 4 times one process's own.
"""

import numpy as np
import torch

import test_torch_spatial as ts
import test_torch_spatial_recipe as tr
from nemar_tpu_torch import parallel
from nemar_tpu_torch.models import create_model, networks
from nemar_tpu_torch.options import TrainOptions

BF16 = torch.bfloat16
# (rows a rank, channels, H, W): 2 x 31 x 31 pixels a channel on each rank
SHAPE = (2, 8, 31, 31)


def _frame():
    """The global batch (4 rows), bf16, channels_last; means away from 0,
    so that a relative error of the mean is one."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((4, *SHAPE[1:])) + rng.uniform(0.5, 2.0, (1, SHAPE[1], 1, 1))
    return torch.from_numpy(x).to(BF16).contiguous(memory_format=torch.channels_last)


def _stats_rank(x):
    """batch_norm_global on this rank's rows of x -> (the all-reduced
    vectors it divides: [sums, count], then the squared deviations' sums;
    its output)."""
    seen = []
    sum_over_ranks = parallel.sum_over_ranks

    def recorded(t):
        out = sum_over_ranks(t)
        seen.append(out.detach().clone())
        return out

    parallel.sum_over_ranks = recorded
    try:
        rows = x[2 * parallel.rank():2 * parallel.rank() + 2]
        out = networks.batch_norm_global(rows)
    finally:
        parallel.sum_over_ranks = sum_over_ranks
    return seen, out


def _bf16_spacing(t):
    """bf16's spacing at each value of t (that of the smallest normal
    below it)."""
    a = t.double().abs().clamp_min(torch.finfo(BF16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def test_batch_norm_statistics_in_fp32_over_the_exact_count():
    import jax.numpy as jnp
    from nemar_tpu.models.networks import _norm_act

    x = _frame()
    ranks = ts._launch(_stats_rank, 2, x)
    (seen, out0), (seen1, out1) = ranks
    assert all(torch.equal(a, b) for a, b in zip(seen, seen1))
    first, second = seen
    n = 4 * SHAPE[2] * SHAPE[3]
    x64 = x.double()
    assert abs(float(first[-1]) - n) <= 1e-6 * n, float(first[-1])
    mean = first[:-1] / first[-1]
    mean64 = x64.sum(dim=(0, 2, 3)) / n
    assert float(((mean.double() - mean64) / mean64).abs().max()) <= 1e-6
    # the deviations as the function takes them: x minus the bf16 mean, in
    # bf16, squared in bf16
    dev = torch.square(x - mean.to(BF16)[None, :, None, None])
    var = second / first[-1]
    var64 = dev.double().sum(dim=(0, 2, 3)) / n
    assert float(((var.double() - var64) / var64).abs().max()) <= 1e-6
    got = torch.cat([out0, out1]).double()
    nhwc = x.float().permute(0, 2, 3, 1).numpy()
    jax_out = np.asarray(_norm_act(jnp.asarray(nhwc, jnp.bfloat16), "batch", "none")
                         .astype(jnp.float32))
    for want in (torch.from_numpy(jax_out).permute(0, 3, 1, 2).double(),
                 networks.batch_norm_local(x).double()):
        spacing = _bf16_spacing(torch.maximum(got.abs(), want.abs()))
        assert bool(((got - want).abs() <= spacing).all()), float((got - want).abs().max())


def test_bf16_batch_norm_step_across_ranks(tmp_path):
    import test_torch_bf16 as tb  # JAX's: here, not where the ranks import this file

    argv = [*ts.RUN, "--model", "nemar", "--crop_size", "32", "--load_size", "32", "--ngf", "8",
            "--ndf", "8", "--stn_ngf", "8", "--stn_depth", "3", "--norm", "batch", "--netD",
            "pixel", "--batch_size", "2", "--checkpoints_dir", str(tmp_path)]
    states = {n: {k: v.float() for k, v in sd.items()}
              for n, sd in ts._random_states(argv).items()}
    data = ts._batch(2, 32)
    one16, one32 = tr._run_rank([[*argv, "--bf16"], argv], states, data, 1)
    host = create_model(TrainOptions().parse(argv))
    for spatial in (1, 2):
        ranks = ts._launch(tr._run_rank, 2, [[*argv, "--bf16", "--num_devices", "2",
                                              "--mesh_spatial", str(spatial)]], states, data,
                           spatial)
        ((g0, l0),), ((g1, l1),) = ranks
        assert l0 == l1
        for k, v in one32[1].items():
            tb.held(f"{spatial} {k}", torch.tensor(l0[k]), torch.tensor(v),
                    torch.tensor(one16[1][k]), torch.tensor(v), check_b=False)
        for n, grads in one32[0].items():
            skip = ts.tp._norm_biases(host.nets()[n])
            for k, g32 in grads.items():
                assert g0[n][k] is None and g1[n][k] is None or torch.equal(g0[n][k], g1[n][k])
                if g32 is None:
                    continue
                if k in skip:  # bf16 roundoff of a sum that is 0: one process's size
                    mine, its = (float(g[n][k].abs().max()) for g in (g0, one16[0]))
                    assert mine <= 4 * its, (spatial, n, k, mine, its)
                    continue
                tb.held(f"{spatial} {n}.{k}", g0[n][k], g32, one16[0][n][k], g32,
                        check_b=False)
