"""The A5 features on the port alone (no JAX), on the CPU.

  * ``--grad_accum 2`` equals ``--grad_accum 1`` at the same batch of 4: one
    step from one state, the seven losses within 1e-5 relative and every
    gradient within 1e-4 of its norm (fp32: the microbatches' forwards and
    convolutions sum at another batch size, and the D phase recomputes the
    fake without autograd; measured ~1e-6); the IN-followed biases, whose
    gradient is roundoff, are held as ``test_torch_nemar_train.py`` holds
    them;
  * ``--continue_train`` with the pool, EMA, WGAN-GP and two microbatches
    equals an uninterrupted run bit for bit, as ``test_torch_resume.py``
    holds the default recipe: the parameters, every Adam moment, the EMA
    shadows, the pool's buffer and count and the generator's state (the next
    draws);
  * ``--use_ema`` at test time (``python -m nemar_tpu_torch.test``) loads the
    shadows saved as ``{epoch}_net_{G,R}_ema.pth``, with netG's and netR's
    keys, and its forward differs from the live parameters';
  * a ``--batch_size`` that ``--grad_accum`` does not divide raises.
"""

import numpy as np
import pytest
import torch

import test_torch_nemar_train as tt
import test_torch_resume as tr
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch import options

torch.set_num_threads(2)

A5 = ["--pool_size", "3", "--ema_decay", "0.9", "--gan_mode", "wgangp", "--grad_accum", "2"]


def _opt(tmp_path, *flags, batch=2):
    return options.TrainOptions().parse([*tr.TINY[:-4], "--batch_size", str(batch), "--gpu_ids",
                                         "-1", "--checkpoints_dir", str(tmp_path), *flags])


def test_grad_accum_equals_one_batch(tmp_path):
    rng = np.random.default_rng(2)
    batch = {"A": rng.uniform(-1, 1, (4, 32, 32, 1)).astype(np.float32),
             "B": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)}
    models, start = [], None
    for k in (1, 2):
        model = create_model(_opt(tmp_path / str(k), "--grad_accum", str(k), batch=4))
        if start is None:  # the first model's weights, R's heads drawn non-zero
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for head in model.netR.heads():
                    head.weight.copy_(0.01 * torch.randn(head.weight.shape, generator=gen))
            start = {n: {key: v.clone() for key, v in net.state_dict().items()}
                     for n, net in model.nets().items()}
        for name, net in model.nets().items():
            net.load_state_dict(start[name])
        model.setup(model.opt)
        model.set_epoch(1)
        model.set_input(batch)
        model.optimize_parameters()
        models.append(model)
    one, two = models
    assert two.grad_accum == 2
    l1, l2 = one.get_current_losses(), two.get_current_losses()
    for k in tt.LOSSES:
        assert abs(l1[k] - l2[k]) <= 1e-5 * abs(l1[k]), (k, l1[k], l2[k])
    skip = tt._in_biases(one)
    for name in "GDR":
        g1 = {k: torch.zeros_like(p) if p.grad is None else p.grad
              for k, p in one.nets()[name].named_parameters()}
        g2 = {k: torch.zeros_like(p) if p.grad is None else p.grad
              for k, p in two.nets()[name].named_parameters()}
        for key, want in g1.items():
            if key in skip[name]:  # roundoff, relative to the conv's weight gradient
                scale = float(torch.linalg.vector_norm(g1[key.replace(".bias", ".weight")]))
                assert max(float(want.abs().max()), float(g2[key].abs().max())) \
                    <= 1e-6 * scale, (name, key)
                continue
            err = float(torch.linalg.vector_norm(g2[key] - want) / torch.linalg.vector_norm(want))
            assert err <= 1e-4, (name, key, err)


def _state(model):
    out = {f"{n}.{k}": p.detach().clone() for n, net in model.nets().items()
           for k, p in net.named_parameters()}
    out.update({f"{n}_ema.{k}": v.clone() for n, s in model.ema.items() for k, v in s.items()})
    out["pool.images"], out["pool.count"] = model.pool
    out["rng"] = model.rng.get_state()
    return out


def test_resume_with_pool_ema_wgangp_equals_uninterrupted(tmp_path):
    batches = tr._batches()
    run = tr._model(tmp_path, *A5)
    tr._train(run, batches[:2], 1)
    tr._end_epoch(run, 1)
    assert int(run.pool[1]) == 3  # full after 4 fakes: the next steps swap
    tr._train(run, batches[2:], 2)

    resumed = tr._model(tmp_path, *A5, "--continue_train", "--epoch_count", "2")
    tr._train(resumed, batches[2:], 2)
    tr._assert_same_state(resumed, run)
    got, want = _state(resumed), _state(run)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert run.get_current_losses() == resumed.get_current_losses()


def test_use_ema_loads_the_shadows(tmp_path):
    args = [*tt.SLICE[:-4], "--ngf", "8", "--batch_size", "2", "--gpu_ids", "-1",
            "--checkpoints_dir", str(tmp_path / "ckpt"), "--n_epochs", "1",
            "--n_epochs_decay", "0", "--save_epoch_freq", "1", "--ema_decay", "0.5"]
    model = port_train.main(args)
    ckpt = tmp_path / "ckpt" / "train"
    for net in ("G", "R"):
        shadow = torch.load(ckpt / f"1_net_{net}_ema.pth", weights_only=True)
        live = torch.load(ckpt / f"1_net_{net}.pth", weights_only=True)
        assert shadow.keys() == live.keys() == model.nets()[net].state_dict().keys()
        assert all(torch.equal(shadow[k], model.ema[net][k]) for k in shadow)
        assert any(not torch.equal(shadow[k], live[k]) for k in shadow)

    test_args = [*tt.SLICE[:-4], "--ngf", "8", "--gpu_ids", "-1", "--checkpoints_dir",
                 str(tmp_path / "ckpt"), "--epoch", "1"]
    outs = {}
    for flag in ([], ["--use_ema"]):
        opt = options.TestOptions().parse([*test_args, *flag])
        m = create_model(opt)
        m.setup(opt)
        name = "ema" if flag else "live"
        want = torch.load(ckpt / f"1_net_G{'_ema' if flag else ''}.pth", weights_only=True)
        assert all(torch.equal(p, want[k]) for k, p in m.netG.state_dict().items()), name
        rng = np.random.default_rng(4)
        m.set_input({"A": rng.uniform(-1, 1, (1, 32, 32, 1)).astype(np.float32),
                     "B": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)})
        m.test()
        outs[name] = m.get_current_visuals()["fake_B"]
    assert not np.array_equal(outs["ema"], outs["live"])
    summary = port_test.main([*test_args, "--use_ema", "--results_dir", str(tmp_path / "res"),
                              "--eval_registration", "--num_test", "2"])
    assert all(np.isfinite(v) for v in summary.values())


def test_grad_accum_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match="--grad_accum 3 must divide --batch_size 4"):
        create_model(_opt(tmp_path, "--grad_accum", "3", batch=4))
