"""The dropout masks across a resume on the other device type (ROADMAP.md
queue C 3), on the CPU, no JAX.

pix2pix with dropout (unet_128 at ngf 4, 128^2, batch 2) trains 4 steps;
a second run trains 2, saves as ``train.py`` does at an epoch's end, and
its state file is marked as one written on the card (its dropout
generator's ``device`` field says ``cuda``, as a card run's state file of
the earlier format said). A run resumed from it on the CPU trains the last
2 steps: every parameter must equal the uninterrupted run's bit for bit,
and no warning is raised. The masks of a step are drawn from a generator
reseeded from --seed and the step count (``base_model.dropout_seed``),
which carry over on either device type, as the JAX package's key does;
before, a resume on the other device type kept the freshly seeded
generator and its masks restarted from the first step's.
"""

import warnings

import numpy as np
import torch

from nemar_tpu_torch.models import base_model, create_model
from nemar_tpu_torch.options import TrainOptions

torch.set_num_threads(2)

PIX2PIX = ["--model", "pix2pix", "--netG", "unet_128", "--crop_size", "128", "--load_size",
           "128", "--ngf", "4", "--ndf", "4", "--batch_size", "2", "--input_nc", "3",
           "--output_nc", "3", "--dataset_mode", "synthetic", "--gpu_ids", "-1",
           "--name", "drop", "--n_epochs", "1", "--n_epochs_decay", "1"]


def _model(ckpt, *flags):
    opt = TrainOptions().parse([*PIX2PIX, "--checkpoints_dir", str(ckpt), *flags])
    model = create_model(opt)
    model.setup(opt)
    return model


def _train(model, batches, epoch):
    model.set_epoch(epoch)
    for b in batches:
        model.set_input(b)
        model.optimize_parameters()


def test_pix2pix_resumed_from_a_card_state_equals_uninterrupted(tmp_path):
    rng = np.random.default_rng(8)
    batches = [{k: rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32) for k in "AB"}
               for _ in range(4)]
    run = _model(tmp_path / "run")
    assert not run.opt.no_dropout
    _train(run, batches[:2], 1)
    run.update_learning_rate(1)
    _train(run, batches[2:], 2)

    part = _model(tmp_path / "part")
    _train(part, batches[:2], 1)
    part.save_networks("latest")
    part.update_learning_rate(1)
    path = tmp_path / "part" / "drop" / "latest_state.pth"
    state = torch.load(path, weights_only=True)
    state.setdefault("drop_gen", {"state": torch.zeros(16, dtype=torch.uint8)})["device"] = "cuda"
    torch.save(state, path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resumed = _model(tmp_path / "part", "--continue_train", "--epoch_count", "2")
        _train(resumed, batches[2:], 2)
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)], caught
    assert resumed.step == run.step == 4
    differ = [(name, key) for name in ("G", "D")
              for (key, p), q in zip(resumed.nets()[name].named_parameters(),
                                     run.nets()[name].parameters()) if not torch.equal(p, q)]
    if differ:
        # which of the two strayed: a second uninterrupted run says
        again = _model(tmp_path / "again")
        _train(again, batches[:2], 1)
        again.update_learning_rate(1)
        _train(again, batches[2:], 2)
        name, key = differ[0]
        ref = dict(again.nets()[name].named_parameters())[key]
        verdict = {"resumed": torch.equal(dict(resumed.nets()[name].named_parameters())[key], ref),
                   "uninterrupted": torch.equal(dict(run.nets()[name].named_parameters())[key],
                                                ref)}
        raise AssertionError(f"{differ[:4]} differ; equal to a second uninterrupted run: "
                             f"{verdict}")


def test_each_step_draws_from_its_own_seed():
    """Step 0 draws from the seed itself; 1000 steps in a row from distinct
    seeds of at most 32 bits; two runs' step t from the same seed."""
    seeds = [base_model.dropout_seed(23, t) for t in range(1000)]
    assert seeds[0] == 23 and len(set(seeds)) == 1000 and max(seeds) < 2**32
    assert base_model.dropout_seed(23, 7) == seeds[7]
