"""Several hosts (``parallel.launch(hosts=...)``, the JAX package's
multi-process mesh of ``scripts/multiprocess_smoke.py``) on the CPU.

``nemar_tpu_torch.multiprocess_smoke``'s step at 2 hosts x 2 ranks: two
launcher processes whose ranks join one gloo group over host 0's TCP store
(a free port), --mesh_spatial 2 (each host one spatial group), --loader
grain reading each host's shard of the synthetic set (host p: records
4p..4p+3, shuffled, one batch of 4), in float64. Every rank's state is
bit-identical to the others' (``state_digest``), and rank 0's parameters
and losses equal the one-process step on the global batch, the two hosts'
batches concatenated in host order (read here by the same loader at shards
(2, 0) and (2, 1)), to the float64 tolerance of the data-parallel tests
(``tests/test_torch_parallel.py``, whose one-process runs are held against
the JAX step). A spatial group that would span hosts is refused by name
(the batch refusals: ``tests/test_torch_loader_workers.py``). A host's
part of the global batch gives each rank its rows of the global batch,
takes one microbatch, and refuses a rank whose rows lie outside it."""

import contextlib
import io

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
from nemar_tpu_torch import multiprocess_smoke, parallel
from nemar_tpu_torch import train as port_train
from nemar_tpu_torch.data import create_dataset
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TrainOptions

F64 = torch.float64
TIMEOUT = 240.0


def _opt(tmp_path, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return TrainOptions().parse([*multiprocess_smoke.NET, "--gpu_ids", "-1",
                                     "--checkpoints_dir", str(tmp_path), "--name", "one",
                                     "--num_threads", "0", *extra])


def _global_batch(tmp_path) -> dict:
    """The hosts' first batches (shards (2, 0) and (2, 1) of 4 rows),
    concatenated in host order."""
    parts = []
    for p in range(2):
        opt = _opt(tmp_path, "--data_shard_count", "2", "--data_shard_index", str(p),
                   "--batch_size", "4")
        with contextlib.redirect_stdout(io.StringIO()):
            parts.append(next(iter(create_dataset(opt))))
    return {k: (np.concatenate([p[k] for p in parts]) if isinstance(parts[0][k], np.ndarray)
                else [x for p in parts for x in p[k]]) for k in parts[0]}


def test_two_hosts_equal_one_process(tmp_path):
    ranks = multiprocess_smoke.smoke("-1", 2, 2, extra=["--num_threads", "0"], dtype=F64,
                                     keep_params=True, timeout=TIMEOUT)
    assert [(r["host"], r["rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 2), (1, 3)]
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)

    opt = _opt(tmp_path, "--mesh_spatial", "1")
    batch = _global_batch(tmp_path)
    assert len(batch["A"]) == multiprocess_smoke.GLOBAL_BATCH
    with contextlib.redirect_stdout(io.StringIO()):
        model = create_model(opt)
        model.to_dtype(F64)
        model.setup(opt)
    model.set_epoch(1)
    model.set_input(batch)
    model.optimize_parameters()
    for k, v in model.get_current_losses().items():
        assert abs(ranks[0]["losses"][k] - v) <= 1e-10 * max(1.0, abs(v)), k

    bound = 2 * 1.1 * tp.LR
    got = ranks[0]["params"]
    for n, net in model.nets().items():
        skip = tp._norm_biases(net)
        for k, p in net.named_parameters():
            diff = (got[n][k] - p.detach()).abs()
            # as tests/test_torch_parallel.py: roundoff-sized gradients
            # (a norm's preceding bias, a few elements) move by up to lr
            if k in skip:
                assert float(diff.max()) <= bound, (n, k)
                continue
            loose = int((diff > tp.PARAM_TOL).sum())
            assert loose <= 2 + 1e-4 * p.numel() and float(diff.max()) <= bound, (n, k, loose)


@pytest.mark.parametrize("where", ["check_mesh", "train_main", "smoke"])
def test_spatial_group_across_hosts_refused(tmp_path, where):
    """--mesh_spatial 2 over hosts of one rank each: refused by name before
    anything is launched."""
    match = "--mesh_spatial 2: a spatial group would span hosts"
    with pytest.raises(ValueError, match=match):
        if where == "check_mesh":
            parallel.check_mesh(2, 1, 2)
        elif where == "train_main":
            with contextlib.redirect_stdout(io.StringIO()):
                port_train.main([*multiprocess_smoke.NET, "--gpu_ids", "-1", "--num_devices",
                                 "1", "--checkpoints_dir", str(tmp_path)],
                                hosts=(0, 2), init="tcp://127.0.0.1:1")
        else:
            multiprocess_smoke.smoke("-1", ranks=1, hosts=2)
    # on one host the JAX package's make_mesh message stands
    with pytest.raises(ValueError, match="spatial=2 must divide device count 1"):
        parallel.check_mesh(2, 1, 1)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_shard_rows_of_a_host_part(monkeypatch, rank):
    """4 data ranks over 2 hosts (ranks 0 and 1 on host 0): the host's part
    of a global batch of 8 (its 4 rows, ``parallel.PART``) gives the rank
    the rows the global batch would; the part takes one microbatch, and the
    other host's part is refused."""
    monkeypatch.setattr(parallel, "world", lambda: 4)
    monkeypatch.setattr(parallel, "rank", lambda: rank)
    whole = {"A": np.arange(8)[:, None], "A_paths": [f"p{i}" for i in range(8)]}
    host = rank // 2

    def part(h):
        rows = slice(4 * h, 4 * h + 4)
        return {"A": whole["A"][rows], "A_paths": whole["A_paths"][rows],
                parallel.PART: (4 * h, 8)}

    assert parallel.global_rows(part(host)) == parallel.global_rows(whole) == 8
    got, want = parallel.shard_rows(part(host)), parallel.shard_rows(whole)
    assert np.array_equal(got["A"], want["A"]) and got["A_paths"] == want["A_paths"]
    assert parallel.PART not in got
    with pytest.raises(ValueError, match="--grad_accum 2: a batch of 4 of the global "
                                         "batch's 8 rows takes one microbatch"):
        parallel.shard_rows(part(host), 2)
    with pytest.raises(ValueError, match="outside this rank's part"):
        parallel.shard_rows(part(1 - host))
