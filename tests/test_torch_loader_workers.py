"""The port's worker loader (``--loader grain``: ``nemar_tpu_torch/data/
grain_loader.py`` on ``torch.utils.data``) against the JAX package's grain
loader (``nemar_tpu/data/grain_loader.py``), on a seeded multimodal PNG set
of 7 pairs (A one channel, B three), so that shards and batches have tails.

Under --serial_batches its batches are the JAX loader's bit for bit, at 0,
2 and 4 workers, unsharded and as shards (2, 0) and (2, 1), over 2 epochs
(the augmentation draws change per epoch). The JAX side runs its loader in
its own process (``worker_count=0``) with its native library opened first:
its reader threads otherwise race to open it, and the ones that lose take
the numpy tail, an ulp off (``tests/test_round2_fixes.py::TestWorkerSafeRNG::
test_grain_workers_match_inline`` fails on that). Shuffled, the order is a
numpy permutation from seed + epoch, not grain's compiled ``index_shuffle``:
each shard's records per epoch are JAX's, each item is JAX's bit for bit
(by path), the order is the same at 0 and 2 workers and changes between
epochs. The shuffled cases take batches of 1: with a larger batch, which
records fall into the dropped tail depends on the order. ``len`` and
``num_batches`` are JAX's; a global batch that the hosts do not divide is
refused by name."""

import contextlib
import io
import threading

import numpy as np
import pytest
from PIL import Image

from nemar_tpu import data as jax_data
from nemar_tpu.data import native_ops as jax_native
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu_torch import data as port_data
from nemar_tpu_torch import parallel
from nemar_tpu_torch.data import native_ops
from nemar_tpu_torch.data.grain_loader import GrainDatasetLoader
from nemar_tpu_torch.options import TrainOptions

N = 7
SHARDS = [None, (2, 0), (2, 1)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """7 pairs: an IR-like one-channel A and an RGB B, 20 x 22."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for i in range(N):
        for sub, shape in (("trainA", (20, 22)), ("trainB", (20, 22, 3))):
            (root / sub).mkdir(exist_ok=True)
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
                root / sub / f"{i:02d}.png")
    return root


def _opts(root, shard, *extra):
    argv = ["--dataroot", str(root), "--name", "w", "--dataset_mode", "multimodal",
            "--load_size", "24", "--crop_size", "16", "--seed", "5", "--loader", "grain", *extra]
    if shard is not None:
        argv += ["--data_shard_count", str(shard[0]), "--data_shard_index", str(shard[1])]
    with contextlib.redirect_stdout(io.StringIO()):
        port = TrainOptions().parse([*argv, "--gpu_ids", "-1",
                                     "--checkpoints_dir", str(root / "ckpt_port")])
        ref = JaxTrainOptions().parse([*argv, "--checkpoints_dir", str(root / "ckpt_jax")])
    return port, ref


def _loaders(root, shard, workers, *extra):
    port_opt, ref_opt = _opts(root, shard, "--num_threads", str(workers), *extra)
    ref_opt.num_threads = 0
    jax_native.native_available()
    with contextlib.redirect_stdout(io.StringIO()):
        return port_data.create_dataset(port_opt), jax_data.create_dataset(ref_opt)


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shard", SHARDS, ids=str)
def test_serial_batches_match_jax(root, shard, workers):
    port, ref = _loaders(root, shard, workers, "--serial_batches", "--batch_size", "2")
    assert isinstance(port, GrainDatasetLoader)
    got, want = _epochs(port), _epochs(ref)
    for g, w in zip(got, want):
        assert len(g) == len(w) == (3 if shard is None else 1)
        for a, b in zip(g, w):
            assert a.keys() == b.keys()
            for k in ("A", "B"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert np.array_equal(a[k], b[k]), k
            for k in ("A_paths", "B_paths"):
                assert list(a[k]) == [str(p) for p in b[k]]
    # the epochs' draws differ
    assert not np.array_equal(got[0][0]["A"], got[1][0]["A"])
    port.close()


def test_four_workers_match_none(root):
    serial = ("--serial_batches", "--batch_size", "2")
    none, _ = _loaders(root, None, 0, *serial)
    four, _ = _loaders(root, None, 4, *serial)
    for g, w in zip(_epochs(four), _epochs(none)):
        for a, b in zip(g, w):
            assert all(np.array_equal(a[k], b[k]) for k in ("A", "B"))
    four.close()


@pytest.mark.parametrize("shard", SHARDS, ids=str)
def test_shuffled_records_match_jax(root, shard):
    port, ref = _loaders(root, shard, 0, "--batch_size", "1")
    port2, _ = _loaders(root, shard, 2, "--batch_size", "1")
    got, want, got2 = _epochs(port), _epochs(ref), _epochs(port2)
    orders = []
    for g, w, g2 in zip(got, want, got2):
        mine = {b["A_paths"][0]: b for b in g}
        theirs = {str(b["A_paths"][0]): b for b in w}
        assert sorted(mine) == sorted(theirs)
        assert len(mine) == (N if shard is None else N // 2)
        for p, b in mine.items():
            assert all(np.array_equal(b[k], theirs[p][k]) for k in ("A", "B")), p
        order = [b["A_paths"][0] for b in g]
        assert order == [b["A_paths"][0] for b in g2]
        for a, b in zip(g, g2):
            assert all(np.array_equal(a[k], b[k]) for k in ("A", "B"))
        orders.append(order)
    assert orders[0] != orders[1]
    port2.close()


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("shard", SHARDS, ids=str)
def test_len_and_num_batches_match_jax(root, shard, batch):
    port_opt, ref_opt = _opts(root, shard, "--batch_size", str(batch), "--num_threads", "0")
    with contextlib.redirect_stdout(io.StringIO()):
        port, ref = port_data.create_dataset(port_opt), jax_data.create_dataset(ref_opt)
    assert (len(port), port.num_batches()) == (len(ref), ref.num_batches())


@pytest.mark.parametrize("flags, match", [
    (("--batch_size", "3"), "--batch_size 3: the global batch must split over the 2 hosts"),
    (("--batch_size", "4", "--grad_accum", "2"), "--grad_accum 2: over 2 hosts"),
    (("--batch_size", "4", "--data_shard_count", "2"), "--data_shard_count 2: over 2 hosts"),
])
def test_host_batch_refusals(root, monkeypatch, flags, match):
    """Over 2 hosts (the launch's host count, set as a rank of host 1 has
    it): a global batch the hosts do not divide, microbatches that would
    span hosts, and shards other than the hosts, each refused by name."""
    monkeypatch.setattr(parallel, "_host", 1)
    monkeypatch.setattr(parallel, "_hosts", 2)
    port_opt, _ = _opts(root, None, "--num_threads", "0", *flags)
    with pytest.raises(ValueError, match=match), contextlib.redirect_stdout(io.StringIO()):
        port_data.create_dataset(port_opt)


def test_host_shard_and_batch(root, monkeypatch):
    """A rank of host 1 of 2 reads shard 1, batches of half the global one,
    and its batches say that they are the global batch's row 1 of 2."""
    monkeypatch.setattr(parallel, "_host", 1)
    monkeypatch.setattr(parallel, "_hosts", 2)
    port_opt, _ = _opts(root, None, "--num_threads", "0", "--batch_size", "2",
                        "--serial_batches")
    with contextlib.redirect_stdout(io.StringIO()):
        loader = port_data.create_dataset(port_opt)
    batches = list(loader)
    assert [b["A_paths"] for b in batches] == [[str(root / "trainA" / f"{i:02d}.png")]
                                               for i in (3, 4, 5)]
    assert all(b[parallel.PART] == (1, 2) and parallel.global_rows(b) == 2 for b in batches)


def test_native_library_opens_once_for_every_thread(monkeypatch):
    """Threads that ask for the library while one opens it wait for it:
    every one gets the library's result, none numpy's."""
    if native_ops._load() is None:
        pytest.skip("the native library cannot be built here")
    monkeypatch.setattr(native_ops, "_LIB", None)
    monkeypatch.setattr(native_ops, "_TRIED", False)
    img = np.random.default_rng(1).integers(0, 256, (24, 24, 3), dtype=np.uint8)
    start, out = threading.Barrier(8), [None] * 8

    def work(i):
        start.wait()
        out[i] = native_ops.crop_flip_norm(img, 2, 3, 16, 16, bool(i % 2))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lib = native_ops._load()
    assert lib is not None
    # the library's result (numpy's is an ulp off for most values)
    for i in range(8):
        assert np.array_equal(out[i], native_ops.crop_flip_norm(img, 2, 3, 16, 16, bool(i % 2)))
