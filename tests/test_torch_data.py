"""The port's data layer (``nemar_tpu_torch/data``) against the JAX
package's: from the same options and seed, every dataset mode gives
bit-identical items, and the thread loader bit-identical shuffled batches,
over two epochs (the augmentation draws change per epoch)."""

import numpy as np
import pytest
from PIL import Image

from nemar_tpu import data as jax_data
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu_torch import data as port_data
from nemar_tpu_torch.options import TrainOptions

MODES = ["synthetic", "aligned", "unaligned", "single", "multimodal"]


def _write_pngs(root):
    """A few seeded images in each layout the file datasets read."""
    rng = np.random.default_rng(0)

    def png(path, h, w):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)

    for i in range(5):
        png(root / "train" / f"ab{i}.png", 40, 80)      # aligned: A|B side by side
        png(root / "trainA" / f"p{i}.png", 44, 40)     # unaligned / multimodal
        png(root / "trainB" / f"p{i}.png", 40, 46)
        png(root / "single" / f"s{i}.png", 38, 42)


def _opts(mode, root):
    argv = ["--dataset_mode", mode, "--name", "data", "--crop_size", "32", "--load_size", "36",
            "--batch_size", "2", "--num_threads", "2", "--seed", "3"]
    if mode == "synthetic":
        argv += ["--synthetic_size", "6"]
    else:
        argv += ["--dataroot", str(root / ("single" if mode == "single" else ""))]
    port = TrainOptions().parse(argv + ["--checkpoints_dir", str(root / "ckpt_port")])
    ref = JaxTrainOptions().parse(argv + ["--checkpoints_dir", str(root / "ckpt_jax")])
    return port, ref


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", MODES)
def test_items_match_jax(tmp_path, mode):
    _write_pngs(tmp_path)
    port_opt, ref_opt = _opts(mode, tmp_path)
    port = port_data.find_dataset_using_name(mode)(port_opt)
    ref = jax_data.find_dataset_using_name(mode)(ref_opt)
    assert type(port).__name__ == type(ref).__name__ and len(port) == len(ref)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            _same(port[i], ref[i])


@pytest.mark.parametrize("mode", ["synthetic", "aligned", "unaligned"])
def test_loader_batches_match_jax(tmp_path, mode):
    _write_pngs(tmp_path)
    port_opt, ref_opt = _opts(mode, tmp_path)
    port = port_data.create_dataset(port_opt)
    ref = jax_data.create_dataset(ref_opt)
    assert len(port) == len(ref) and port.num_batches() == ref.num_batches() > 1
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
