"""Data layer (reference data/ package), this package's copy of
``nemar_tpu/data/`` (numpy and PIL; the port imports nothing of the JAX
package).

String registry: ``--dataset_mode x`` resolves ``data/x_dataset.py`` class
``XDataset`` (find_dataset_using_name), mirroring the reference's public
API. The loader replaces torch's worker-process DataLoader with a
thread-pool prefetcher producing device-ready NHWC numpy batches (the
device transfer itself happens in the model layer, where sharding is
known). In a data-parallel run every rank's loader gives the same global
batches in the same order (the same seed), and the model keeps the rank's
rows (``nemar_tpu_torch.parallel.shard_rows``). ``--loader grain`` is the
worker-process loader (``grain_loader.py``, on ``torch.utils.data``), which
over several hosts reads each host's shard.
"""

from __future__ import annotations

import importlib
import queue
import threading

import numpy as np

from nemar_tpu_torch.data.base_dataset import BaseDataset


def find_dataset_using_name(dataset_mode: str):
    """data/{mode}_dataset.py -> {Mode}Dataset (reference naming scheme)."""
    dataset_filename = f"nemar_tpu_torch.data.{dataset_mode}_dataset"
    datasetlib = importlib.import_module(dataset_filename)
    target_name = dataset_mode.replace("_", "") + "dataset"
    for name, cls in datasetlib.__dict__.items():
        if name.lower() == target_name and issubclass(cls, BaseDataset):
            return cls
    raise NotImplementedError(
        f"In {dataset_filename}.py there should be a subclass of BaseDataset "
        f"with class name that matches {target_name} in lowercase."
    )


def get_option_setter(dataset_mode: str):
    return find_dataset_using_name(dataset_mode).modify_commandline_options


def create_dataset(opt):
    """Build the dataset + loader (reference data.create_dataset)."""
    dataset_class = find_dataset_using_name(opt.dataset_mode)
    dataset = dataset_class(opt)
    print(f"dataset [{type(dataset).__name__}] was created")
    if getattr(opt, "loader", "threads") == "grain":
        from nemar_tpu_torch.data.grain_loader import GrainDatasetLoader

        return GrainDatasetLoader(opt, dataset)
    return CustomDatasetDataLoader(opt, dataset)


class CustomDatasetDataLoader:
    """Batched, shuffled, thread-prefetched loader.

    Not a torch DataLoader translation: single process, a small thread pool
    decodes/augments ahead of the accelerator (PIL/numpy release the GIL for
    the heavy parts), and batches are contiguous NHWC float32 numpy arrays
    ready for a single host->device transfer.
    """

    def __init__(self, opt, dataset: BaseDataset):
        self.opt = opt
        self.dataset = dataset
        self.batch_size = opt.batch_size
        self.shuffle = not opt.serial_batches
        self.max_size = min(len(dataset), opt.max_dataset_size)
        self.num_prefetch = max(2, int(getattr(opt, "num_threads", 4)))
        self._rng = np.random.default_rng(getattr(opt, "seed", 0))
        self._epoch = 0

    def __len__(self):
        return self.max_size

    def num_batches(self):
        return self.max_size // self.batch_size

    def __iter__(self):
        # fresh per-epoch augmentation draws (worker-order independent)
        self._epoch += 1
        self.dataset.set_epoch(self._epoch)
        order = np.arange(self.max_size)
        if self.shuffle:
            self._rng.shuffle(order)
        nb = self.num_batches()
        if nb == 0:
            return
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        stop = threading.Event()

        def producer():
            for idxs in batches:
                if stop.is_set():
                    return
                items = [self.dataset[int(i)] for i in idxs]
                q.put(collate(items))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()


def collate(items: list) -> dict:
    """Items -> one batch: arrays stacked on a new leading axis (NHWC),
    other fields (paths) as lists."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out
