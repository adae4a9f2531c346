"""Worker-process input pipeline, the counterpart of
``nemar_tpu/data/grain_loader.py`` (``--loader grain``) on PyTorch's
``torch.utils.data.DataLoader``: grain itself loads JAX, which the port
never imports.

Wraps any registered BaseDataset, adding multi-WORKER (process)
prefetching beyond the default thread loader — useful when PIL decode
dominates (large JPEGs); the thread loader stays the default (lower
latency for synthetic/small data, no extra processes). Grain's semantics
are kept:

  * ``--num_threads`` worker processes (0: the items are read in this
    process, as grain's ``worker_count=0``), each making whole batches;
  * each item is ``dataset[i]`` at the epoch's ``set_epoch`` (draws keyed
    on (seed, epoch, index): the items do not depend on the worker count).
    The workers persist across epochs, so the epoch travels with every
    index the sampler hands them;
  * a shard is grain's ``even_split`` with the remainder dropped: shard p of
    P reads records [p * (n // P), (p + 1) * (n // P));
  * under --serial_batches the shard's records in order, else a
    permutation of them drawn per epoch from seed + epoch. (Grain's
    ``index_shuffle`` is a compiled cipher, so the order is not grain's;
    the records of each shard and epoch, and every item, are.);
  * batches drop the remainder, and are the thread loader's dict of NHWC
    arrays (string fields as lists);
  * ``len`` and ``num_batches`` are the JAX loader's (of the whole set).

The shards: with --data_shard_count -1, one per host of a launch over
several hosts (``parallel.launch(hosts=...)``, the JAX package's
``jax.process_count()``): host p reads shard p, in batches of
--batch_size / hosts rows (--batch_size stays the global batch, which is
the hosts' batches in host order). Each such batch says where its rows lie
in the global batch (``parallel.PART``), and the host's ranks keep theirs.
Outside such a launch that is one shard, the whole set. An explicit
--data_shard_count in a one-host run keeps the JAX package's meaning: the
records of shard --data_shard_index, in batches of --batch_size.

Workers are spawned (not forked: a rank on the card has CUDA initialised),
and the native augmentation library is opened here first, so that every
worker opens the same library this process uses
(``data/native_ops.py``).
"""

from __future__ import annotations

import numpy as np

from nemar_tpu_torch import parallel


def even_split(n: int, index: int, count: int) -> range:
    """Grain's ``even_split`` with ``drop_remainder``: shard ``index`` of
    ``count`` over n records (all of them when count <= 1)."""
    if count <= 1:
        return range(n)
    per = n // count
    return range(index * per, (index + 1) * per)


class _EpochItems:
    """The dataset as the workers see it: item (epoch, i) is ``dataset[i]``
    at that epoch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, key):
        epoch, i = key
        self.dataset.set_epoch(epoch)
        return self.dataset[i]


class _Batches:
    """The batch sampler: the loader's current epoch's batches of (epoch,
    record) keys."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        ld = self.loader
        order = np.asarray(ld.records)
        if ld.shuffle:
            order = np.random.default_rng(ld.seed + ld._epoch).permutation(order)
        b = ld.local_batch
        for j in range(len(self)):
            yield [(ld._epoch, int(i)) for i in order[j * b:(j + 1) * b]]

    def __len__(self):
        return len(self.loader.records) // self.loader.local_batch


class GrainDatasetLoader:
    """Same interface as CustomDatasetDataLoader, worker processes
    underneath."""

    def __init__(self, opt, dataset):
        from nemar_tpu_torch.data import native_ops

        self.opt = opt
        self.dataset = dataset
        self.batch_size = opt.batch_size
        self.max_size = min(len(dataset), opt.max_dataset_size)
        self.shuffle = not opt.serial_batches
        self.seed = getattr(opt, "seed", 0)
        self._epoch = 0
        self._num_workers = max(0, int(getattr(opt, "num_threads", 4)))
        count = getattr(opt, "data_shard_count", -1)
        hosts = parallel.hosts()
        self.local_batch = opt.batch_size
        # (first row, rows) of the global batch in each batch: None, the whole
        self.part = None
        if count < 0:
            index, count = parallel.host(), hosts
            if hosts > 1:
                self.local_batch = self._host_batch(opt, hosts, parallel.data_world())
                self.part = (index * self.local_batch, opt.batch_size)
        elif hosts > 1:
            raise ValueError(f"--data_shard_count {count}: over {hosts} hosts the shards are "
                             f"the hosts (leave it at -1)")
        else:
            index = getattr(opt, "data_shard_index", 0)
        self.records = even_split(self.max_size, index, count)
        native_ops.native_available()
        self._loader = None

    @staticmethod
    def _host_batch(opt, hosts: int, data_world: int) -> int:
        """The rows of a host's batch: --batch_size over the hosts, which
        must divide it, and split over the ranks in one microbatch (a batch
        cannot be replicated across hosts that read different records)."""
        b = opt.batch_size
        if b % hosts:
            raise ValueError(f"--batch_size {b}: the global batch must split over the "
                             f"{hosts} hosts of --loader grain")
        if b % data_world:
            raise ValueError(f"--batch_size {b}: over {hosts} hosts the global batch must "
                             f"split over the {data_world} ranks of the 'data' axis")
        k = getattr(opt, "grad_accum", 1)
        if k != 1:
            raise ValueError(f"--grad_accum {k}: over {hosts} hosts --loader grain takes "
                             f"one microbatch (a global microbatch would span hosts)")
        return b // hosts

    def __len__(self):
        return self.max_size

    def num_batches(self):
        return self.max_size // self.batch_size

    def _data_loader(self):
        """One DataLoader for the run, its workers kept across epochs."""
        if self._loader is None:
            import torch.utils.data

            from nemar_tpu_torch.data import collate

            w = self._num_workers
            self._loader = torch.utils.data.DataLoader(
                _EpochItems(self.dataset), batch_sampler=_Batches(self),
                num_workers=w, collate_fn=collate, persistent_workers=w > 0,
                multiprocessing_context="spawn" if w > 0 else None)
        return self._loader

    def __iter__(self):
        self._epoch += 1
        self.dataset.set_epoch(self._epoch)
        for batch in self._data_loader():
            if self.part is not None:
                batch[parallel.PART] = self.part
            yield batch

    def close(self) -> None:
        """End the worker processes (they also end with this process)."""
        # the DataLoader's own iterator holds the persistent workers (a
        # private attribute: read directly, so that a rename fails here)
        if self._loader is not None and self._loader._iterator is not None:
            self._loader._iterator._shutdown_workers()
        self._loader = None
