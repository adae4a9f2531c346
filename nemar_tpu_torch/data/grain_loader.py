"""Grain-backed input pipeline, this package's copy of
``nemar_tpu/data/grain_loader.py``.

Wraps any registered BaseDataset as a grain data source, adding
multi-WORKER (process) prefetching beyond the default thread loader —
useful when PIL decode dominates (large JPEGs). Selected with
``--loader grain``; the thread loader stays the default (lower latency for
synthetic/small data, no extra processes).
"""

from __future__ import annotations

import numpy as np


class GrainDatasetLoader:
    """Same interface as CustomDatasetDataLoader, grain underneath."""

    def __init__(self, opt, dataset):
        import grain.python as grain

        self.opt = opt
        self.dataset = dataset
        self.batch_size = opt.batch_size
        self.max_size = min(len(dataset), opt.max_dataset_size)
        self._epoch = 0

        class _Source:
            def __init__(self, ds, n):
                self._ds = ds
                self._n = n

            def __len__(self):
                return self._n

            def __getitem__(self, idx):
                return self._ds[int(idx)]

        self._grain = grain
        self._source = _Source(dataset, self.max_size)
        self._sampler_kwargs = dict(
            num_records=self.max_size,
            shuffle=not opt.serial_batches,
            seed=getattr(opt, "seed", 0),
        )
        self._num_workers = max(0, int(getattr(opt, "num_threads", 4)))
        # multi-process data sharding: each process reads its disjoint
        # slice. Defaults to torch.distributed's rank and world size when a
        # process group is up (one shard otherwise); overridable for tests.
        shard_count = getattr(opt, "data_shard_count", -1)
        if shard_count < 0:
            import torch.distributed as dist

            up = dist.is_available() and dist.is_initialized()
            shard_index = dist.get_rank() if up else 0
            shard_count = dist.get_world_size() if up else 1
        else:
            shard_index = getattr(opt, "data_shard_index", 0)
        self._shard = (
            grain.ShardOptions(shard_index=shard_index,
                               shard_count=shard_count, drop_remainder=True)
            if shard_count > 1 else grain.NoSharding()
        )

    def __len__(self):
        return self.max_size

    def num_batches(self):
        return self.max_size // self.batch_size

    def __iter__(self):
        grain = self._grain
        # bump BEFORE the DataLoader pickles the source to its workers so
        # every process sees this epoch's stream
        self._epoch += 1
        self.dataset.set_epoch(self._epoch)
        kwargs = dict(self._sampler_kwargs)
        kwargs["seed"] = kwargs["seed"] + self._epoch  # reshuffle each epoch
        sampler = grain.IndexSampler(
            shard_options=self._shard,
            num_epochs=1,
            **kwargs,
        )
        loader = grain.DataLoader(
            data_source=self._source,
            sampler=sampler,
            operations=[grain.Batch(self.batch_size, drop_remainder=True)],
            worker_count=self._num_workers,
        )
        for batch in loader:
            # grain batches dict-of-arrays; string fields come as lists
            yield {
                k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
                for k, v in batch.items()
            }
