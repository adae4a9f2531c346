"""The fake-image pool (reference ``util/image_pool.py``, the CycleGAN trick).

Counterpart of ``nemar_tpu/utils/image_pool.py``, with the same pure
semantics: a (P, C, H, W) buffer and a fill count on the model's device,
threaded through the training step; ``query_pool`` takes its random draws as
arguments, so the caller owns the generator (the model draws them on the CPU
from its own ``torch.Generator``, and a test can feed the JAX package's).

Per incoming fake:
  * pool not yet full -> insert it, return it;
  * else with p = 0.5 (``use_old``) -> return the buffered image at
    ``rand_idx`` and put the fake in its slot;
  * else -> return the fake, the buffer unchanged.

A swap happens only against a slot that was valid before this batch
(``rand_idx < count``), and ``out`` reads the buffer as it was before the
update, as in the JAX package. Two swaps of one batch can target the same
slot, where ``.at[].set`` leaves the winner unspecified and a CUDA
``index_put_`` with repeated indices is not deterministic: here the last
writer (the highest index in the batch) wins, computed as a gather, the same
on every device and in every run.
"""

from __future__ import annotations

import torch


def init_pool(pool_size: int, image_shape: tuple, device=None) -> tuple:
    """(images (P, C, H, W) zeros, count 0) on ``device``."""
    return (torch.zeros((pool_size,) + tuple(image_shape), device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def draw(generator: torch.Generator, n: int, pool_size: int) -> tuple:
    """One batch's draws from a CPU generator: (use_old (n,) bool, Bernoulli
    0.5; rand_idx (n,) int64, uniform over the pool's slots)."""
    use_old = torch.rand(n, generator=generator) < 0.5
    return use_old, torch.randint(0, pool_size, (n,), generator=generator)


def query_pool(images: torch.Tensor, count: torch.Tensor, fakes: torch.Tensor,
               use_old: torch.Tensor, rand_idx: torch.Tensor) -> tuple:
    """-> (new images, new count, the batch D sees); see the module's doc."""
    p, n = images.shape[0], fakes.shape[0]
    fill_idx = count + torch.arange(n, device=images.device)
    filling = fill_idx < p
    swap = ~filling & use_old & (rand_idx < count)
    # the slot each fake writes, p where it writes none
    write_idx = torch.where(filling, fill_idx, torch.where(swap, rand_idx, p))
    hits = write_idx[:, None] == torch.arange(p, device=images.device)
    last = torch.where(hits, torch.arange(n, device=images.device)[:, None], -1).amax(0)
    fakes = fakes.to(images.dtype)
    new_images = torch.where((last >= 0)[:, None, None, None], fakes[last.clamp_min(0)], images)
    out = torch.where(swap[:, None, None, None], images[rand_idx], fakes)
    return new_images, torch.clamp_max(count + n, p), out
