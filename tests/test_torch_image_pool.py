"""The port's image pool (``nemar_tpu_torch/utils/image_pool.py``) against
the JAX package's ``query_pool`` (``nemar_tpu/utils/image_pool.py``).

The test draws as the JAX function does (``jax.random.split`` of the key,
``bernoulli`` for use_old, ``randint`` for the slot) and passes those draws
to the port, whose ``query_pool`` takes them as arguments. Both then run on
the same buffer, count and fakes (NHWC in JAX, NCHW in the port): the new
buffer, the new count and the batch D sees must be equal exactly (the pool
only copies). Cases: the fill from empty, a batch that crosses the fill
boundary (a swap only against slots valid before the batch), the full
pool's swaps, and two swaps of one batch onto the same slot, where JAX's
``.at[].set`` leaves the winner unspecified and the port's rule is the last
writer: there both agree on every other slot and on what D sees, and the
port's slot holds the batch's last fake for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemar_tpu.utils import image_pool as jpool
from nemar_tpu_torch.utils import image_pool

P, C, H, W = 5, 3, 4, 4


def _jax_draws(key, n, p=P):
    """JAX's query_pool's draws from ``key``."""
    r_choice, r_idx = jax.random.split(key)
    return (np.asarray(jax.random.bernoulli(r_choice, 0.5, (n,))),
            np.asarray(jax.random.randint(r_idx, (n,), 0, p)))


def _state(rng, count):
    images = np.zeros((P, H, W, C), np.float32)
    images[:count] = rng.uniform(-1, 1, (count, H, W, C))
    return images


def _both(images, count, fakes, key):
    """(JAX's (images, count, out), the port's), NHWC numpy."""
    jstate, jout = jpool.query_pool(jpool.PoolState(jnp.asarray(images), jnp.int32(count)),
                                    jnp.asarray(fakes), key)
    use_old, rand_idx = _jax_draws(key, fakes.shape[0])
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    new, new_count, out = image_pool.query_pool(
        nchw(images), torch.tensor(count), nchw(fakes), torch.tensor(use_old),
        torch.tensor(rand_idx, dtype=torch.int64))
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    return ((np.asarray(jstate.images), int(jstate.count), np.asarray(jout)),
            (nhwc(new), int(new_count), nhwc(out)), (use_old, rand_idx))


@pytest.mark.parametrize("case,count,n", [("fill", 0, 3), ("cross_boundary", 3, 4),
                                          ("full", P, 4)])
def test_query_pool_matches_jax(case, count, n):
    rng = np.random.default_rng(count)
    swaps = 0
    for seed in range(12):
        images = _state(rng, count)
        fakes = rng.uniform(-1, 1, (n, H, W, C)).astype(np.float32)
        want, got, (use_old, rand_idx) = _both(images, count, fakes, jax.random.key(seed))
        fill = count + np.arange(n) < P
        swap = ~fill & use_old & (rand_idx < count)
        if len(set(rand_idx[swap])) < swap.sum():
            continue  # two swaps onto one slot: test_repeated_slot_last_writer_wins
        swaps += int(swap.sum())
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == min(count + n, P)
        np.testing.assert_array_equal(got[2], want[2])
        # D sees the incoming fakes but where a swap hands it an old image
        np.testing.assert_array_equal(got[2][~swap], fakes[~swap])
        np.testing.assert_array_equal(got[2][swap], images[rand_idx[swap]])
    if case == "fill":
        assert swaps == 0
    else:
        assert swaps > 0


def test_repeated_slot_last_writer_wins():
    """A key whose draw sends two swaps of one batch to one slot of a full
    pool (the first such key found, deterministic)."""
    rng = np.random.default_rng(7)
    n = 4
    for seed in range(1000):
        use_old, rand_idx = _jax_draws(jax.random.key(seed), n)
        slots = rand_idx[use_old]
        if len(slots) > len(set(slots)):
            break
    else:
        raise AssertionError("no repeated slot in 1000 keys")
    images = _state(rng, P)
    fakes = rng.uniform(-1, 1, (n, H, W, C)).astype(np.float32)
    want, got, _ = _both(images, P, fakes, jax.random.key(seed))
    repeated = {int(s) for s in slots if (slots == s).sum() > 1}
    others = [s for s in range(P) if s not in repeated]
    np.testing.assert_array_equal(got[0][others], want[0][others])
    np.testing.assert_array_equal(got[2], want[2])  # D reads the buffer before the update
    for s in repeated:
        last = max(i for i in range(n) if use_old[i] and rand_idx[i] == s)
        np.testing.assert_array_equal(got[0][s], fakes[last])
        # JAX's winner is one of the writers, unspecified
        assert any(np.array_equal(want[0][s], fakes[i]) for i in range(n)
                   if use_old[i] and rand_idx[i] == s)


def test_draws_come_from_the_generator():
    """The model's draws: the same generator state gives the same draws,
    Bernoulli 0.5 and slots over the whole pool."""
    gen = torch.Generator().manual_seed(17)
    state = gen.get_state()
    use_old, idx = image_pool.draw(gen, 4000, P)
    gen.set_state(state)
    again = image_pool.draw(gen, 4000, P)
    assert torch.equal(use_old, again[0]) and torch.equal(idx, again[1])
    assert use_old.dtype == torch.bool and abs(float(use_old.float().mean()) - 0.5) < 0.05
    assert set(idx.tolist()) == set(range(P))
