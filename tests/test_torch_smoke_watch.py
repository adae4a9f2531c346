"""The smoke's path checks on the CPU (``chip_smoke.watch_kernels``,
``watch_pool``, ``check_pool_last_writer``).

On the card, ``watch_kernels`` holds the first launch of K-in, K-in-bwd,
K-warp and K-warp-bwd (under --bf16, K-in's and K-in-bwd's bf16 variants
in bf16 spacings) at each configuration a path gives them against their
plain versions on the launch's own inputs. Here the kernels' wrappers
are replaced by CPU stand-ins (the plain versions, one of them off by a
known amount), so that the watcher's plumbing is tested: every
wrapper's signature, one entry per configuration, errors relative to the
largest reference value, 0 where both sides are 0, the launches counted
through the watch, and the wrappers put back on exit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from nemar_tpu_torch.ops import norm, norm_cuda, warp, warp_cuda
from nemar_tpu_torch.utils import image_pool

# added to the K-in stand-in's output: relative to the largest |y| of a
# relu'd instance norm of 8x8 normals (about 2-3), a few times 1e-6
K_IN_OFFSET = 1e-5


def _stand_in(monkeypatch, mod, name, fn):
    """``mod.name`` replaced by ``fn``, counting its launches as the real
    wrappers do: on the name its module binds it to."""

    def wrapper(*args):
        getattr(mod, name).launches += 1
        return fn(*args)

    wrapper.launches = 0
    monkeypatch.setattr(mod, name, wrapper)


def _warp_stand_ins(stand_in):
    stand_in(warp_cuda, "warp_bilinear", lambda img, grid, pm, ac: (
        warp.grid_sample_plain(img, grid, "bilinear", pm, ac)))
    stand_in(warp_cuda, "warp_grid_bwd", lambda img, grid, g, pm, ac, gc: (
        warp._grid_sample_plain_bwd(img, grid, g, pm, ac, img.shape[-1] if gc < 0 else gc)))


@pytest.fixture
def cpu_wrappers(monkeypatch):
    """The four watched wrappers as plain CPU versions (K-in off by
    K_IN_OFFSET), each counting its launches as the real ones do."""

    def stand_in(mod, name, fn):
        _stand_in(monkeypatch, mod, name, fn)

    stand_in(norm_cuda, "instance_norm_act_cuda", lambda x, act, eps, ns: (
        norm.instance_norm_act_plain(x, act, eps, ns) + K_IN_OFFSET,
        norm.instance_norm_stats(x, eps)))
    stand_in(norm_cuda, "instance_norm_act_bwd_cuda",
             lambda x, g, stats, act, ns: norm.instance_norm_act_bwd_plain(x, g, stats, act, ns))
    _warp_stand_ins(stand_in)


def _nudged(y: torch.Tensor) -> torch.Tensor:
    """bf16 y with its largest element moved up by 4 bf16 spacings of it."""
    y = y.float()
    i = int(y.abs().argmax())
    flat = y.flatten().clone()
    flat[i] += 4 * 2.0 ** (np.floor(np.log2(abs(float(flat[i])))) - 7)
    return flat.reshape(y.shape).to(torch.bfloat16)


def test_watch_kernels_bf16_holds_the_variants(monkeypatch):
    """With ``bf16``, the watch holds K-in's and K-in-bwd's bf16 variants
    (stand-ins: the plain versions at bf16, K-in's largest output moved by
    4 spacings) in bf16 spacings, beside K-warp and K-warp-bwd; the fp32
    K-in wrappers are not watched, and check_watched holds the variants
    within BF16_ULPS."""

    def stand_in(mod, name, fn):
        _stand_in(monkeypatch, mod, name, fn)

    stand_in(norm_cuda, "instance_norm_act_bf16_cuda", lambda x, act, eps, ns: (
        _nudged(norm.instance_norm_act_plain(x, act, eps, ns)), norm.instance_norm_stats(x, eps)))
    stand_in(norm_cuda, "instance_norm_act_bwd_bf16_cuda",
             lambda x, g, stats, act, ns: norm.instance_norm_act_bwd_plain(x, g, stats, act, ns))
    _warp_stand_ins(stand_in)
    fp32_in = norm_cuda.instance_norm_act_cuda
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    x, g = chip_smoke.randn(rng, (2, 8, 8, 4)).to(bf), chip_smoke.randn(rng, (2, 8, 8, 4)).to(bf)
    img, grid = chip_smoke.randn(rng, (2, 8, 8, 4)), chip_smoke.smooth_grid(rng, 2, 8, 8)
    wrapper = norm_cuda.instance_norm_act_bf16_cuda
    with chip_smoke.watch_kernels(bf16=True) as seen:
        assert norm_cuda.instance_norm_act_cuda is fp32_in
        _, stats = norm_cuda.instance_norm_act_bf16_cuda(x, "relu", 1e-5, 0.2)
        norm_cuda.instance_norm_act_bwd_bf16_cuda(x, g, stats, "leaky_relu", 0.2)
        # a zero cotangent (a net the loss does not reach yet): 0 on both sides
        norm_cuda.instance_norm_act_bwd_bf16_cuda(x, torch.zeros_like(g), stats, "relu", 0.2)
        warp_cuda.warp_bilinear(img, grid, "zeros", False)
        warp_cuda.warp_grid_bwd(img, grid, img, "zeros", False, 3)
    assert {k: sorted(v) for k, v in seen.items()} == {
        "K-in-bf16": ["2x8x8x4 relu"], "K-in-bwd-bf16": ["2x8x8x4 leaky_relu", "2x8x8x4 relu"],
        "K-warp": ["2x8x8x4 2x8x8x2 zeros False"],
        "K-warp-bwd": ["2x8x8x4 2x8x8x2 zeros False 3"]}
    assert seen["K-in-bf16"]["2x8x8x4 relu"] > chip_smoke.BF16_ULPS
    assert seen["K-in-bwd-bf16"] == {"2x8x8x4 leaky_relu": 0.0, "2x8x8x4 relu": 0.0}
    assert chip_smoke.bf16_ulps(torch.ones(2), torch.zeros(2)) == float("inf")
    with pytest.raises(AssertionError, match="K-in-bf16 disagrees"):
        chip_smoke.check_watched(seen, "cpu")
    seen["K-in-bf16"]["2x8x8x4 relu"] = chip_smoke.BF16_ULPS
    assert chip_smoke.check_watched(seen, "cpu")["K-in-bf16"] == [1, chip_smoke.BF16_ULPS]
    assert norm_cuda.instance_norm_act_bf16_cuda is wrapper and wrapper.launches == 1


def test_bf16_launches_reads_the_variants_count():
    """``Bf16Launches`` reads and sets a wrapper's ``launches_bf16`` as
    ``.launches``, beside the fp32 count."""

    def fn():
        pass

    fn.launches, fn.launches_bf16 = 3, 5
    count = chip_smoke.Bf16Launches(fn)
    assert count.launches == 5
    count.launches = 0
    assert (fn.launches, fn.launches_bf16) == (3, 0)


def test_watch_kernels_holds_each_configuration(cpu_wrappers):
    rng = np.random.default_rng(0)
    x, g = chip_smoke.randn(rng, (2, 8, 8, 4)), chip_smoke.randn(rng, (2, 8, 8, 4))
    img, grid = chip_smoke.randn(rng, (2, 8, 8, 4)), chip_smoke.smooth_grid(rng, 2, 8, 8)
    stand_ins = {name: getattr(norm_cuda, name)
                 for name in ("instance_norm_act_cuda", "instance_norm_act_bwd_cuda")}
    with chip_smoke.watch_kernels() as seen:
        _, stats = norm_cuda.instance_norm_act_cuda(x, "relu", 1e-5, 0.2)
        norm_cuda.instance_norm_act_cuda(x, "relu", 1e-5, 0.2)  # seen: not held again
        norm_cuda.instance_norm_act_cuda(x[:1], "leaky_relu", 1e-5, 0.2)
        # a zero cotangent (the penalty's third norm): 0 on both sides
        norm_cuda.instance_norm_act_bwd_cuda(x, torch.zeros_like(g), stats, "leaky_relu", 0.2)
        warp_cuda.warp_bilinear(img, grid, "zeros", False)
        warp_cuda.warp_grid_bwd(img, grid, g, "zeros", False, 3)
        warp_cuda.warp_grid_bwd(img, grid, g, "border", False, 0)  # d img not taken
    assert {k: sorted(v) for k, v in seen.items()} == {
        "K-in": ["1x8x8x4 leaky_relu", "2x8x8x4 relu"],
        "K-in-bwd": ["2x8x8x4 leaky_relu"],
        "K-warp": ["2x8x8x4 2x8x8x2 zeros False"],
        "K-warp-bwd": ["2x8x8x4 2x8x8x2 border False 0", "2x8x8x4 2x8x8x2 zeros False 3"]}
    # the offset over the largest |y|, give or take fp32's rounding of y +
    # K_IN_OFFSET and of the difference (up to an ulp of |y| < 4, 2.4e-7:
    # 2.4% of the offset)
    y = norm.instance_norm_act_plain(x, "relu")
    assert seen["K-in"]["2x8x8x4 relu"] == pytest.approx(
        K_IN_OFFSET / float(y.abs().max()), rel=0.03)
    assert seen["K-in-bwd"]["2x8x8x4 leaky_relu"] == 0.0
    assert chip_smoke.check_watched(seen, "cpu")["K-warp-bwd"] == [2, 0.0]
    # put back, with the launches made inside counted
    for name, fn in stand_ins.items():
        assert getattr(norm_cuda, name) is fn
    assert [fn.launches for fn in stand_ins.values()] == [3, 1]
    assert (warp_cuda.warp_bilinear.launches, warp_cuda.warp_grid_bwd.launches) == (1, 2)


def test_check_watched_refuses(cpu_wrappers):
    rng = np.random.default_rng(1)
    x = chip_smoke.randn(rng, (1, 8, 8, 4))
    with chip_smoke.watch_kernels() as seen:
        norm_cuda.instance_norm_act_cuda(x * 1e-4, "none", 1e-5, 0.2)
    # |y| is about 1e-4 x 2 / sqrt(1e-8 + 1e-5) = 0.06: the offset is 10x TOL
    with pytest.raises(AssertionError, match="K-in disagrees"):
        chip_smoke.check_watched({**seen, "K-in-bwd": {"-": 0.0}, "K-warp": {"-": 0.0},
                                  "K-warp-bwd": {"-": 0.0}}, "cpu")
    with pytest.raises(AssertionError, match="K-warp was not launched"):
        chip_smoke.check_watched({"K-warp": {}}, "cpu")


def test_watch_pool_counts_swaps_and_repeats():
    """A pool of 4 slots, full: two swaps into slot 1 and one into slot 3
    count 3 swaps, 1 repeated; a fake that takes the fresh image or fills
    counts none; ``query_pool`` is put back on exit."""
    images, count = torch.randn(4, 3, 2, 2), torch.tensor(4)
    tally = {"swaps": 0, "repeated": 0}
    with chip_smoke.watch_pool(tally):
        image_pool.query_pool(images, count, torch.randn(4, 3, 2, 2),
                              torch.tensor([True, True, False, True]), torch.tensor([1, 1, 1, 3]))
        image_pool.query_pool(*image_pool.init_pool(4, (3, 2, 2)), torch.randn(2, 3, 2, 2),
                              torch.tensor([True, True]), torch.tensor([0, 0]))
    assert tally == {"swaps": 3, "repeated": 1}
    assert image_pool.query_pool.__name__ == "query_pool"


def test_pool_last_writer_check_on_the_cpu():
    """``check_pool_last_writer`` from a full pool, the CPU standing in for
    the card; a pool that is not full is refused."""
    pool = (torch.randn(10, 3, 4, 4), torch.tensor(10))
    assert all(chip_smoke.check_pool_last_writer(pool, torch.device("cpu")).values())
    with pytest.raises(AssertionError, match="holds 9 of 10"):
        chip_smoke.check_pool_last_writer((pool[0], torch.tensor(9)), torch.device("cpu"))
