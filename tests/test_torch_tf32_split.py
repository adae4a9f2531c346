"""The 3xTF32 arithmetic of the tensor-core GEMMs of K-block, K-block-bwd,
K-convt and K-convt-bwd (``nemar_tpu_torch/csrc/gemm_tc.cuh``), emulated in
torch on the CPU.

``tf32`` mirrors ``cvt.rna.tf32.f32`` (round to nearest, ties away from
zero, to 10 explicit mantissa bits: add half of the dropped 13 bits to the
bit pattern, then clear them); the core does that with two integer ops.
``gemm_3xtf32`` mirrors the core's order: each fp32 operand is split into
big = tf32(x) and small = x - big (of which the MMA reads the top 19 bits);
per 32-deep K slice (the core's BK) a fresh chain of 4 k-steps x 3 MMAs,
m64n128k8 each, takes small_a * big_b, then big_a * small_b, then big_a *
big_b, and the chain's value is then added to the fp32 total (round to
nearest). The tensor core's own accumulation is modelled as rounding toward
zero: each MMA's 8 products are summed exactly and added to the chain's
value with one truncation to fp32. A chain as long as the whole K piles up
that bias: over K = 2304 the model gives 2.5e-5 of the largest value, as the
card gave on a single-chain build (``PERF.md``, section 6), so the slice length
of the chain is what this file holds.

On a dgrad-shaped product (K = 9 C at C = 256) and a wgrad-shaped one
(K = 4096 pixels), 3xTF32 in 32-deep chains stays within 2e-6 of the
largest fp64 value, where 1xTF32 (big_a * big_b alone) misses by more than
1e-4, and one chain over the whole K by more than 2e-6: the kernel's fp64
check on the card (``chip_smoke.py`` phase 2b) tells them apart.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BK = 32  # K depth of one slice of gemm_tc.cuh, and of one MMA chain
MMA_K = 8  # K depth of one wgmma m64n128k8 tf32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of fp32 x, as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma_operand(x: torch.Tensor) -> torch.Tensor:
    """What the MMA reads of an fp32 register given as tf32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    """(big, small) as the MMA reads them: big = tf32(x), small = x - big."""
    big = tf32(x)
    return big, mma_operand(x - big)


def round_toward_zero(s: torch.Tensor) -> torch.Tensor:
    """fp64 s rounded to fp32 toward zero, as fp64."""
    f = s.float()
    f = torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def gemm_3xtf32(a: torch.Tensor, b: torch.Tensor, terms: int = 3, chain: int = BK) -> torch.Tensor:
    """fp32 a (M, K) @ b (K, N) as the core computes it: per ``chain``-deep K
    slice, per 8-deep k-step, chain += small_a big_b, chain += big_a small_b,
    chain += big_a big_b (terms=3), or chain += big_a big_b alone (terms=1),
    each MMA rounding toward zero; then acc += chain in fp32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    order = [(as_, bb), (ab, bs), (ab, bb)] if terms == 3 else [(ab, bb)]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], chain):
        part = torch.zeros(acc.shape, dtype=torch.float64)
        for k in range(k0, min(k0 + chain, a.shape[1]), MMA_K):
            for x, y in order:
                part = round_toward_zero(part + x[:, k:k + MMA_K].double() @ y[k:k + MMA_K].double())
        acc = acc + part.float()
    return acc


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -1.0 - 2.0**-11,
                      1.0 + 2.0**-12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -1.0 - 2.0**-10, 1.0])
    assert torch.equal(tf32(x), want)  # ties away from zero, both signs
    x = torch.tensor([np.pi, -1e-3, 7.5e4], dtype=torch.float32)
    big, small = split(x)
    # big + small keeps ~22 of fp32's 24 bits
    assert torch.all((big.double() + small.double() - x.double()).abs() <= 2.0**-21 * x.abs())
    assert torch.equal(tf32(big), big) and torch.equal(mma_operand(small), small)
    # toward zero, both signs; exact values stay
    s = torch.tensor([1.0 + 2.0**-30, -1.0 - 2.0**-30, 0.75], dtype=torch.float64)
    assert torch.equal(round_toward_zero(s), torch.tensor([1.0, -1.0, 0.75], dtype=torch.float64))


def _operands(k: int) -> tuple:
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((48, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 40)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    return a, b, lambda got: float((got.double() - ref).abs().max()) / scale


# K depths of the GEMMs on the core: K-block(-bwd)'s dgrad (9 x 256) and a
# wgrad over 4096 pixels; K-convt's 4-tap plane at the first decoder stage
# (4 x 256), K-convt-bwd's dgrad (9 x 128 at both stages) and its wgrad per
# pixel split at batch 8 (1504 and 3008 pixels, ops/convt_fused.py)
DEPTHS = [9 * 256, 4096, 4 * 256, 9 * 128, 1504, 3008]
DEPTH_IDS = ["dgrad_K2304", "wgrad_K4096", "convt_plane_K1024", "convt_dgrad_K1152",
             "convt_wgrad_split_K1504", "convt_wgrad_split_K3008"]


@pytest.mark.parametrize("k", DEPTHS, ids=DEPTH_IDS)
def test_3xtf32_is_fp32_accurate_and_1xtf32_is_not(k):
    a, b, err = _operands(k)
    e3, e1 = err(gemm_3xtf32(a, b)), err(gemm_3xtf32(a, b, terms=1))
    e32 = err(a @ b)
    assert e3 < 2e-6, (e3, e32)
    assert e1 > 1e-4, e1
    assert e3 < 10 * max(e32, 1e-7)


@pytest.mark.parametrize("k", DEPTHS, ids=DEPTH_IDS)
def test_one_chain_over_the_whole_k_is_not_fp32_accurate(k):
    """The core's per-slice chain is what keeps 3xTF32 at fp32's level: the
    same MMAs chained over the whole K miss the 2e-6 limit."""
    a, b, err = _operands(k)
    assert err(gemm_3xtf32(a, b, chain=k)) > 2e-6
