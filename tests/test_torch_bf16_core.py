"""The schedule of the bf16 GEMM core (``nemar_tpu_torch/csrc/gemm_tc.cuh``,
``gemm_bf16_kernel``) that K-block-bf16, K-block-bwd-bf16, K-convt-bf16 and
K-convt-bwd-bf16 run on, written out in torch on the CPU.

- The persistent tile walk (``tile_at``, ``walk_tile``): min(tiles, SMs)
  blocks, block i taking the i-th tile of each round of `blocks` tiles,
  the rounds in alternate directions; tile t is the column tile t % gy,
  then the row tile, then the split. Every tile once, in a fixed order.
- The producer's loads (``ConvOp16``, ``WgradOp16``, ``DgradOp16`` in
  ``csrc/resblock_{fwd,bwd}.cu``): a TMA box (``tma_box``: the tensor's
  values at the box's coordinates, innermost first, zeros outside it, laid
  out row by row with the innermost extent contiguous) of the weights, of
  the wgrads' dz, and of the reflect-padded sources where a tile's pixels
  are image rows; otherwise the cp.async copies, reflected (or, the
  dgrad's dz shifted by the tap, zero-filled off the frame) in the index.
  Gathered tile by tile and K slice by K slice, they are the operands of
  ``resblock_fwd_plain``'s convolutions, ``conv_wgrad_plain`` and
  ``conv_adjoint_plain``.
- The MMA chain and add order: per 64-deep K slice a fresh chain of four
  m64nNk16 MMAs, each summing its 16 products exactly (bf16 x bf16 is exact
  in fp32) and adding them to the chain with one rounding toward zero (the
  tensor core's accumulation); the chain then added to the fp32 total in
  slice order (two chains alternate in registers so that one slice's MMAs
  run while the previous chain is added: the order of the adds is the
  slices'). The wgrads' split partials are summed in split order.

At C = 128 on 8 x 8 frames (every operand a box) and 12 x 12 (the
forward's and the wgrads' sources copied: 12 divides neither 128 nor 64),
batch 1 and 2, the emulated kernels stay within 2e-6 of the largest
float64 value of the plain functions from the same bf16 values; one chain
over the whole K of the realistic depths misses that.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops.conv_fused import conv3x3_reflect, conv_adjoint_plain, conv_wgrad_plain

torch.set_num_threads(2)

BM = 128  # the tile's rows
BK16 = 64  # K depth of one slice, and of one MMA chain
MMA_K = 16  # K depth of one wgmma m64nNk16 bf16
TOL = 2e-6  # of the largest float64 value: the fp32 level, as 3xTF32's (test_torch_tf32_split)


def round_toward_zero(s: torch.Tensor) -> torch.Tensor:
    """fp64 s rounded to fp32 toward zero, as fp64."""
    f = s.float()
    f = torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def chained_gemm(a: torch.Tensor, b: torch.Tensor, chain: int = BK16) -> torch.Tensor:
    """a (M, K) @ b (K, N), both bf16 values held in float64, as the core
    computes it: per ``chain``-deep K slice, chain = RZ(chain + a_k b_k) per
    16-deep MMA (its products summed exactly), then acc += chain in fp32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], chain):
        part = torch.zeros(acc.shape, dtype=torch.float64)
        for k in range(k0, min(k0 + chain, a.shape[1]), MMA_K):
            part = round_toward_zero(part + a[:, k:k + MMA_K] @ b[k:k + MMA_K])
        acc = acc + part.float()
    return acc


def tile_at(t: int, grid: tuple) -> tuple:
    """gemm_tc.cuh's tile_at: (x, y, z) of tile t, the column tile fastest."""
    gx, gy, _ = grid
    y = t % gy
    t //= gy
    return t % gx, y, t // gx


def walk_tile(w: int, i: int, blocks: int) -> int:
    """gemm_tc.cuh's walk_tile: block i's w-th tile, the rounds of `blocks`
    tiles taken in alternate directions."""
    return w * blocks + (blocks - 1 - i if w % 2 else i)


def tile_walk(grid: tuple, sms: int) -> list:
    """The tiles each block of the persistent grid computes, in its order."""
    tiles = grid[0] * grid[1] * grid[2]
    blocks = min(tiles, sms)
    walk = []
    for i in range(blocks):
        mine, w = [], 0
        while (t := walk_tile(w, i, blocks)) < tiles:
            mine.append(tile_at(t, grid))
            w += 1
        walk.append(mine)
    return walk


def tma_box(t: torch.Tensor, coords: tuple, box: tuple) -> torch.Tensor:
    """A TMA box of the contiguous tensor t: coordinates and extents
    innermost first, zeros outside t; (rows, innermost extent), the outer
    coordinates flattened as the box lands in shared memory."""
    dims = t.shape[::-1]
    idx = [torch.arange(c, c + e) for c, e in zip(coords, box)]
    valid = [(i >= 0) & (i < d) for i, d in zip(idx, dims)]
    rank = len(box)
    view = [[1] * rank for _ in range(rank)]
    for k in range(rank):
        view[k][rank - 1 - k] = -1
    sub = t[tuple(i.clamp(0, d - 1).view(v) for i, d, v in
                  zip(idx[::-1], dims[::-1], view[::-1]))]
    mask = math.prod(m.view(v) for m, v in zip(valid, view))
    return (sub * mask).reshape(-1, box[0])


def reflect(i: int, n: int) -> int:
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


def reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """(N, H + 2, W + 2, C): the padded copy the forward and the pad pass write."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1).contiguous()


def row_boxes(w: int, pixels: int) -> bool:
    """resblock_fwd.cu's row_boxes (pixels 128) and resblock_bwd.cu's
    slice_boxes (pixels 64): a tile's or slice's pixels are a box of image rows."""
    return w % pixels == 0 or pixels % w == 0


def conv_core(src: torch.Tensor, w: torch.Tensor, tn: int = 128, sms: int = 5) -> torch.Tensor:
    """ConvOp16's GEMM: y (N, H, W, C) of a 3x3 conv over reflect-padded src."""
    n, h, wd, c = src.shape
    hw, tiles = h * wd, -(-h * wd // BM)
    wt = w.permute(0, 1, 3, 2).reshape(9 * c, c).contiguous()  # W^T per tap: (tap, co) rows of ci
    boxes = row_boxes(wd, BM)
    pad = reflect_pad(src)
    bw = min(wd, BM)
    y = torch.zeros((n, hw, c), dtype=torch.float32)
    for block in tile_walk((n * tiles, c // tn, 1), sms):
        for bx, by, _ in block:
            b, tile = divmod(bx, tiles)
            m0, n0 = tile * BM, by * tn
            a_sl, b_sl = [], []
            for kt in range(9 * c // BK16):
                tap, ci = divmod(kt * BK16, c)
                dy, dx = divmod(tap, 3)
                if boxes:
                    u0, v0 = divmod(m0, wd)
                    a = tma_box(pad, (ci, v0 + dx, u0 + dy, b), (BK16, bw, BM // bw, 1))
                else:
                    a = torch.zeros((BM, BK16), dtype=src.dtype)
                    for r in range(BM):
                        if m0 + r < hw:
                            u, v = divmod(m0 + r, wd)
                            a[r] = src[b, reflect(u + dy - 1, h), reflect(v + dx - 1, wd),
                                       ci:ci + BK16]
                a_sl.append(a)
                b_sl.append(tma_box(wt, (ci, tap * c + n0), (BK16, tn)).T)
            acc = chained_gemm(torch.cat(a_sl, 1), torch.cat(b_sl, 0))
            rows = min(BM, hw - m0)
            y[b, m0:m0 + rows, n0:n0 + tn] = acc[:rows]
    return y.reshape(n, h, wd, c)


def wgrad_core(src: torch.Tensor, dz: torch.Tensor, splits: int, sms: int = 7) -> torch.Tensor:
    """WgradOp16's split-K GEMM and the finish's sum of its partials in split
    order: dW (3, 3, C, C) of a 3x3 conv over reflect-padded src."""
    n, h, wd, c = src.shape
    hw = h * wd
    kps = -(-hw // BK16)
    total = n * kps
    boxes = row_boxes(wd, BK16)
    pad = reflect_pad(src)
    bw = min(wd, BK16)
    dz3 = dz.reshape(n, hw, c)
    part = torch.zeros((splits, 9 * c, c), dtype=torch.float32)
    for block in tile_walk((9 * c // BM, c // BM, splits), sms):
        for bx, by, bz in block:
            m0, n0 = bx * BM, by * BM
            tap, ci0 = divmod(m0, c)
            dy, dx = divmod(tap, 3)
            kt0, kt1 = bz * total // splits, (bz + 1) * total // splits
            a_sl, b_sl = [], []
            for sl in range(kt0, kt1):
                b, q = divmod(sl, kps)
                q0 = q * BK16
                if boxes:
                    u0, v0 = divmod(q0, wd)
                    a = torch.cat([tma_box(pad, (ci0 + 64 * j, v0 + dx, u0 + dy, b),
                                           (BK16, bw, BK16 // bw, 1)) for j in range(2)], 1)
                else:
                    a = torch.zeros((BK16, BM), dtype=src.dtype)
                    for k in range(BK16):
                        if q0 + k < hw:
                            u, v = divmod(q0 + k, wd)
                            a[k] = src[b, reflect(u + dy - 1, h), reflect(v + dx - 1, wd),
                                       ci0:ci0 + BM]
                a_sl.append(a)
                b_sl.append(torch.cat([tma_box(dz3, (n0 + 64 * j, q0, b), (BK16, BK16, 1))
                                       for j in range(2)], 1))
            if a_sl:
                part[bz, m0:m0 + BM, n0:n0 + BM] = chained_gemm(torch.cat(a_sl, 0).T,
                                                                torch.cat(b_sl, 0))
    dw = part[0]
    for s in range(1, splits):
        dw = dw + part[s]
    return dw.reshape(3, 3, c, c)


def dgrad_core(dz: torch.Tensor, w: torch.Tensor, sms: int = 6) -> torch.Tensor:
    """DgradOp16's GEMM: dpad (N, H + 2, W + 2, C), dz shifted by each tap
    (copies, zero off the frame) against W in HWIO (boxes along co)."""
    n, h, wd, c = dz.shape
    wp, plane = wd + 2, (h + 2) * (wd + 2)
    rows = n * plane
    w2 = w.reshape(9 * c, c)  # (tap, ci) rows of co
    dpad = torch.zeros((rows, c), dtype=torch.float32)
    for block in tile_walk((-(-rows // BM), c // BM, 1), sms):
        for bx, by, _ in block:
            m0, n0 = bx * BM, by * BM
            a_sl, b_sl = [], []
            for kt in range(9 * c // BK16):
                tap, co = divmod(kt * BK16, c)
                dy, dx = divmod(tap, 3)
                a = torch.zeros((BM, BK16), dtype=dz.dtype)
                for r in range(BM):
                    m = m0 + r
                    b, rr = divmod(m, plane)
                    u, v = divmod(rr, wp)
                    si, sj = u - dy, v - dx
                    if m < rows and 0 <= si < h and 0 <= sj < wd:
                        a[r] = dz[b, si, sj, co:co + BK16]
                a_sl.append(a)
                b_sl.append(tma_box(w2, (co, tap * c + n0), (BK16, BM)).T)
            acc = chained_gemm(torch.cat(a_sl, 1), torch.cat(b_sl, 0))
            valid = min(BM, rows - m0)
            dpad[m0:m0 + valid, n0:n0 + BM] = acc[:valid]
    return dpad.reshape(n, h + 2, wd + 2, c)


def bf16_values(rng, shape, scale) -> torch.Tensor:
    """Seeded values exactly representable in bf16, held in float64."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).double()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("grid,sms", [((2, 2, 1), 132), ((64, 2, 1), 132), ((18, 2, 11), 132),
                                      ((9, 1, 3), 4), ((35, 2, 1), 6)],
                         ids=["b1_fewer_tiles", "b1_narrow", "wgrad_b8", "wgrad_small", "dgrad"])
def test_tile_walk_covers_each_tile_once_in_a_fixed_order(grid, sms):
    walk = tile_walk(grid, sms)
    flat = [t for block in walk for t in block]
    every = {(x, y, z) for x in range(grid[0]) for y in range(grid[1]) for z in range(grid[2])}
    assert len(flat) == len(every) and set(flat) == every
    assert len(walk) == min(len(every), sms)
    # round k is tiles k blocks .. (k + 1) blocks - 1, block i taking the
    # i-th of an even round and the i-th from the end of an odd one; the
    # column tiles of a row tile are neighbours (they share A's slices in L2)
    order = sorted(every, key=lambda t: (t[2], t[0], t[1]))
    n = len(walk)
    for i, block in enumerate(walk):
        want = [k * n + (n - 1 - i if k % 2 else i) for k in range(len(order) // n + 1)]
        assert block == [order[t] for t in want if t < len(order)]


def test_tma_box_is_the_index_map():
    """A box of the padded source is the reflect index map of the plain
    convolution; outside the tensor it is zeros."""
    rng = np.random.default_rng(0)
    x = bf16_values(rng, (2, 4, 8, 128), 1.0)
    pad = reflect_pad(x)
    box = tma_box(pad, (64, 3, 1, 1), (64, 8, 2, 1))
    want = torch.stack([x[1, reflect(u - 1, 4), reflect(v - 1, 8), 64:]
                        for u in (1, 2) for v in range(3, 11)])
    got = box.reshape(2, 8, 64)[:, :7].reshape(-1, 64)
    assert torch.equal(got, torch.cat([want[:7], want[8:15]]))
    assert torch.equal(box.reshape(2, 8, 64)[:, 7], torch.zeros(2, 64, dtype=x.dtype))
    assert torch.equal(tma_box(pad, (0, 0, 6, 1), (64, 8, 2, 1)), torch.zeros(16, 64, dtype=x.dtype))


FRAMES = [(1, 8), (2, 8), (1, 12), (2, 12)]
FRAME_IDS = ["b1_8x8_boxes", "b2_8x8_boxes", "b1_12x12_copies", "b2_12x12_copies"]


@pytest.mark.parametrize("n,side", FRAMES, ids=FRAME_IDS)
def test_forward_conv_schedule_is_fp32_accurate(n, side):
    rng = np.random.default_rng(side + n)
    x = bf16_values(rng, (n, side, side, 128), 1.0)
    w = bf16_values(rng, (3, 3, 128, 128), 0.05)
    for tn in (128, 64):
        assert rel_err(conv_core(x, w, tn), conv3x3_reflect(x, w)) < TOL


@pytest.mark.parametrize("n,side", FRAMES, ids=FRAME_IDS)
def test_wgrad_schedule_is_fp32_accurate(n, side):
    rng = np.random.default_rng(10 * side + n)
    src = bf16_values(rng, (n, side, side, 128), 1.0)
    dz = bf16_values(rng, (n, side, side, 128), 1.0)
    kps = -(-side * side // BK16)
    for splits in sorted({1, min(3, n * kps)}):
        assert rel_err(wgrad_core(src, dz, splits), conv_wgrad_plain(src, dz)) < TOL


@pytest.mark.parametrize("n,side", [(1, 8), (2, 12)], ids=["b1_8x8", "b2_12x12"])
def test_dgrad_schedule_is_fp32_accurate(n, side):
    rng = np.random.default_rng(100 + side + n)
    dz = bf16_values(rng, (n, side, side, 128), 1.0)
    w = bf16_values(rng, (3, 3, 128, 128), 0.05)
    assert rel_err(dgrad_core(dz, w), conv_adjoint_plain(dz, w)) < TOL


# K depths of the bf16 core's GEMMs at the trunk's 256 channels: the
# forward's convolutions and the dgrads (9 x 256), a wgrad split over 512
# and 4096 pixels; K-convt's 4-tap plane (4 x 256) and its dgrad (9 x 128)
DEPTHS = [9 * 256, 512, 4096, 4 * 256, 9 * 128]
DEPTH_IDS = ["conv_K2304", "wgrad_split_K512", "wgrad_K4096", "convt_plane_K1024",
             "convt_dgrad_K1152"]


def _operands(k: int) -> tuple:
    rng = np.random.default_rng(k)
    a = bf16_values(rng, (48, k), 1.0)
    b = bf16_values(rng, (k, 40), 1.0)
    ref = a @ b
    return a, b, lambda got: rel_err(got, ref)


@pytest.mark.parametrize("k", DEPTHS, ids=DEPTH_IDS)
def test_slice_chains_are_fp32_accurate(k):
    a, b, err = _operands(k)
    e16, e32 = err(chained_gemm(a, b)), err((a.float() @ b.float()))
    assert e16 < TOL, (e16, e32)
    assert e16 < 10 * max(e32, 1e-7)


@pytest.mark.parametrize("k", [d for d in DEPTHS if d > 2000],
                         ids=[i for d, i in zip(DEPTHS, DEPTH_IDS) if d > 2000])
def test_one_chain_over_the_whole_k_is_not_fp32_accurate(k):
    """The per-slice chain is what keeps the bf16 core at fp32's level: the
    same MMAs chained over the whole K miss the limit."""
    a, b, err = _operands(k)
    assert err(chained_gemm(a, b, chain=k)) > TOL
