"""The schedule of K-convt-bf16 and K-convt-bwd-bf16
(``nemar_tpu_torch/csrc/convt_fwd.cu``, ``convt_bwd.cu``), written out in
torch on the CPU and held against the JAX package's ``convt_in_reference``
(``nemar_tpu/ops/attic/convt_fused.py``) in float64 and against the port's
plain versions at bf16.

The forward (``ConvtFwdOp16`` on ``gemm_bf16_kernel``):

- Two passes over the same tiles. Pass 1's epilogue keeps only each tile's
  per-column statistics, the merge turns them into (mu, rstd), and pass 2
  recomputes every tile with the same slices in the same order and writes
  yhat = (acc - mu) rstd and relu(yhat) from its fp32 totals. No fp32 y
  reaches memory, and pass 2's totals are pass 1's bit for bit, whichever
  block of the persistent walk computes a tile.
- The parity planes' slices: a row tap (ky, dy), a column tap (kx, dx) and
  64 channels. A is a TMA box of x at the slice's offset (the -1 offsets'
  zeros are the box's out-of-bounds fill) where a tile's 128 pixels are
  image rows, else the producer's masked copies.
- B is W as it lies (N-major), in TMA boxes of 64 Co x 64 Ci of one tap,
  streamed through the ring with A.
- Co <= 64 is folded: a tile holds both column parities of a row parity
  (columns 64 px + c), its slices (ky, dx = 0 then -1, 64 channels), B
  [W(ky, 2) | W(ky, 1)] and [W(ky, 0) | 0] (a box past the taps). Each
  column's totals are the unfolded plane's bit for bit (the zeros add
  exact zeros).

The statistics' merges (``convt_stats16_kernel``, ``convt_means16_kernel``):
fp64, group k of 128 threads a channel the partials k, k + 128, ..., the
groups added by a fixed pairwise tree. The backward's instance-norm
partials (``convt_partial16_kernel``): per tile of ``partial16_tile``
output pixels, the block's lanes (256 / (Co / 8) pixels side by side) each
summing their pixels in order in fp32 (s2 by fma), the lanes added in
order; dz = rstd (gh - m1 - yhat m2) rounded to bf16. Then the weight gradient (split over pixel ranges, K
slices of 64 pixels, the splits summed in order; at Co <= 64 and splits
of 16 slices or more folded, a tile (ky, dx) against both column
parities, each column bit for bit the tap's own) and the dgrad (K slices of one
tap and 64 channels) on the core's chains.

At 8 x 8 frames (every A a box) and 12 x 12 (copies: 12 divides neither
128 nor 64), batch 1 and 2, Ci 128 -> Co 64 (folded) and 128: the emulated
kernels' fp32 results stay within 2e-6 of the largest float64 value
(``test_torch_bf16_core.TOL``) of the same math from the same bf16 values,
and their bf16 outputs within one bf16 spacing of the plain versions'.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bf16_core as core
from nemar_tpu.ops.attic.convt_fused import convt_in_reference
from nemar_tpu_torch.ops.convt_fused import (
    convt_flax, convt_in_bwd_plain, convt_in_fwd_plain, wgrad_splits,
)

torch.set_num_threads(2)

BM, BK16, MMA_K = core.BM, core.BK16, core.MMA_K
SMS = 132
EPS = 1e-5
TOL = core.TOL
# per axis, output parity -> [(kernel index, input offset)] (the TPU kernel's _AX)
AX = {0: [(2, 0), (0, -1)], 1: [(1, 0)]}
# the folded tile's column taps: dx = 0 then -1 (kx 2 | 1, then kx 0 | zeros)
FOLD_X = [(2, 0), (0, -1)]


@contextlib.contextmanager
def jax_float64():
    """JAX with 64-bit types, and ``jnp.float32`` read as float64, so that
    ``convt_in_reference`` (which casts to float32) computes in float64."""
    f32, x64 = jnp.float32, jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32
        jax.config.update("jax_enable_x64", x64)


@functools.lru_cache(maxsize=None)
def jax_reference(case: tuple) -> tuple:
    """(out, dx, dw) of ``convt_in_reference`` and its VJP in float64, one
    jitted program a case."""
    x, w, g = (t.numpy() for t in inputs(*case))
    with jax_float64():
        def fwd_bwd(x, w, g):
            out, vjp = jax.vjp(convt_in_reference, x, w)
            return (out, *vjp(g))

        res = jax.jit(fwd_bwd)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
        return tuple(torch.from_numpy(np.array(r, dtype=np.float64)) for r in res)


@functools.lru_cache(maxsize=None)
def inputs(n: int, side: int, ci: int, co: int) -> tuple:
    """Seeded x, W and g = d out, bf16 values held in float64."""
    rng = np.random.default_rng(1000 * n + 10 * side + co)
    return (core.bf16_values(rng, (n, side, side, ci), 1.0),
            core.bf16_values(rng, (3, 3, ci, co), 0.05),
            core.bf16_values(rng, (n, 2 * side, 2 * side, co), 1.0))


def rz_chain(part: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One slice's chain of four MMAs (m64nNk16), each adding its 16
    products, exact, to the chain with one rounding toward zero."""
    for k in range(0, a.shape[1], MMA_K):
        part = core.round_toward_zero(part + a[:, k:k + MMA_K] @ b[k:k + MMA_K])
    return part


def slice_sum(a_sl: list, b_sl: list) -> torch.Tensor:
    """The consumers' total over a tile's slices: per slice a fresh chain,
    added to the fp32 total in slice order."""
    acc = torch.zeros((a_sl[0].shape[0], b_sl[0].shape[1]), dtype=torch.float32)
    for a, b in zip(a_sl, b_sl):
        acc = acc + rz_chain(torch.zeros(acc.shape, dtype=torch.float64), a, b).float()
    return acc


def b_tile(w: torch.Tensor, ky: int, kx: int, tx: int, c0: int, n0: int, fold: bool,
           tn: int = 128) -> torch.Tensor:
    """B of a slice, (64 Ci rows, tn columns): the TMA boxes of W as it lies,
    (9, Ci, Co) N-major, 64 Co x 64 Ci of one tap each (zeros past Ci, Co and
    the taps). Folded: [W(ky, kx) | W(ky, 1)] at dx = 0 (tx 0) and
    [W(ky, 0) | tap 9's zeros] at dx = -1 (tx 1), the parities 64 columns
    apart."""
    wv = w.reshape(9, w.shape[2], w.shape[3])
    taps = ([ky * 3 + kx, ky * 3 + 1 if tx == 0 else 9] if fold else [ky * 3 + kx] * (tn // 64))
    return torch.cat([core.tma_box(wv, (0 if fold else n0 + 64 * j, c0, t), (64, BK16, 1))
                      for j, t in enumerate(taps)], 1)


def fwd_grid(n: int, h: int, w: int, co: int) -> tuple:
    """The forward's launch: (fold, kTN, planes, tiles, column tiles),
    nemar_convt_in_fwd_bf16's rule (fold at Co <= 64; 128 columns a tile)."""
    tiles = -(-h * w // BM)
    if co <= 64:
        return True, 128, 2, tiles, 1
    return False, 128, 4, tiles, -(-co // 128)


def fwd_slices(py: int, px: int, fold: bool, ci: int) -> list:
    """A tile's K slices in order: (ky, kx, tx, dy, dx, first channel)."""
    out = []
    for ky, dy in AX[py]:
        for tx, (kx, dx) in enumerate(FOLD_X if fold else AX[px]):
            for c0 in range(0, ci, BK16):
                out.append((ky, kx, tx, dy, dx, c0))
    return out


def a_tile(x: torch.Tensor, b: int, m0: int, dy: int, dx: int, c0: int) -> torch.Tensor:
    """A of a slice: the TMA box of x at (c0, v0 + dx, u0 + dy, b) where the
    tile's pixels are image rows, else the masked copies (zeros off the
    frame, past the plane and past Ci)."""
    _, h, wd, ci = x.shape
    if core.row_boxes(wd, BM):
        u0, v0 = divmod(m0, wd)
        bw = min(wd, BM)
        return core.tma_box(x, (c0, v0 + dx, u0 + dy, b), (BK16, bw, BM // bw, 1))
    a = torch.zeros((BM, BK16), dtype=x.dtype)
    for r in range(BM):
        if m0 + r < h * wd:
            i, j = divmod(m0 + r, wd)
            if i + dy >= 0 and j + dx >= 0:
                a[r, :max(0, min(BK16, ci - c0))] = x[b, i + dy, j + dx, c0:c0 + BK16]
    return a


def fwd_pass(x: torch.Tensor, w: torch.Tensor, sms: int, fold: bool | None = None) -> dict:
    """One pass of ConvtFwdOp16 over the persistent walk of ``sms`` blocks:
    {tile (plane, b, row tile, column tile): (its fp32 totals, the block
    that computed it)}; ``fold`` overrides the launch's rule."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    rule, tn, planes, tiles, cotiles = fwd_grid(n, h, wd, co)
    if fold is not None and fold != rule:
        rule, tn, planes, cotiles = fold, 128, (2 if fold else 4), 1
    out = {}
    for block, tiles_of_block in enumerate(core.tile_walk((planes * n * tiles * cotiles, 1, 1),
                                                          sms)):
        for t in tiles_of_block:
            bid = t[0]
            cot, bid = bid % cotiles, bid // cotiles
            tile, bid = bid % tiles, bid // tiles
            b, plane = bid % n, bid // n
            py, px = (plane, 0) if rule else divmod(plane, 2)
            m0, n0 = tile * BM, cot * tn
            sl = fwd_slices(py, px, rule, ci)
            a_sl = [a_tile(x, b, m0, dy, dx, c0) for _, _, _, dy, dx, c0 in sl]
            b_sl = [b_tile(w, ky, kx, tx, c0, n0, rule, tn) for ky, kx, tx, _, _, c0 in sl]
            key = (plane, b, tile, cot)
            assert key not in out
            out[key] = (slice_sum(a_sl, b_sl), block)
    assert len(out) == planes * n * tiles * cotiles
    return {"tiles": out, "fold": rule, "tn": tn, "tiles_per_plane": tiles}


def interleave(x: torch.Tensor, co: int, res: dict, fn) -> torch.Tensor:
    """Each tile's fn(totals, b, columns' channels) at its interleaved place
    in the (N, 2H, 2W, Co) output, rows past the plane dropped."""
    n, h, wd, _ = x.shape
    out = torch.zeros((n, 2 * h, 2 * wd, co), dtype=torch.float64)
    for (plane, b, tile, cot), (acc, _) in res["tiles"].items():
        py, px0 = (plane, 0) if res["fold"] else divmod(plane, 2)
        rows = min(BM, h * wd - tile * BM)
        for col in range(res["tn"]):
            nn = cot * res["tn"] + col
            px, c = (nn // 64, nn % 64) if res["fold"] else (px0, nn)
            if c >= co:
                continue
            p = torch.arange(tile * BM, tile * BM + rows)
            i, j = p // wd, p % wd
            out[b, 2 * i + py, 2 * j + px, c] = fn(acc[:rows, col], b, c).double()
    return out


GROUPS = 128  # the merges' thread groups a channel (tc::group_sum)


def group_sum(red: torch.Tensor) -> torch.Tensor:
    """tc::group_sum: the groups' fp64 sums (groups first) added by a fixed
    pairwise tree, group g taking g + half for half = 64, 32, ..., 1."""
    red = red.clone()
    half = red.shape[0] // 2
    while half >= 1:
        red[:half] += red[half:2 * half]
        half //= 2
    return red[0]


def merged_stats(y32: torch.Tensor, tiles: int, hw: int) -> torch.Tensor:
    """Pass 1's tile statistics (each tile's per-column mean and sum of
    squared deviations over its pixels, fp32) merged as
    convt_stats16_kernel merges them: fp64, group k of 128 the partials k,
    k + 128, ... (plane-major, each weighted by its tile's pixels), the
    groups by group_sum, the mean first; (N, 2, Co) = (mu, rstd) fp32."""
    n, _, _, co = y32.shape
    part = []
    for py in (0, 1):
        for px in (0, 1):
            plane = y32[:, py::2, px::2].reshape(n, hw, co).float()
            for t in range(tiles):
                blk = plane[:, t * BM:(t + 1) * BM]
                mean = blk.sum(1) / blk.shape[1]
                part.append((blk.shape[1], mean, ((blk - mean[:, None]) ** 2).sum(1)))
    red = torch.zeros((GROUPS, n, co), dtype=torch.float64)
    for e, (cnt, mean, _) in enumerate(part):
        red[e % GROUPS] += cnt * mean.double()
    mean = group_sum(red) / (4.0 * hw)
    red.zero_()
    for e, (cnt, m, m2) in enumerate(part):
        d = m.double() - mean
        red[e % GROUPS] += m2.double() + cnt * d * d
    rstd = 1.0 / torch.sqrt(group_sum(red) / (4.0 * hw) + EPS)
    return torch.stack([mean.float(), rstd.float()], 1)


@functools.lru_cache(maxsize=None)
def emulated_forward(case: tuple) -> dict:
    x, w, _ = inputs(*case)
    n, h, wd, _ = x.shape
    co = w.shape[3]
    first = fwd_pass(x, w, SMS)
    y32 = interleave(x, co, first, lambda acc, b, c: acc)
    stats = merged_stats(y32, first["tiles_per_plane"], h * wd)
    second = fwd_pass(x, w, 1)  # another walk: one block computes every tile
    yhat32 = interleave(x, co, second,
                        lambda acc, b, c: (acc - stats[b, 0, c]) * stats[b, 1, c])
    return {"first": first, "second": second, "y32": y32, "stats": stats, "yhat32": yhat32,
            "yhat": yhat32.float().to(torch.bfloat16)}


CASES = [(n, side, 128, co) for co in (64, 128) for n, side in core.FRAMES]
CASE_IDS = [f"{i}_co{co}" for co in (64, 128) for i in core.FRAME_IDS]


def test_fwd_walks_cover_each_tile_once():
    """The folded grid (2 planes) and the unfolded one (4 planes, one or
    more column tiles) walked by the persistent blocks: every tile once."""
    for n, side, co in ((2, 12, 64), (1, 8, 64), (2, 12, 128), (8, 64, 64)):
        fold, _, planes, tiles, cotiles = fwd_grid(n, side, side, co)
        grid = (planes * n * tiles * cotiles, 1, 1)
        for sms in (SMS, 5):
            flat = [t for blk in core.tile_walk(grid, sms) for t in blk]
            assert sorted(flat) == [(t, 0, 0) for t in range(grid[0])]
        assert fold == (co <= 64)


def test_fwd_slices_and_boxes_are_the_parity_index_map():
    """Each folded slice's A box and B boxes compute the parity planes'
    taps: the box at a -1 offset is x shifted with zeros at row or column
    0; B's px = 1 half (64 columns on) is W(ky, 1) at dx = 0 and zeros (a
    box past the taps) at dx = -1; the slices of a py = 0 tile in order
    (ky, kx, dx slice, dy, dx)."""
    rng = np.random.default_rng(7)
    x = core.bf16_values(rng, (2, 8, 8, 64), 1.0)
    w = core.bf16_values(rng, (3, 3, 64, 16), 1.0)
    for dy, dx in ((0, 0), (-1, 0), (0, -1), (-1, -1)):
        a = a_tile(x, 1, 0, dy, dx, 0)[:64].reshape(8, 8, 64)
        want = torch.zeros_like(a)
        want[-dy:, -dx:] = x[1, :8 + dy, :8 + dx]
        assert torch.equal(a, want)
    for ky in range(3):
        b0, b1 = b_tile(w, ky, 2, 0, 0, 0, True), b_tile(w, ky, 0, 1, 0, 0, True)
        assert torch.equal(b0[:, :16], w[ky, 2]) and torch.equal(b0[:, 64:80], w[ky, 1])
        assert torch.equal(b1[:, :16], w[ky, 0]) and not b1[:, 16:].any()
        assert not b0[:, 16:64].any() and not b0[:, 80:].any()
    assert [s[:5] for s in fwd_slices(0, 0, True, 128)] == [
        (2, 2, 0, 0, 0), (2, 2, 0, 0, 0), (2, 0, 1, 0, -1), (2, 0, 1, 0, -1),
        (0, 2, 0, -1, 0), (0, 2, 0, -1, 0), (0, 0, 1, -1, -1), (0, 0, 1, -1, -1)]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fwd_two_passes_and_fold_are_bit_exact(case):
    """Pass 2's totals are pass 1's bit for bit though another block of
    another walk computes each tile; at Co <= 64 the folded tiles' totals
    are the unfolded planes' bit for bit."""
    em = emulated_forward(case)
    first, second = em["first"]["tiles"], em["second"]["tiles"]
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k][0], second[k][0]) for k in first)
    assert any(first[k][1] != second[k][1] for k in first) or len(first) == 1
    x, w, _ = inputs(*case)
    if w.shape[3] <= 64:
        unfolded = fwd_pass(x, w, SMS, fold=False)
        y_unf = interleave(x, w.shape[3], unfolded, lambda acc, b, c: acc)
        assert torch.equal(y_unf, em["y32"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fwd_schedule_is_fp32_accurate(case):
    """y (pass 1's totals) against the float64 transposed convolution, and
    out = relu(yhat) of pass 2 against the JAX package's
    ``convt_in_reference`` in float64; the bf16 yhat within one bf16
    spacing of the plain version's at bf16 (float64 work, rounded as the
    kernel rounds), the statistics within 2e-6."""
    x, w, _ = inputs(*case)
    em = emulated_forward(case)
    assert core.rel_err(em["y32"], convt_flax(x, w)) < TOL
    out32 = em["yhat32"].clamp_min(0.0)
    assert core.rel_err(out32, jax_reference(case)[0]) < TOL
    _, yhat_plain, stats_plain = convt_in_fwd_plain(x.to(torch.bfloat16), w.to(torch.bfloat16),
                                                    work=torch.float64)
    assert core.rel_err(em["stats"][:, 0], stats_plain[:, 0]) < TOL
    assert core.rel_err(em["stats"][:, 1], stats_plain[:, 1]) < TOL
    assert bf16_ulps(em["yhat"], yhat_plain) <= 1.0


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor, at_scale: bool = False) -> float:
    """``chip_smoke.bf16_ulps``: the largest |got - ref| in bf16 spacings of
    ref's value, taken at no less than 1e-3 of the largest (an element that
    cancels to near 0 carries the sums' roundoff in absolute terms), or with
    ``at_scale`` of the largest value."""
    got, ref = got.double(), ref.double()
    top = float(ref.abs().max())
    mag = torch.full_like(ref, top) if at_scale else ref.abs().clamp_min(1e-3 * top)
    return float(((got - ref).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def quad_transpose(w: list) -> list:
    """tc::quad_transpose over the 4 lanes of a quad: w[t][k] lane t's word
    k; two butterflies of __shfl_xor_sync (xor 1, then xor 2), each lane
    sending the word its partner keeps and keeping the one it receives."""
    w = [list(v) for v in w]
    for mask, pairs in ((1, ((0, 1), (2, 3))), (2, ((0, 2), (1, 3)))):
        sent = [[v[lo] if t & mask else v[hi] for lo, hi in pairs] for t, v in enumerate(w)]
        for t, v in enumerate(w):
            for i, (lo, hi) in enumerate(pairs):
                if t & mask:
                    v[lo] = sent[t ^ mask][i]
                else:
                    v[hi] = sent[t ^ mask][i]
    return w


def test_epilogue_quad_transpose_gives_each_lane_a_chunk():
    """Pass 2's stores: lane t of a quad holds, of chunks j = 4 q .. 4 q + 3,
    the column pair 8 j + 2 t (the wgmma fragment, one bf16x2 word each);
    after the transpose it holds the four words of chunk 4 q + t in column
    order, 16 bytes at column 8 (4 q + t)."""
    for q in range(4):
        frag = [[(8 * (4 * q + k) + 2 * t) for k in range(4)] for t in range(4)]
        got = quad_transpose(frag)
        assert got == [[8 * (4 * q + t) + 2 * p for p in range(4)] for t in range(4)]


def partial16_tile(n: int, pixels: int, sms: int = SMS) -> int:
    """convt_bwd.cu's partial16_tile."""
    tile = 2048
    while tile > 256 and n * -(-pixels // tile) < 2 * sms:
        tile //= 2
    return tile


def in_bwd_means(g: torch.Tensor, yhat: torch.Tensor) -> torch.Tensor:
    """The means (N, 2, Co) fp32 of convt_partial16_kernel's partials and
    convt_means16_kernel's merge, in their order."""
    n, hh, ww, co = g.shape
    pixels = hh * ww
    tile = partial16_tile(n, pixels)
    cpp, lanes = co // 8, 256 // (co // 8)
    gh = torch.where(yhat > 0, g, 0.0).reshape(n, pixels, co)
    y = yhat.reshape(n, pixels, co)
    parts = []
    for t0 in range(0, pixels, tile):
        cnt = min(tile, pixels - t0)
        s1 = torch.zeros((n, lanes, co), dtype=torch.float32)
        s2 = torch.zeros_like(s1)
        for q0 in range(0, cnt, lanes):  # lane l's pixels l, l + lanes, ... in order
            m = min(lanes, cnt - q0)
            a, yy = gh[:, t0 + q0:t0 + q0 + m], y[:, t0 + q0:t0 + q0 + m]
            s1[:, :m] = s1[:, :m] + a.float()
            s2[:, :m] = (a * yy + s2[:, :m].double()).float()  # fmaf: one rounding
        p1, p2 = torch.zeros((n, co)), torch.zeros((n, co))
        for lane in range(lanes):
            p1, p2 = p1 + s1[:, lane], p2 + s2[:, lane]
        parts.append((p1, p2))
    red = torch.zeros((2, GROUPS, n, co), dtype=torch.float64)
    for e, (p1, p2) in enumerate(parts):
        red[0, e % GROUPS] += p1.double()
        red[1, e % GROUPS] += p2.double()
    return torch.stack([group_sum(red[0]), group_sum(red[1])], 1).div(pixels).float()


def wgrad_emulated(x: torch.Tensor, dz: torch.Tensor, fold: bool = False) -> torch.Tensor:
    """ConvtWgradOp16 and the split sum: per tap, x shifted by (dy, dx)
    (zeros off the frame) against the tap's parity plane of dz, over each
    split's K slices of 64 pixels, the splits added in order; fp32. With
    ``fold`` (Co <= 64) a tile is (ky, dx) against both column parities of
    the row parity side by side: taps (ky, 2) | (ky, 1) at dx = 0, (ky, 0)
    and no tap's columns at dx = -1."""
    n, h, wd, ci = x.shape
    co = dz.shape[3]
    total = n * h * wd
    splits, per = wgrad_splits(total, ci, co, BK16)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0))  # row / column -1 zeros
    pad = torch.nn.functional.pad
    dw = torch.zeros((3, 3, ci, co), dtype=torch.float32)

    def gemm(src, plane):
        acc = torch.zeros((ci, plane.shape[1]), dtype=torch.float32)
        for s0 in range(0, total, per):
            sl = range(s0, min(total, s0 + per), BK16)
            # a short last slice: zeros past it
            a_sl = [pad(src[k:k + BK16].T, (0, BK16 - src[k:k + BK16].shape[0])) for k in sl]
            b_sl = [pad(plane[k:k + BK16], (0, 0, 0, BK16 - plane[k:k + BK16].shape[0]))
                    for k in sl]
            acc = acc + slice_sum(a_sl, b_sl)
        return acc

    for ky, dy in ((2, 0), (0, -1), (1, 0)):
        py = int(ky == 1)
        planes = [dz[:, py::2, px::2].reshape(total, co) for px in (0, 1)]
        taps = ([(0, [(2, 0), (1, 1)]), (-1, [(0, 0)])] if fold else
                [(dx, [(kx, int(kx == 1))]) for kx, dx in ((2, 0), (1, 0), (0, -1))])
        for dx, kxs in taps:
            src = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd].reshape(total, ci)
            acc = gemm(src, torch.cat(planes, 1) if fold else planes[kxs[0][1]])
            for kx, px in kxs:
                dw[ky, kx] = acc[:, px * co:(px + 1) * co] if fold else acc
    return dw


def dgrad_emulated(dz: torch.Tensor, w: torch.Tensor, h: int, wd: int) -> torch.Tensor:
    """ConvtDgradOp16: dx = sum over the 9 taps and 64-channel slices of dz at
    (2i + 2 - ky, 2j + 2 - kx) (zeros past the output's edge) . W[ky, kx]^T,
    the slices tap-major, each a chain; fp32."""
    n, _, _, co = dz.shape
    ci = w.shape[2]
    dzp = torch.nn.functional.pad(dz, (0, 0, 0, 2, 0, 2))
    a_sl, b_sl = [], []
    for ky in range(3):
        for kx in range(3):
            src = dzp[:, 2 - ky::2, 2 - kx::2][:, :h, :wd].reshape(-1, co)
            for c0 in range(0, co, BK16):
                a_sl.append(src[:, c0:c0 + BK16])
                b_sl.append(w[ky, kx, :, c0:c0 + BK16].T)
    return slice_sum(a_sl, b_sl).reshape(n, h, wd, ci)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_schedule_is_fp32_accurate(case):
    """The backward from the emulated forward's saved bf16 yhat and fp32
    statistics: the means (the new partial order) and dz within 2e-6 of
    float64 from the same values; dx and dW from the bf16 dz within 2e-6
    of the float64 products of the same dz; dx and dW in bf16 within one
    bf16 spacing of the largest value of the plain version's at bf16
    (float64 work); and within 2^-7 of the largest value of the JAX
    package's VJP in float64 (which recomputes yhat and dz unrounded; the
    kernel takes both in bf16, 2^-9 relative each)."""
    x, w, g = inputs(*case)
    n, h, wd, _ = x.shape
    em = emulated_forward(case)
    yhat, stats = em["yhat"].double(), em["stats"]
    means = in_bwd_means(g, yhat)
    gh = torch.where(yhat > 0, g, 0.0)
    want = torch.stack([gh.mean((1, 2)), (gh * yhat).mean((1, 2))], 1)
    assert core.rel_err(means, want) < TOL
    rs = stats[:, 1, None, None].float()
    dz32 = rs * (gh.float() - means[:, 0, None, None] - yhat.float() * means[:, 1, None, None])
    dz64 = stats[:, 1, None, None].double() * (gh - want[:, 0, None, None]
                                               - yhat * want[:, 1, None, None])
    assert core.rel_err(dz32, dz64) < TOL
    dz = dz32.to(torch.bfloat16).double()
    dw32 = wgrad_emulated(x, dz, fold=w.shape[3] <= 64)
    if w.shape[3] <= 64:  # the folded tiles' columns are the taps' own, bit for bit
        assert torch.equal(dw32, wgrad_emulated(x, dz))
    dx32 = dgrad_emulated(dz, w, h, wd)
    # the float64 products of the same bf16 dz
    xp = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0))
    dw_ref = torch.zeros_like(w)
    for py in (0, 1):
        for px in (0, 1):
            plane = dz[:, py::2, px::2].reshape(-1, dz.shape[3])
            for ky, dy in AX[py]:
                for kx, dx in AX[px]:
                    dw_ref[ky, kx] = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd].reshape(
                        -1, x.shape[3]).T @ plane
    dzp = torch.nn.functional.pad(dz, (0, 0, 0, 2, 0, 2))
    dx_ref = sum(dzp[:, 2 - ky::2, 2 - kx::2][:, :h, :wd] @ w[ky, kx].T
                 for ky in range(3) for kx in range(3))
    assert core.rel_err(dw32, dw_ref) < TOL
    assert core.rel_err(dx32, dx_ref) < TOL
    bf = torch.bfloat16
    dx_plain, dw_plain = convt_in_bwd_plain(x.to(bf), w.to(bf), g.to(bf),
                                            saved=(em["yhat"], stats), work=torch.float64)
    for got, ref in ((dx32, dx_plain), (dw32, dw_plain)):
        assert bf16_ulps(got.to(bf), ref, at_scale=True) <= 1.0
    _, jdx, jdw = jax_reference(case)
    assert core.rel_err(dx32, jdx) < 2.0**-7
    assert core.rel_err(dw32, jdw) < 2.0**-7
