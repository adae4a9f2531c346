// K-convt: one stage of the ResNet generator's decoder,
//
//   out = relu(IN(convT(x, W))),   convT = flax ConvTranspose(3x3, stride 2, 'SAME'),
//
// with instance norm per (n, c) over the 2H x 2W output (biased variance,
// eps), no affine and no conv bias (a bias is inert through IN).
//
// Replaces the TPU kernel nemar_tpu/ops/attic/convt_fused.py:_fwd_kernel
// (B5, --block_impl pallas_all), reached through fused_convt_in.
//
// The transposed convolution is computed without the zeros a dilated input
// would carry, as four parity planes (the TPU kernel's decomposition): the
// contribution of x[i, j] * W[ky, kx] lands at out[2i + 2 - ky, 2j + 2 - kx],
// so output pixel (2i + py, 2j + px) draws, per axis, the taps
// {ky = 2 at input row i, ky = 0 at row i - 1} for parity 0 and {ky = 1 at
// row i} for parity 1 (_AX of the TPU kernel). Each plane is an implicit
// GEMM over the plane's H*W pixels: M = H*W per sample, N = Co, K = (1, 2,
// 2 or 4 taps) x Ci.
//
// What bounds it on the H100: arithmetic. At each of the generator's two
// stages (64^2 x 256 -> 128^2 x 128 and 128^2 x 128 -> 256^2 x 64) it is
// 2 * H*W * 9 * Ci * Co = 2.42 GFLOP per image: 36 us at the 67 TFLOP/s
// fp32 FMA peak, 15 us in 3xTF32 at the tensor cores' 495 TFLOP/s, against
// 8-17 MB of activations. The GEMMs run on the wgmma core of gemm_tc.cuh in
// 3xTF32 (each fp32 product three TF32 MMAs, chained over one 32-deep K
// slice and added to an fp32 total: fp32-level accuracy), a tile being 128
// pixels of one plane of one sample by 128 output channels, or 64 where
// Co <= 64 or 128-wide tiles would leave SMs idle. A K slice is one tap and
// 32 input channels; rows off the frame (tap offset -1 at i or j = 0), past
// the plane and channels past Ci are zero-filled by cp.async, so any
// Ci, Co % 4 == 0 runs. The 4-tap plane costs 4x the 1-tap plane, so its
// tiles are launched first. Four launches, counted as one call:
//
//   1. split: W -> (big, small) of W^T per tap (tap, Co, Ci), a tiled
//      transpose, so that B(k = (tap, ci), n = co) is K-major as wgmma
//      reads it;
//   2. the four planes' GEMMs. The epilogue writes y to its interleaved
//      place (N, 2H, 2W, Co) and, per channel, the tile's mean and sum of
//      squared deviations over its valid pixels (gemm_tc.cuh: tile_stats);
//   3. a block per (n, 32 channels) merges the 4 planes' tiles in a fixed
//      order in fp64 (Chan's formula, weighted by each tile's pixel count)
//      into (mu, rstd);
//   4. yhat = (y - mu) * rstd in place, and out = relu(yhat).
//
// yhat and (mu, rstd) are kept for K-convt-bwd, as the TPU kernel keeps its
// normalised planes and statistics. Deterministic: no atomics.
//
// Layouts: x (N, H, W, Ci); W (3, 3, Ci, Co) HWIO, flax ConvTranspose's
// kernel; wsplit (2, 9, Co, Ci) = (W^T big, W^T small); yhat, out (N, 2H,
// 2W, Co); stats (N, 2, Co) = (mu, rstd); part (N * 4 * tiles, 2, Co),
// tiles = ceil(H*W / 128). All fp32. Requirements (checked by the wrapper):
// Ci % 4 == 0, Co % 4 == 0, 16-byte aligned pointers.
//
// The bf16 variant (--bf16; nemar_convt_in_fwd_bf16) takes x and W in bf16
// and runs the planes' GEMMs on the bf16 core (gemm_tc.cuh: one bf16 MMA a
// product, fp32 accumulators, K slices of one tap and 64 channels;
// warp-specialised and persistent, x and W as TMA boxes, W as it lies
// (N-major) and x where a tile's pixels are image rows, the frame's zeros
// the boxes' out-of-bounds fill; the tiles' walk snakes so that the 1- to
// 4-tap planes even out). 2.42 GFLOP per image and stage is 2.4 us at 989
// TFLOP/s, but the tiles are short (4-16 slices) and the core reaches
// 200-330 TFLOP/s on them, and an fp32 y of its own would be written and
// read back (134 MB each way at 8 x 256^2 x 64, 0.08 ms at 3.35 TB/s,
// against the 168 MB of x, yhat and out). So no y reaches memory; three
// launches:
//
//   1. pass 1, the GEMMs with an epilogue of the tile statistics alone;
//   2. the merge (convt_stats16_kernel: the sums of 3 over more threads,
//      8 channels a block);
//   3. pass 2, the same tiles in the same slice order again (its totals are
//      pass 1's bit for bit, so the statistics are those of the y it
//      normalises), its epilogue writing yhat = (acc - mu) * rstd and
//      relu(yhat) rounded to bf16 from the fp32 totals, 16 bytes a lane.
//
// Twice the MMAs for a third of the bytes to memory. At Co <=
// 64 a 64-wide tile would read each A box for 64 columns and leave its
// epilogue exposed after 2-8 slices, so a tile takes both column parities
// of a row parity (128 columns, 64 px + c): half as many tiles, A read
// once for both. Its K slices are (row tap, dx = 0 then -1, 64 channels)
// against [W(ky, 2) | W(ky, 1)] and [W(ky, 0) | 0], each column summing
// its slices in the unfolded plane's order. The zeros cost a third more
// MMAs in the py = 0 tiles, and no time (m64n64k16 on the dx = -1 slices,
// skipping them, ran slower: ptxas serialises the wgmma's around the
// branch between the two widths). Above 64 channels the tiles are 128
// columns wide even at batch 1. The statistics stay fp32. A 16-byte copy
// holds 8 bf16 channels: it takes Ci % 8 == 0, Co % 8 == 0 (the wrapper
// pads to them).
#include <cuda_runtime.h>

#include "band.cuh"
#include "gemm_tc.cuh"

namespace {

using tc::BK;
using tc::BM;
using tc::CHUNKS;
using tc::cp_async16;

// Per axis, the taps of an output parity: (kernel index, input offset).
__device__ __forceinline__ void parity_tap(int parity, int t, int& k, int& d) {
  if (parity == 1) {
    k = 1;
    d = 0;
  } else {
    k = t == 0 ? 2 : 0;
    d = t == 0 ? 0 : -1;
  }
}

// y[b, 2i + py, 2j + px, co] = sum over the plane's taps and ci of
// x[b, i + dy, j + dx, ci] * W[ky, kx, ci, co] (0 off the frame); the
// tile's per-column (mean, M2) to part. kHp (the band form): x holds each
// sample's H + 1 rows, the halo row above the band first, so row i + dy of
// the band is x's row i + dy + 1, never off the frame.
template <int kTN, bool kHp = false>
struct ConvtFwdOp {
  static constexpr bool kNormRelu = false;
  static constexpr bool kTileStats = true;
  static constexpr int kTileN = kTN;  // output channels per tile: 128 or 64
  const float* x;
  // W^T (tap, co, ci), split: B(k = (tap, ci), n = co) is K-major as it lies
  const float* wbig;
  const float* wsmall;
  float* y;
  float* part;
  int n, h, w, ci, co, tiles, cotiles;
  static constexpr int hp = kHp ? 1 : 0;
  // per thread: the tile, and for its A rows i << 16 | j (-1 past the plane)
  int b, plane, py, px, tile, m0, n0, kc, spt, ntx, rows;
  int rij[CHUNKS];

  __device__ void setup(int tid) {
    // block (plane, b, tile, column tile), plane-major: the 4-tap plane first
    int bid = blockIdx.x;
    const int cot = bid % cotiles;
    bid /= cotiles;
    tile = bid % tiles;
    bid /= tiles;
    b = bid % n;
    plane = bid / n;
    py = plane >> 1;
    px = plane & 1;
    m0 = tile * BM;
    n0 = cot * kTN;
    kc = tc::kmajor_k(tid);
    const int hw = h * w;
    rows = min(BM, hw - m0);
    spt = (ci + BK - 1) / BK;
    ntx = px == 0 ? 2 : 1;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int p = m0 + tc::kmajor_row(tid, i);
      const int u = p / w;
      rij[i] = p < hw ? (u << 16) | (p - u * w) : -1;
    }
  }
  __device__ int ktiles() const { return (py == 0 ? 2 : 1) * ntx * spt; }
  __device__ void load(int kt, float* As, float* Bb, float* Bs, int tid) const {
    const int t = kt / spt;
    const int c = (kt - t * spt) * BK + kc;
    int ky, dy, kx, dx;
    parity_tap(py, t / ntx, ky, dy);
    parity_tap(px, t - (t / ntx) * ntx, kx, dx);
    const bool cin = c < ci;
    const float* xb = x + (size_t)b * (h + hp) * w * ci;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int ii = (rij[i] >> 16) + dy + hp, jj = (rij[i] & 0xffff) + dx;
      const bool valid = cin && rij[i] >= 0 && ii >= 0 && jj >= 0;
      cp_async16(tc::kmajor_at(As, tc::kmajor_row(tid, i), kc),
                 valid ? xb + ((size_t)ii * w + jj) * ci + c : x, valid);
    }
    const size_t wrow = (size_t)(ky * 3 + kx) * co + n0;
#pragma unroll
    for (int i = 0; i < kTN * BK / 4 / tc::THREADS; ++i) {
      const int nr = tc::kmajor_row(tid, i);
      const bool valid = cin && n0 + nr < co;
      const size_t off = (wrow + nr) * ci + c;
      const int dst = tc::swizzled_off(nr, kc / 4);
      cp_async16(Bb + dst, valid ? wbig + off : wbig, valid);
      cp_async16(Bs + dst, valid ? wsmall + off : wsmall, valid);
    }
  }
  template <class V>
  __device__ void write(int r, int col, V val) const {
    if (r >= rows || n0 + col >= co) return;
    const int p = m0 + r, i = p / w, j = p - i * w;
    *reinterpret_cast<V*>(y + (((size_t)b * 2 * h + 2 * i + py) * 2 * w + 2 * j + px) * co + n0 +
                          col) = val;
  }
  __device__ int rows_in_tile() const { return rows; }
  __device__ void write_stats(int col, float mean, float m2) const {
    if (n0 + col >= co) return;
    float* p = part + ((size_t)((b * 4 + plane) * tiles + tile) * 2) * co + n0 + col;
    p[0] = mean;
    p[co] = m2;
  }
};

// 1: wsplit[s][tap][co][ci] = big (s = 0) / small (s = 1) part of
// w[tap][ci][co], through a 32 x 32 tile in shared memory (reads and writes
// coalesced), masked at the edges of Ci and Co
__global__ void split_transpose_kernel(const float* __restrict__ w, float* __restrict__ wsplit,
                                       int ci, int co) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z;
  const float* src = w + (size_t)tap * ci * co;
  const int ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8)
    if (ci0 + r < ci && co0 + tx < co) tile[r][tx] = src[(size_t)(ci0 + r) * co + co0 + tx];
  __syncthreads();
  float* big = wsplit + (size_t)tap * co * ci;
  float* small = big + (size_t)9 * co * ci;
  for (int r = ty; r < 32; r += 8) {
    if (co0 + r >= co || ci0 + tx >= ci) continue;
    uint32_t bg, sm;
    tc::split_tf32(tile[tx][r], bg, sm);
    const size_t o = (size_t)(co0 + r) * ci + ci0 + tx;
    big[o] = __uint_as_float(bg);
    small[o] = __uint_as_float(sm);
  }
}

// 3: (mu, rstd) per (n, c) from the 4 planes' tile partials, in fp64: mean =
// sum_t c_t m_t / P, M2 = sum_t (M2_t + c_t (m_t - mean)^2). A block owns
// one sample and 32 channels (a lane each); warp k takes the partials
// t = k, k + 32, ..., and warp 0 adds the 32 warps' sums in warp order, so
// the order of every sum is fixed.
constexpr int ST_LANES = 32, ST_WARPS = 32;

//
// The band form (--mesh_spatial) merges every rank's partials, bp.ranks
// blocks of N * 4 * tiles partials `rank_stride` floats apart: warp k then
// takes the entries t = k, k + 32, ... of the ranks' partials in rank order,
// each tile's count its rank's (bp: each rank's input pixels H * W;
// tiles the largest band's, a smaller band's partials zero past its own).
__global__ void __launch_bounds__(ST_LANES * ST_WARPS)
convt_stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int c, int tiles,
                   float eps, BandPixels bp, long long rank_stride) {
  __shared__ double red[ST_WARPS][ST_LANES];
  __shared__ double mean_s[ST_LANES];
  const int lane = threadIdx.x % ST_LANES, warp = threadIdx.x / ST_LANES;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * ST_LANES + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * 4 * tiles * 2 * c + ch;
  const int per_sample = 4 * tiles;
  const int entries = bp.ranks * per_sample;
  const double pixels = 4.0 * band_total(bp);
  // entry e: partial t = e % per_sample of rank e / per_sample
  auto at = [&](int e) {
    return p + (size_t)(e / per_sample) * rank_stride + (size_t)(e % per_sample) * 2 * c;
  };
  double s = 0.0;
  for (int e = warp; live && e < entries; e += ST_WARPS)
    s += (double)tile_count(bp, e / per_sample, e % per_sample % tiles, BM) * (double)at(e)[0];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    double m = 0.0;
    for (int k = 0; k < ST_WARPS; ++k) m += red[k][lane];
    mean_s[lane] = m / pixels;
  }
  __syncthreads();
  const double mean = mean_s[lane];
  double m2 = 0.0;
  for (int e = warp; live && e < entries; e += ST_WARPS) {
    const double d = (double)at(e)[0] - mean;
    m2 += (double)at(e)[c] +
          (double)tile_count(bp, e / per_sample, e % per_sample % tiles, BM) * d * d;
  }
  red[warp][lane] = m2;
  __syncthreads();
  if (warp == 0 && live) {
    double q = 0.0;
    for (int k = 0; k < ST_WARPS; ++k) q += red[k][lane];
    float* st = stats + (size_t)b * 2 * c + ch;
    st[0] = (float)mean;
    st[c] = (float)(1.0 / sqrt(q / pixels + (double)eps));
  }
}

// 4: yhat = (y - mu) * rstd, out = relu(yhat), float4-wide, both stored as
// T: in place of y (fp32: yhat is y), or rounded to bf16 beside it (the
// bf16 variant's fp32 y)
template <class T>
__global__ void convt_apply_kernel(const float4* y, const float* __restrict__ stats, T* yhat,
                                   T* __restrict__ out, long long total4, long long per_sample,
                                   int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const int b = (int)(e / per_sample);
  const float* mu = stats + (size_t)b * 2 * c + ch;
  const float* rs = mu + c;
  const float4 v = y[i];
  const float4 yh = make_float4((v.x - mu[0]) * rs[0], (v.y - mu[1]) * rs[1],
                                (v.z - mu[2]) * rs[2], (v.w - mu[3]) * rs[3]);
  tc::store4(yhat + e, yh);
  tc::store4(out + e, make_float4(fmaxf(yh.x, 0.f), fmaxf(yh.y, 0.f), fmaxf(yh.z, 0.f),
                                  fmaxf(yh.w, 0.f)));
}

// 2
template <int kTN, bool kHp = false>
cudaError_t planes(const float* x, const float* wsplit, float* y, float* part, int n, int h, int w,
                   int ci, int co, int tiles, cudaStream_t stream) {
  ConvtFwdOp<kTN, kHp> op;
  op.x = x;
  op.wbig = wsplit;
  op.wsmall = wsplit + (size_t)9 * co * ci;
  op.y = y;
  op.part = part;
  op.n = n;
  op.h = h;
  op.w = w;
  op.ci = ci;
  op.co = co;
  op.tiles = tiles;
  op.cotiles = (co + kTN - 1) / kTN;
  return tc::launch_wgmma(op, dim3((unsigned)(4 * n * tiles * op.cotiles)), stream);
}

// ---------------------------------------------------------------------------
// bf16 variant (nemar_convt_in_fwd_bf16)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// ConvtFwdOp with bf16 x and W, K slices of one tap and 64 channels. Its
// epilogue by kPass: kStoreY writes y fp32 (the interleaved output before
// IN) and the tile statistics as there (the band form); kStats the tile
// statistics alone (the first pass); kNorm yhat = (acc - mu) * rstd and
// out = relu(yhat) in bf16 from the fp32 totals, given the statistics (the
// second pass, whose tiles are the first pass's, computed alike, so its
// totals are the first pass's bit for bit). kFold (Co <= 64): a tile takes
// both column parities px of an output row parity py, its columns
// n = 64 px + c (c < Co; the two pixels 2j, 2j + 1 of a row lie side by
// side in the output), and its K slices a row tap, a column offset dx (0,
// then -1) and 64 channels, against B = [W(ky, 2) | W(ky, 1)] at dx = 0 and
// [W(ky, 0) | 0] at dx = -1: each column's slices come in the unfolded
// plane's order, the zeros adding exact zeros to the px = 1 columns. kHp
// as there (the band form: x holds each sample's H + 1 rows). B is W as it
// lies, N-major (kMNB: Co innermost), in TMA boxes of 64 Co x 64 Ci of one
// tap (W as (9, Ci, Co); zeros past Ci and Co, and a box at tap 9, past
// the taps, for the folded zeros): no transpose of W. A is a box (tma_a:
// the tile's 128 pixels image rows, W dividing 128 or 128 dividing W) of x
// at the slice's offset, the frame's zeros (a -1 offset at row or column
// 0) and Ci's its out-of-bounds fill, or else the producer's cp.async
// copies, masked in the index.
enum ConvtPass { kStoreY, kStats, kNorm };

template <int kTN, int kPass, bool kFold = false, bool kHp = false>
struct ConvtFwdOp16 : tc::Bf16Loads {
  static constexpr bool kMN = false;
  static constexpr bool kMNB = true;
  static constexpr bool kTileStats = kPass != kNorm;
  static constexpr bool kTileEpilogue = kPass == kNorm;
  static constexpr int kTileN = kTN;
  static constexpr int kPlanes = kFold ? 2 : 4;  // a tile's plane: py (kFold) or (py, px)
  static_assert(!kFold || kTN == 128, "a folded tile holds both parities' columns");
  static_assert(!kFold || kPass != kStoreY, "y stored by the unfolded band form alone");
  const bf16* x;
  float* y;
  float* part;
  const float* stats;
  bf16* yhat;
  bf16* out;
  int n, h, w, ci, co, tiles, cotiles;
  int b, plane, py, px, tile, m0, n0, kc, spt, ntx, rows;
  int rij[tc::PCHUNKS];

  __device__ void setup(int ptid, uint3 blk) {
    int bid = blk.x;
    const int cot = bid % cotiles;
    bid /= cotiles;
    tile = bid % tiles;
    bid /= tiles;
    b = bid % n;
    plane = bid / n;
    py = kFold ? plane : plane >> 1;
    px = kFold ? 0 : plane & 1;
    m0 = tile * BM;
    n0 = cot * kTN;
    kc = ptid & 7;
    const int hw = h * w;
    rows = min(BM, hw - m0);
    spt = (ci + tc::BK16 - 1) / tc::BK16;
    ntx = px == 0 ? 2 : 1;
    if (tma_a) return;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int p = m0 + tc::prow(ptid, i);
      const int u = p / w;
      rij[i] = p < hw ? (u << 16) | (p - u * w) : -1;
    }
  }
  // the K slice's row tap ky, column tap kx (kFold: of px = 0; tx the dx
  // slice, 0 or 1), its offsets (dy, dx) and first channel c
  __device__ void slice(int kt, int& ky, int& kx, int& tx, int& dy, int& dx, int& c) const {
    const int t = kt / spt;
    c = (kt - t * spt) * tc::BK16;
    tx = t - (t / ntx) * ntx;
    parity_tap(py, t / ntx, ky, dy);
    parity_tap(px, tx, kx, dx);
  }
  __device__ int ktiles() const { return (py == 0 ? 2 : 1) * ntx * spt; }
  // A by cp.async (tma_a false)
  __device__ void load(int kt, unsigned char* As, unsigned char*, int ptid) const {
    int ky, kx, tx, dy, dx, c;
    slice(kt, ky, kx, tx, dy, dx, c);
    c += 8 * kc;
    const bool cin = c < ci;
    constexpr int hp = kHp ? 1 : 0;
    const bf16* xb = x + (size_t)b * (h + hp) * w * ci;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int ii = (rij[i] >> 16) + dy + hp, jj = (rij[i] & 0xffff) + dx;
      const bool valid = cin && rij[i] >= 0 && ii >= 0 && jj >= 0;
      tc::cp_async16b(As + tc::swz16(tc::prow(ptid, i), kc),
                      valid ? xb + ((size_t)ii * w + jj) * ci + c : x, valid);
    }
  }
  // B (maps.b: W as (9, Ci, Co)); with tma_a, A (maps.a: x as (N, H (+ 1),
  // W, Ci)) at pixel (u0 + dy, v0 + dx)
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    int ky, kx, tx, dy, dx, c;
    slice(kt, ky, kx, tx, dy, dx, c);
    if (tma_a) {
      const int u0 = m0 / w;
      tc::tma_load(As, &maps.a, bar, c, m0 - u0 * w + dx, u0 + dy + (kHp ? 1 : 0), b);
    }
    // B: a box of 64 columns each at Bs + 8192 j (the N-major atoms); kFold:
    // px = j's tap, (ky, 1) at dx = 0 and none (tap 9, past the taps: zeros)
    // at dx = -1
#pragma unroll
    for (int j = 0; j < kTN / 64; ++j) {
      const int tap = kFold && j == 1 ? (tx == 0 ? ky * 3 + 1 : 9) : ky * 3 + kx;
      tc::tma_load(Bs + 8192 * j, &maps.b, bar, kFold ? 0 : n0 + 64 * j, c, tap);
    }
  }
  // tile column nn's parity (kFold) and channel; whether it is an output's
  __device__ int col_px(int nn) const { return kFold ? nn >> 6 : px; }
  __device__ int col_ch(int nn) const { return kFold ? nn & 63 : nn; }
  __device__ bool col_live(int nn) const { return col_ch(nn) < co; }
  // the element of tile row r (the row's first parity px's pixel) in the
  // (N, 2H, 2W, Co) output, and tile column nn's offset from it
  __device__ size_t at(int r) const {
    const int p = m0 + r, i = p / w, j = p - i * w;
    return (((size_t)b * 2 * h + 2 * i + py) * 2 * w + 2 * j + px) * co;
  }
  __device__ int col_at(int nn) const { return kFold ? (nn >> 6) * co + (nn & 63) : nn; }
  __device__ void write(int r, int col, float2 val) const {
    if constexpr (kPass == kStoreY) {
      if (r < rows && col_live(n0 + col)) tc::store2(y + at(r) + col_at(n0 + col), val);
    }
  }
  // kNorm: yhat = (acc - mu) * rstd and relu(yhat), rounded to bf16, a row's
  // 8-column chunks 16 bytes a lane (tc::quad_transpose), so that a warp's
  // store covers whole 32-byte sectors (the fragment's own 4-byte column
  // pairs would write half sectors)
  __device__ void tile_epilogue(const float (&acc)[kTN / 2], int row0, int g, int t) const {
    const float* st = stats + (size_t)b * 2 * co;
    const int r0 = row0 + g, r1 = r0 + 8;
    const size_t base0 = r0 < rows ? at(r0) : 0, base1 = r1 < rows ? at(r1) : 0;
#pragma unroll
    for (int q = 0; q < kTN / 32; ++q) {
      uint32_t y0[4], o0[4], y1[4], o1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // columns nn, nn + 1: one parity's (nn even, Co % 8 == 0)
        const int j = 4 * q + k, nn = n0 + 8 * j + 2 * t, c = col_ch(nn);
        float2 mu = make_float2(0.f, 0.f), rs = mu;
        if (c < co) {
          mu = *reinterpret_cast<const float2*>(st + c);
          rs = *reinterpret_cast<const float2*>(st + co + c);
        }
        const float a0 = (acc[4 * j] - mu.x) * rs.x, b0 = (acc[4 * j + 1] - mu.y) * rs.y;
        const float a1 = (acc[4 * j + 2] - mu.x) * rs.x, b1 = (acc[4 * j + 3] - mu.y) * rs.y;
        y0[k] = tc::pack_bf16x2(a0, b0);
        o0[k] = tc::pack_bf16x2(fmaxf(a0, 0.f), fmaxf(b0, 0.f));
        y1[k] = tc::pack_bf16x2(a1, b1);
        o1[k] = tc::pack_bf16x2(fmaxf(a1, 0.f), fmaxf(b1, 0.f));
      }
      tc::quad_transpose(y0, t);
      tc::quad_transpose(o0, t);
      tc::quad_transpose(y1, t);
      tc::quad_transpose(o1, t);
      // this lane's chunk of the row: 8 columns of one parity
      const int nn = n0 + 8 * (4 * q + t);
      if (col_live(nn)) {
        const int off = col_at(nn);
        if (r0 < rows) {
          *reinterpret_cast<uint4*>(yhat + base0 + off) = make_uint4(y0[0], y0[1], y0[2], y0[3]);
          *reinterpret_cast<uint4*>(out + base0 + off) = make_uint4(o0[0], o0[1], o0[2], o0[3]);
        }
        if (r1 < rows) {
          *reinterpret_cast<uint4*>(yhat + base1 + off) = make_uint4(y1[0], y1[1], y1[2], y1[3]);
          *reinterpret_cast<uint4*>(out + base1 + off) = make_uint4(o1[0], o1[1], o1[2], o1[3]);
        }
      }
    }
  }
  __device__ int rows_in_tile() const { return rows; }
  // the column's plane (py, px) and channel
  __device__ void write_stats(int col, float mean, float m2) const {
    const int nn = n0 + col;
    if (!col_live(nn)) return;
    float* p = part + ((size_t)((b * 4 + py * 2 + col_px(nn)) * tiles + tile) * 2) * co +
               col_ch(nn);
    p[0] = mean;
    p[co] = m2;
  }
};

// 3 (one frame): the bf16 forward's (mu, rstd) from the 4 planes' tile
// partials, the sums of convt_stats_kernel (fp64; the mean, then the sum
// of squared deviations about it), spread wider: a block per (sample, 8
// channels), 128 groups of 8 threads, group k the partials k, k + 128, ...,
// the groups added by a fixed pairwise tree (tc::group_sum). A block per
// 32 channels, each thread chaining 16 partials, took 15 us at 128 tiles a
// plane.
constexpr int ST16_CH = 8, ST16_GROUPS = 128;

__global__ void __launch_bounds__(ST16_CH * ST16_GROUPS)
convt_stats16_kernel(const float* __restrict__ part, float* __restrict__ stats, int c, int tiles,
                     int hw, float eps) {
  __shared__ double red[ST16_GROUPS][ST16_CH];
  const int lane = threadIdx.x % ST16_CH, grp = threadIdx.x / ST16_CH;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * ST16_CH + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * 4 * tiles * 2 * c + ch;
  const int entries = 4 * tiles;
  const double pixels = 4.0 * hw, last = (double)(hw - (tiles - 1) * BM);
  // the pixels of partial e: BM, but the last tile of a plane
  auto count = [&](int e) { return e % tiles == tiles - 1 ? last : (double)BM; };
  double s = 0.0;
#pragma unroll 4
  for (int e = grp; live && e < entries; e += ST16_GROUPS)
    s += count(e) * (double)p[(size_t)e * 2 * c];
  const double mean = tc::group_sum(red, s, grp, lane) / pixels;
  double m2 = 0.0;
#pragma unroll 4
  for (int e = grp; live && e < entries; e += ST16_GROUPS) {
    const double d = (double)p[(size_t)e * 2 * c] - mean;
    m2 += (double)p[(size_t)e * 2 * c + c] + count(e) * d * d;
  }
  const double q = tc::group_sum(red, m2, grp, lane);
  if (grp == 0 && live) {
    float* st = stats + (size_t)b * 2 * c + ch;
    st[0] = (float)mean;
    st[c] = (float)(1.0 / sqrt(q / pixels + (double)eps));
  }
}

// The tensor maps of ConvtFwdOp16<.., kHp>'s boxes, and whether A is boxes
template <bool kHp>
cudaError_t fwd16_maps(const bf16* x, const bf16* wk, int n, int h, int w, int ci, int co,
                       bool& tma_a, tc::TmaMaps& maps) {
  tma_a = w % BM == 0 || BM % w == 0;
  const long long wdims[3] = {co, ci, 9};
  const int wbox[3] = {64, tc::BK16, 1};
  cudaError_t err = tc::bf16_map(&maps.b, wk, 3, wdims, wbox);
  if (err == cudaSuccess && tma_a) {
    const int bw = min(w, BM);
    err = tc::image_map(&maps.a, x, n, h + (kHp ? 1 : 0), w, ci, bw, BM / bw);
  }
  return err;
}

// 2 (and 4): one pass of the planes' GEMMs
template <int kTN, int kPass, bool kFold = false, bool kHp = false>
cudaError_t planes16(const bf16* x, const bf16* wk, float* y, float* part, const float* stats,
                     bf16* yhat, bf16* out, int n, int h, int w, int ci, int co, int tiles,
                     cudaStream_t stream) {
  ConvtFwdOp16<kTN, kPass, kFold, kHp> op;
  op.x = x;
  op.y = y;
  op.part = part;
  op.stats = stats;
  op.yhat = yhat;
  op.out = out;
  op.n = n;
  op.h = h;
  op.w = w;
  op.ci = ci;
  op.co = co;
  op.tiles = tiles;
  op.cotiles = kFold ? 1 : (co + kTN - 1) / kTN;
  op.tma_b = true;
  tc::TmaMaps maps{};
  const cudaError_t err = fwd16_maps<kHp>(x, wk, n, h, w, ci, co, op.tma_a, maps);
  if (err != cudaSuccess) return err;
  return tc::launch_bf16(op, dim3((unsigned)(op.kPlanes * n * tiles * op.cotiles)), stream, maps);
}

// the bf16 forward's two passes around the merge: kFold, or the unfolded
// tiles kTN wide
template <int kTN, bool kFold>
cudaError_t two_pass16(const bf16* x, const bf16* wk, float* part, float* stats, bf16* yhat,
                       bf16* out, int n, int h, int w, int ci, int co, int tiles, float eps,
                       cudaStream_t stream) {
  cudaError_t err = planes16<kTN, kStats, kFold>(x, wk, nullptr, part, nullptr, nullptr, nullptr,
                                                 n, h, w, ci, co, tiles, stream);
  if (err != cudaSuccess) return err;
  convt_stats16_kernel<<<dim3((unsigned)((co + ST16_CH - 1) / ST16_CH), (unsigned)n),
                         ST16_CH * ST16_GROUPS, 0, stream>>>(part, stats, co, tiles, h * w, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return planes16<kTN, kNorm, kFold>(x, wk, nullptr, nullptr, stats, yhat, out, n, h, w, ci, co,
                                     tiles, stream);
}

}  // namespace

extern "C" int nemar_convt_in_fwd(const float* x, const float* w, float* wsplit, float* yhat,
                                  float* part, float* stats, float* out, int n, int h, int w_,
                                  int ci, int co, float eps, cudaStream_t stream) {
  const int hw = h * w_;
  const int tiles = (hw + BM - 1) / BM;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  split_transpose_kernel<<<dim3((unsigned)((co + 31) / 32), (unsigned)((ci + 31) / 32), 9),
                           dim3(32, 8), 0, stream>>>(w, wsplit, ci, co);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 64 output channels a tile where 128 would waste half of each, or leave
  // SMs idle (batch 1 at 64^2: 128 tiles of 128 x 128 for 132 SMs)
  const bool narrow = co <= 64 || 4LL * n * tiles * ((co + 127) / 128) < sms;
  err = narrow ? planes<64>(x, wsplit, yhat, part, n, h, w_, ci, co, tiles, stream)
               : planes<128>(x, wsplit, yhat, part, n, h, w_, ci, co, tiles, stream);
  if (err != cudaSuccess) return (int)err;
  convt_stats_kernel<<<dim3((unsigned)((co + ST_LANES - 1) / ST_LANES), (unsigned)n),
                       ST_LANES * ST_WARPS, 0, stream>>>(part, stats, co, tiles, eps,
                                                         one_band(hw), 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_sample = 4LL * hw * co;
  const long long total4 = n * per_sample / 4;
  convt_apply_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(yhat), stats, yhat, out, total4, per_sample, co);
  return (int)cudaGetLastError();
}

// The bf16 variant: x, w, yhat, out bf16; part, stats fp32. Ci, Co
// multiples of 8. Three launches: the passes around the merge.
extern "C" int nemar_convt_in_fwd_bf16(const bf16* x, const bf16* w, float* part, float* stats,
                                       bf16* yhat, bf16* out, int n, int h, int w_, int ci, int co,
                                       float eps, cudaStream_t stream) {
  const int tiles = (h * w_ + BM - 1) / BM;
  // unfolded, 128 columns a tile even where that leaves SMs idle (batch 1
  // at 64^2: 128 tiles for 132 SMs): 64-column tiles, reading each A box
  // twice, ran slower there
  return (int)(co <= 64 ? two_pass16<128, true>(x, w, part, stats, yhat, out, n, h, w_, ci, co,
                                                tiles, eps, stream)
                        : two_pass16<128, false>(x, w, part, stats, yhat, out, n, h, w_, ci, co,
                                                 tiles, eps, stream));
}

// ---------------------------------------------------------------------------
// The band form (--mesh_spatial; ops/convt_fused.py:convt_band_fwd_cuda):
// xp (N, H + 1, W, Ci) is this rank's band with its halo row above (zeros
// at the frame's top); y, yhat, out (N, 2H, 2W, Co) the band of the output
// frame. Two launchers, the caller all-gathering the tile partials between
// them: the split and the four planes' GEMMs over xp; then the frame's
// (mu, rstd) from every rank's partials (ranks, N * 4 * tiles, 2, Co;
// tiles the largest band's, band_hw each rank's H * W: band.cuh) and the
// apply. A band may be uneven, one row or empty (no tile: no GEMM). The
// bf16 variant's (the *_bf16 launchers): xp, W, yhat and out bf16, y
// (before IN) and the statistics fp32. The band form keeps the store of y
// (ConvtFwdOp16<.., kStoreY>, unfolded): its statistics are the frame's,
// known only after the all-gather between its two launchers.
// ---------------------------------------------------------------------------
extern "C" int nemar_convt_band_planes(const float* xp, const float* w, float* wsplit, float* y,
                                       float* part, int n, int h, int w_, int ci, int co,
                                       cudaStream_t stream) {
  const int tiles = (h * w_ + BM - 1) / BM;
  if (tiles == 0) return 0;  // an empty band: the caller's partials are zeros
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  split_transpose_kernel<<<dim3((unsigned)((co + 31) / 32), (unsigned)((ci + 31) / 32), 9),
                           dim3(32, 8), 0, stream>>>(w, wsplit, ci, co);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool narrow = co <= 64 || 4LL * n * tiles * ((co + 127) / 128) < sms;
  err = narrow ? planes<64, true>(xp, wsplit, y, part, n, h, w_, ci, co, tiles, stream)
               : planes<128, true>(xp, wsplit, y, part, n, h, w_, ci, co, tiles, stream);
  return (int)err;
}

namespace {

// the frame's (mu, rstd) from every rank's partials, yhat and out of the
// step's element type T from y (fp32; yhat's own storage in fp32)
template <class T>
int band_apply(const float* parts, float* stats, const int* band_hw, const float* y, T* yhat,
               T* out, int ranks, int n, int h, int w_, int tiles, int co, float eps,
               cudaStream_t stream) {
  BandPixels bp;
  if (!band_pixels(band_hw, ranks, bp)) return (int)cudaErrorInvalidValue;
  convt_stats_kernel<<<dim3((unsigned)((co + ST_LANES - 1) / ST_LANES), (unsigned)n),
                       ST_LANES * ST_WARPS, 0, stream>>>(parts, stats, co, tiles, eps, bp,
                                                         (long long)n * 4 * tiles * 2 * co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_sample = 4LL * h * w_ * co;
  const long long total4 = n * per_sample / 4;
  if (total4 == 0) return 0;
  convt_apply_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(y), stats, yhat, out, total4, per_sample, co);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nemar_convt_band_apply(const float* parts, float* stats, const int* band_hw,
                                      float* yhat, float* out, int ranks, int n, int h, int w_,
                                      int tiles, int co, float eps, cudaStream_t stream) {
  return band_apply(parts, stats, band_hw, yhat, yhat, out, ranks, n, h, w_, tiles, co, eps,
                    stream);
}

extern "C" int nemar_convt_band_planes_bf16(const bf16* xp, const bf16* w, float* y, float* part,
                                            int n, int h, int w_, int ci, int co,
                                            cudaStream_t stream) {
  const int tiles = (h * w_ + BM - 1) / BM;
  if (tiles == 0) return 0;  // an empty band: the caller's partials are zeros
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool narrow = co <= 64 || 4LL * n * tiles * ((co + 127) / 128) < sms;
  err = narrow ? planes16<64, kStoreY, false, true>(xp, w, y, part, nullptr, nullptr, nullptr, n,
                                                    h, w_, ci, co, tiles, stream)
               : planes16<128, kStoreY, false, true>(xp, w, y, part, nullptr, nullptr, nullptr,
                                                     n, h, w_, ci, co, tiles, stream);
  return (int)err;
}

extern "C" int nemar_convt_band_apply_bf16(const float* parts, float* stats, const int* band_hw,
                                           const float* y, bf16* yhat, bf16* out, int ranks, int n,
                                           int h, int w_, int tiles, int co, float eps,
                                           cudaStream_t stream) {
  return band_apply(parts, stats, band_hw, y, yhat, out, ranks, n, h, w_, tiles, co, eps,
                    stream);
}
