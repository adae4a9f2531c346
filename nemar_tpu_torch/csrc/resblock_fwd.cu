// K-block: forward of the fused ResNet trunk block,
//
//   out = x + IN(conv3x3_reflect(relu(IN(conv3x3_reflect(x, W1))), W2))
//
// with instance norm per (n, c) over H*W (biased variance, eps), no affine
// and no conv bias (a bias is inert through IN).
//
// Replaces the TPU kernel nemar_tpu/ops/conv_fused.py:_fwd_pallas
// (_fwd_kernel / _fwd_kernel_kstack), reached through fused_resblock.
//
// What bounds it on the H100: arithmetic. One conv at the slice shape
// (N x 64 x 64 x 256) is 2 * N*4096 * 256 * 2304 = 4.8 GFLOP per sample,
// against 4 MiB of activation. Both convolutions run on the tensor cores in
// 3xTF32 on K-block-bwd's wgmma core (gemm_tc.cuh: each fp32 product is
// three TF32 MMAs, chained over one 32-deep K slice and added to an fp32
// total, which keeps fp32-level accuracy), so the bound is 3 x 77.3 GFLOP at
// 495 TFLOP/s = 0.47 ms a b8 call, against 1.15 ms at the fp32 FMA peak of
// 67 TFLOP/s, where an earlier version of this kernel ran.
//
// Each conv is an implicit GEMM over NHWC: M = pixels (128-row tiles, a tile
// never straddles two samples: a sample's last tile is masked), N = C_out
// (128 columns, or 64 where 128 would leave SMs idle: batch 1 at 64^2 has
// 64 tiles of 128 x 128 for 132 SMs), K = 9 C_in in 32-deep slices, one tap
// and 32 channels each.
// A row of a slice is 32 channels of one source pixel, copied by cp.async in
// 16-byte pieces, K-major as wgmma's A wants it; the reflect padding is in
// the index (-1 -> 1, H -> H - 2), so no padded copy is made and nothing is
// zero-filled. B is W transposed per tap to (tap, C_out, C_in), K-major,
// split into TF32 big and small parts once per call for both weights (the
// dgrads' layout: copied straight into wgmma's swizzled tiles). conv2 reads
// y1 and rebuilds h1 = relu((y1 - mu1) * rstd1) on A's fragments before the
// split (the core's kNormRelu: (mu1, rstd1) of the slice's 32 channels ride
// in the same cp.async group), so h1 is never written; reflection commutes
// with this per-channel map.
//
// The TPU kernel keeps one whole sample (4 MiB fp32 here) resident in
// 100 MiB of VMEM, so its IN statistics are a plain reduction. A Hopper
// block has at most 227 KB of shared memory, so the statistics need a
// reduction across blocks: the GEMM's epilogue reduces its tile to the
// per-channel (mean, sum of squared deviations) of its rows (gemm_tc.cuh:
// tile_stats, a fixed order), and a merge launch combines a sample's tiles
// in fp64 in tile order. The whole forward is deterministic, in six
// launches, all counted as one fused_resblock call by the wrapper:
//
//   1. split: W1, W2 -> (big, small) of W^T per tap (a tiled transpose);
//   2. conv1: y1 and its tile statistics;
//   3. stats: (mu1, rstd1);
//   4. conv2 from relu(IN(y1)): y2 and its tile statistics;
//   5. stats: (mu2, rstd2);
//   6. out = x + (y2 - mu2) * rstd2.
//
// Layouts: x, y1, y2, out (N, H, W, C) fp32; W1, W2 (3, 3, C, C) HWIO fp32;
// wsplit (4, 9, C, C) = (W1^T big, W1^T small, W2^T big, W2^T small), each
// (tap, C_out, C_in); stats (N, 4, C) = (mu1, rstd1, mu2, rstd2) as in the
// TPU kernel; part (N * ceil(H*W / 128), 2, C). Requirements (checked by the
// wrapper): C % 128 == 0, H, W >= 2, 16-byte aligned pointers.
//
// The bf16 variant (--bf16; nemar_resblock_fwd_bf16) takes x, W1, W2 in
// bf16, as the TPU kernel does under bf16, and runs both convolutions on
// the bf16 core (gemm_tc.cuh: one bf16 MMA a product, fp32 totals). It
// rounds where the TPU kernel stores the compute dtype: h1 = relu(y1hat),
// conv2's operand, and out, and it keeps y1hat in bf16 for the backward;
// y1, y2 and the statistics are fp32.
//
// What bounds it: arithmetic, 2 convs x 38.65 GFLOP = 77.3 GFLOP a b8 call
// at 989 TFLOP/s = 0.078 ms (0.0098 ms at b1), against ~84 MB moved (0.025
// ms). The design: the convolutions on the warp-specialised, persistent
// core with one slice's MMAs in flight; their A operand as TMA boxes of
// reflect-padded copies of x and h1 (N, H + 2, W + 2, C) where a tile's
// 128 pixels are image rows (row_boxes: W divides 128 or 128 divides W;
// else the producer's copies reflect in the index), written by the launch
// that transposes W and by the one that writes h1; the statistics
// merged eight loads deep (in_stats16_kernel). Seven launches (merging
// the statistics into the launches that apply them was no faster at b1
// and slower at b8: PERF.md §6):
//
//   1. W1, W2 -> W^T per tap (tap, C_out, C_in), bf16; x's padded copy;
//   2. conv1 (bf16 x): y1 fp32 and its tile statistics;
//   3. stats: (mu1, rstd1);
//   4. y1hat = (y1 - mu1) * rstd1 and h1 = relu(y1hat), both bf16, h1
//      also into its padded copy;
//   5. conv2 (bf16 h1): y2 fp32 and its tile statistics;
//   6. stats: (mu2, rstd2);
//   7. out = x + (y2 - mu2) * rstd2, bf16.
#include <cuda_runtime.h>

#include "band.cuh"
#include "gemm_tc.cuh"

namespace {

using tc::BK;
using tc::BM;
using tc::BN;
using tc::CHUNKS;
using tc::cp_async16;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// y[b, p, co] = sum_{tap, ci} src'[b, reflect(u + dy - 1), reflect(v + dx - 1), ci]
//                             * W[tap][ci][co],
// src' = src, or relu((src - mu1) * rstd1) when kNorm (h1 from y1); the
// tile's per-column (mean, M2) to part. kHp (the band form): src holds each
// sample's H + 2 rows, its halo rows already in place, and only W is
// reflected: src'[b, u + dy, reflect(v + dx - 1), ci].
template <bool kNorm, int kTN, bool kHp = false>
struct ConvOp {
  static constexpr bool kNormRelu = kNorm;
  static constexpr bool kTileStats = true;
  static constexpr int kTileN = kTN;  // output channels per tile: 128 or 64
  const float* src;
  const float* stats;
  // W^T (tap, co, ci), split: B(k = (tap, ci), n = co) is K-major as it lies
  const float* wbig;
  const float* wsmall;
  float* y;
  float* part;
  int h, w, c, tiles;  // tiles: 128-pixel tiles per sample
  static constexpr int hp = kHp ? 1 : 0;
  // per thread: the tile, and for its A rows u << 16 | v (-1 past the sample)
  int b, tile, m0, n0, kc, rows;
  int ruv[CHUNKS];

  __device__ void setup(int tid) {
    b = blockIdx.x / tiles;
    tile = blockIdx.x - b * tiles;
    m0 = tile * BM;
    n0 = blockIdx.y * kTN;
    kc = tc::kmajor_k(tid);
    const int hw = h * w;
    rows = min(BM, hw - m0);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int p = m0 + tc::kmajor_row(tid, i);
      const int u = p / w;
      ruv[i] = p < hw ? (u << 16) | (p - u * w) : -1;
    }
  }
  __device__ int ktiles() const { return 9 * c / BK; }
  __device__ void load_ab(int kt, float* As, float* Bb, float* Bs, int tid) const {
    const int k0 = kt * BK;
    const int tap = k0 / c;
    const int ci = k0 - tap * c + kc;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const float* sb = src + (size_t)b * (h + 2 * hp) * w * c;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const bool valid = ruv[i] >= 0;
      const int su = kHp ? (ruv[i] >> 16) + dy : reflect((ruv[i] >> 16) + dy - 1, h);
      const int sv = reflect((ruv[i] & 0xffff) + dx - 1, w);
      cp_async16(tc::kmajor_at(As, tc::kmajor_row(tid, i), kc),
                 valid ? sb + ((size_t)su * w + sv) * c + ci : sb, valid);
    }
#pragma unroll
    for (int i = 0; i < kTN * BK / 4 / tc::THREADS; ++i) {
      const int nr = tc::kmajor_row(tid, i);
      const size_t off = ((size_t)tap * c + n0 + nr) * c + ci;
      const int dst = tc::swizzled_off(nr, kc / 4);
      cp_async16(Bb + dst, wbig + off, true);
      cp_async16(Bs + dst, wsmall + off, true);
    }
  }
  __device__ void load(int kt, float* As, float* Bb, float* Bs, int tid) const {
    load_ab(kt, As, Bb, Bs, tid);
  }
  // kNorm: also (mu1, rstd1) of the slice's 32 channels -> ns[0, 32), ns[32, 64)
  __device__ void load(int kt, float* As, float* Bb, float* Bs, float* ns, int tid) const {
    load_ab(kt, As, Bb, Bs, tid);
    if (tid < 16) {
      const int k0 = kt * BK, ci0 = k0 - (k0 / c) * c;
      cp_async16(ns + 4 * tid, stats + (size_t)b * 4 * c + (tid < 8 ? 0 : c) + ci0 + 4 * (tid & 7),
                 true);
    }
  }
  template <class V>
  __device__ void write(int r, int col, V val) const {
    if (r < rows)
      *reinterpret_cast<V*>(y + ((size_t)b * h * w + m0 + r) * c + n0 + col) = val;
  }
  __device__ int rows_in_tile() const { return rows; }
  __device__ void write_stats(int col, float mean, float m2) const {
    float* p = part + (size_t)(b * tiles + tile) * 2 * c + n0 + col;
    p[0] = mean;
    p[c] = m2;
  }
};

// 1: wsplit[2 which + s][tap][co][ci] = big / small part of w_which[tap][ci][co],
// through a 32 x 32 tile in shared memory (reads and writes coalesced)
__global__ void split_transpose_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                       float* __restrict__ wsplit, int c) {
  __shared__ float tile[32][33];
  const int which = blockIdx.z / 9, tap = blockIdx.z - 9 * which;
  const float* src = (which ? w2 : w1) + (size_t)tap * c * c;
  const int ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) tile[r][tx] = src[(size_t)(ci0 + r) * c + co0 + tx];
  __syncthreads();
  float* big = wsplit + ((size_t)2 * which * 9 + tap) * c * c;
  float* small = big + (size_t)9 * c * c;
  for (int r = ty; r < 32; r += 8) {
    uint32_t bg, sm;
    tc::split_tf32(tile[tx][r], bg, sm);
    const size_t o = (size_t)(co0 + r) * c + ci0 + tx;
    big[o] = __uint_as_float(bg);
    small[o] = __uint_as_float(sm);
  }
}

// 3 / 5: (mu, rstd) per (n, c) from the sample's tile partials, in fp64 and
// tile order: mean = sum_t n_t m_t / HW, M2 = sum_t (M2_t + n_t (m_t - mean)^2).
// The band form (--mesh_spatial) merges every rank's partials, bp.ranks
// blocks of (N * tiles, 2, C) `rank_stride` floats apart, rank by rank in
// the same order, each tile's count its rank's (band.cuh; tiles the
// largest band's, a smaller band's partials zero past its own): the
// frame's statistics.
__global__ void in_stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int n,
                                int c, int tiles, float eps, BandPixels bp,
                                long long rank_stride) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  const int b = idx / c, ch = idx - b * c;
  const double pixels = band_total(bp);
  double mean = 0.0;
  for (int r = 0; r < bp.ranks; ++r) {
    const float* p = part + (size_t)r * rank_stride + (size_t)b * tiles * 2 * c + ch;
    for (int t = 0; t < tiles; ++t)
      mean += (double)tile_count(bp, r, t, BM) * (double)p[(size_t)t * 2 * c];
  }
  mean /= pixels;
  double m2 = 0.0;
  for (int r = 0; r < bp.ranks; ++r) {
    const float* p = part + (size_t)r * rank_stride + (size_t)b * tiles * 2 * c + ch;
    for (int t = 0; t < tiles; ++t) {
      const double d = (double)p[(size_t)t * 2 * c] - mean;
      m2 += (double)p[(size_t)t * 2 * c + c] + (double)tile_count(bp, r, t, BM) * d * d;
    }
  }
  float* s = stats + (size_t)b * 4 * c + ch;
  s[0] = (float)mean;
  s[c] = (float)(1.0 / sqrt(m2 / pixels + (double)eps));
}

// 6 (7 in the bf16 variant): out = x + (y2 - mu2) * rstd2, float4-wide; x
// and out of the element type T, y2 fp32
template <class T>
__global__ void residual_kernel(const T* __restrict__ x, const float4* __restrict__ y,
                                const float* __restrict__ stats, T* __restrict__ out,
                                long long total4, int hw, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const int b = (int)(e / ((long long)hw * c));
  const float* mu = stats + (size_t)b * 4 * c + 2 * c + ch;
  const float* rs = mu + c;
  const float4 xv = tc::load4(x + e), yv = y[i];
  tc::store4(out + e, make_float4(xv.x + (yv.x - mu[0]) * rs[0], xv.y + (yv.y - mu[1]) * rs[1],
                                  xv.z + (yv.z - mu[2]) * rs[2], xv.w + (yv.w - mu[3]) * rs[3]));
}

template <bool kNorm, int kTN, bool kHp = false>
cudaError_t conv(const float* src, const float* stats, const float* wsplit, float* y, float* part,
                 int n, int h, int w, int c, int tiles, cudaStream_t stream) {
  ConvOp<kNorm, kTN, kHp> op;
  op.src = src;
  op.stats = stats;
  op.wbig = wsplit;
  op.wsmall = wsplit + (size_t)9 * c * c;
  op.y = y;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.tiles = tiles;
  return tc::launch_wgmma(op, dim3((unsigned)(n * tiles), (unsigned)(c / kTN)), stream);
}

template <int kTN>
cudaError_t convs(const float* x, const float* wsplit, float* y1, float* y2, float* part,
                  float* stats, int n, int h, int w, int c, int tiles, float eps,
                  cudaStream_t stream) {
  const int hw = h * w;
  const unsigned st_blocks = (unsigned)((n * c + 255) / 256);
  cudaError_t err;
  if ((err = conv<false, kTN>(x, nullptr, wsplit, y1, part, n, h, w, c, tiles, stream)) != cudaSuccess)
    return err;
  in_stats_kernel<<<st_blocks, 256, 0, stream>>>(part, stats, n, c, tiles, eps, one_band(hw),
                                                 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = conv<true, kTN>(y1, stats, wsplit + (size_t)18 * c * c, y2, part, n, h, w, c, tiles,
                             stream)) != cudaSuccess)
    return err;
  in_stats_kernel<<<st_blocks, 256, 0, stream>>>(part, stats + 2 * c, n, c, tiles, eps,
                                                 one_band(hw), 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 variant
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// y[b, p, co] = sum_{tap, ci} src[b, reflect(u + dy - 1), reflect(v + dx - 1), ci]
//                             * W[tap][ci][co], src and W bf16, y fp32;
// the tile's per-column (mean, M2) to part. A K slice is one tap and 64
// channels. B (W^T) is a TMA box; A is one (tma_a: the reflect-padded
// source, (N, H + 2, W + 2, C), the tile's 128 pixels whole image rows,
// or part of one: W divides 128 or 128 divides W) or the producer's
// cp.async copies from src, reflected in the index. kHp (the band form):
// src holds each sample's H + 2 rows, its halo rows in place, read at row
// u + dy (copies: only W is reflected).
template <int kTN, bool kHp = false>
struct ConvOp16 : tc::Bf16Loads {
  static constexpr bool kMN = false;
  static constexpr bool kTileStats = true;
  static constexpr int kTileN = kTN;
  const bf16* src;
  float* y;
  float* part;
  int h, w, c, tiles;
  // the tile, the producer thread's 16-byte chunk of a K slice's row, and
  // for its A rows u << 16 | v (-1 past the sample)
  int b, tile, m0, n0, kc, rows;
  int ruv[tc::PCHUNKS];

  __device__ void setup(int ptid, uint3 blk) {
    b = blk.x / tiles;
    tile = blk.x - b * tiles;
    m0 = tile * BM;
    n0 = blk.y * kTN;
    kc = ptid & 7;
    const int hw = h * w;
    rows = min(BM, hw - m0);
    if (!tma_a) {
#pragma unroll
      for (int i = 0; i < tc::PCHUNKS; ++i) {
        const int p = m0 + tc::prow(ptid, i);
        const int u = p / w;
        ruv[i] = p < hw ? (u << 16) | (p - u * w) : -1;
      }
    }
  }
  __device__ int ktiles() const { return 9 * c / tc::BK16; }
  // A by cp.async (tma_a false)
  __device__ void load(int kt, unsigned char* As, unsigned char*, int ptid) const {
    const int k0 = kt * tc::BK16;
    const int tap = k0 / c;
    const int ci = k0 - tap * c + 8 * kc;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const bf16* sb = src + (size_t)b * (h + (kHp ? 2 : 0)) * w * c;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const bool valid = ruv[i] >= 0;
      const int su = kHp ? (ruv[i] >> 16) + dy : reflect((ruv[i] >> 16) + dy - 1, h);
      const int sv = reflect((ruv[i] & 0xffff) + dx - 1, w);
      tc::cp_async16b(As + tc::swz16(tc::prow(ptid, i), kc),
                      valid ? sb + ((size_t)su * w + sv) * c + ci : sb, valid);
    }
  }
  // B, W^T (tap, co, ci) as maps.b's 9C rows; with tma_a, A from the padded
  // source (maps.a) at pixel (u0 + dy, v0 + dx)
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    const int k0 = kt * tc::BK16;
    const int tap = k0 / c;
    const int ci = k0 - tap * c;
    if (tma_a) {
      const int dy = tap / 3, dx = tap - 3 * dy, u0 = m0 / w;
      tc::tma_load(As, &maps.a, bar, ci, m0 - u0 * w + dx, u0 + dy, b);
    }
    tc::tma_load(Bs, &maps.b, bar, ci, tap * c + n0);
  }
  __device__ void write(int r, int col, float2 val) const {
    if (r < rows) tc::store2(y + ((size_t)b * h * w + m0 + r) * c + n0 + col, val);
  }
  __device__ int rows_in_tile() const { return rows; }
  __device__ void write_stats(int col, float mean, float m2) const {
    float* p = part + (size_t)(b * tiles + tile) * 2 * c + n0 + col;
    p[0] = mean;
    p[c] = m2;
  }
};

// whether a 128-pixel tile of a W-wide frame is a box of whole image rows
// (or of part of one): W divides 128 or 128 divides W
inline bool row_boxes(int w, int pixels) {
  return w % pixels == 0 || pixels % w == 0;
}

// 1: wt[which][tap][co][ci] = w_which[tap][ci][co] (blocks [0, 18 (C/32)^2),
// through a 32 x 32 tile); then, given xpad, the reflect-padded copy of x
// (N, H + 2, W + 2, C), 8 channels a thread (the remaining blocks)
__global__ void prep16_kernel(const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                              bf16* __restrict__ wt, const bf16* __restrict__ x,
                              bf16* __restrict__ xpad, int n, int h, int w, int c) {
  const int tblocks = 18 * (c / 32) * (c / 32);
  if ((int)blockIdx.x < tblocks) {
    __shared__ bf16 tile[32][34];
    const int per = (c / 32) * (c / 32), z = blockIdx.x / per, xy = blockIdx.x - z * per;
    const int which = z / 9, tap = z - 9 * which;
    const bf16* src = (which ? w2 : w1) + (size_t)tap * c * c;
    const int ci0 = (xy / (c / 32)) * 32, co0 = (xy % (c / 32)) * 32;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    for (int r = ty; r < 32; r += 8) tile[r][tx] = src[(size_t)(ci0 + r) * c + co0 + tx];
    __syncthreads();
    bf16* dst = wt + ((size_t)which * 9 + tap) * c * c;
    for (int r = ty; r < 32; r += 8) dst[(size_t)(co0 + r) * c + ci0 + tx] = tile[tx][r];
    return;
  }
  const long long i = (long long)(blockIdx.x - tblocks) * blockDim.x + threadIdx.x;
  const long long e = i * 8;
  if (e >= (long long)n * (h + 2) * (w + 2) * c) return;
  const int ch = (int)(e % c);
  const long long pix = e / c;
  const int v = (int)(pix % (w + 2));
  const long long r = pix / (w + 2);
  const int u = (int)(r % (h + 2)), b = (int)(r / (h + 2));
  *reinterpret_cast<uint4*>(xpad + e) = *reinterpret_cast<const uint4*>(
      x + (((size_t)b * h + reflect(u - 1, h)) * w + reflect(v - 1, w)) * c + ch);
}

cudaError_t prep16(const bf16* w1, const bf16* w2, bf16* wt, const bf16* x, bf16* xpad, int n,
                   int h, int w, int c, cudaStream_t stream) {
  const long long chunks = xpad ? (long long)n * (h + 2) * (w + 2) * c / 8 : 0;
  const unsigned blocks = (unsigned)(18 * (c / 32) * (c / 32) + (chunks + 255) / 256);
  prep16_kernel<<<blocks, 256, 0, stream>>>(w1, w2, wt, x, xpad, n, h, w, c);
  return cudaGetLastError();
}

// 3 / 6: (mu, rstd) per (n, c) from the sample's tile partials, in fp64, as
// in_stats_kernel's formulas: a block takes 32 channels of one sample, its
// warp j summing the tiles t = j (mod 8) in tile order, then the 8 sums
// are added in warp order (a fixed order, eight loads in flight where one
// thread would chain them)
__global__ void in_stats16_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                  int c, int tiles, int hw, float eps) {
  __shared__ double red[8][32];
  __shared__ double mean_s[32];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  const int b = idx / c, ch = idx - b * c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double s = 0.0;
  for (int t = j; t < tiles; t += 8) s += (double)min(BM, hw - t * BM) * (double)p[(size_t)t * 2 * c];
  red[j][lane] = s;
  __syncthreads();
  if (j == 0) {
    double m = 0.0;
    for (int k = 0; k < 8; ++k) m += red[k][lane];
    mean_s[lane] = m / hw;
  }
  __syncthreads();
  const double mean = mean_s[lane];
  s = 0.0;
  for (int t = j; t < tiles; t += 8) {
    const double d = (double)p[(size_t)t * 2 * c] - mean;
    s += (double)p[(size_t)t * 2 * c + c] + (double)min(BM, hw - t * BM) * d * d;
  }
  red[j][lane] = s;
  __syncthreads();
  if (j == 0) {
    double m2 = 0.0;
    for (int k = 0; k < 8; ++k) m2 += red[k][lane];
    float* st = stats + (size_t)b * 4 * c + ch;
    st[0] = (float)mean;
    st[c] = (float)(1.0 / sqrt(m2 / hw + (double)eps));
  }
}

// 4: y1hat = (y1 - mu1) * rstd1, h1 = relu(y1hat), both rounded to bf16;
// given hpad, h1 also into its reflect-padded copy (N, H + 2, W + 2, C):
// at (u + 1, v + 1), and where the padding reflects it (rows 0 and H + 1
// from rows 1 and H - 2, columns likewise, the corners from both). The
// band form passes no hpad, and its pixels as H = hw, W = 1.
__global__ void norm_relu16_kernel(const float4* __restrict__ y, const float* __restrict__ stats,
                                   bf16* __restrict__ yhat, bf16* __restrict__ h1,
                                   bf16* __restrict__ hpad, long long total4, int h, int w,
                                   int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const long long p = e / c;
  const int hw = h * w;
  const int b = (int)(p / hw);
  const float* mu = stats + (size_t)b * 4 * c + ch;
  const float* rs = mu + c;
  const float4 v = y[i];
  const float4 yh = make_float4((v.x - mu[0]) * rs[0], (v.y - mu[1]) * rs[1],
                                (v.z - mu[2]) * rs[2], (v.w - mu[3]) * rs[3]);
  const float4 hv =
      make_float4(fmaxf(yh.x, 0.f), fmaxf(yh.y, 0.f), fmaxf(yh.z, 0.f), fmaxf(yh.w, 0.f));
  tc::store4(yhat + e, yh);
  tc::store4(h1 + e, hv);
  if (hpad == nullptr) return;
  const int pix = (int)(p - (long long)b * hw), u = pix / w, vv = pix - u * w;
  const int rows[3] = {u + 1, u == 1 ? 0 : -1, u == h - 2 ? h + 1 : -1};
  const int cols[3] = {vv + 1, vv == 1 ? 0 : -1, vv == w - 2 ? w + 1 : -1};
  bf16* hb = hpad + (size_t)b * (h + 2) * (w + 2) * c + ch;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (rows[r] >= 0 && cols[q] >= 0)
        tc::store4(hb + ((size_t)rows[r] * (w + 2) + cols[q]) * c, hv);
}

// a conv on the bf16 core: B = W^T per tap (wt) as TMA boxes; A from the
// padded source pad by TMA where given, else copied from src
template <int kTN, bool kHp = false>
cudaError_t conv16(const bf16* src, const bf16* pad, const bf16* wt, float* y, float* part, int n,
                   int h, int w, int c, int tiles, cudaStream_t stream) {
  ConvOp16<kTN, kHp> op;
  op.src = src;
  op.y = y;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.tiles = tiles;
  op.tma_b = true;
  op.tma_a = pad != nullptr;
  tc::TmaMaps maps{};
  cudaError_t err = tc::weight_map(&maps.b, wt, c, kTN);
  if (err == cudaSuccess && pad != nullptr) {
    const int bw = min(w, BM);
    err = tc::image_map(&maps.a, pad, n, h + 2, w + 2, c, bw, BM / bw);
  }
  if (err != cudaSuccess) return err;
  return tc::launch_bf16(op, dim3((unsigned)(n * tiles), (unsigned)(c / kTN)), stream, maps);
}

template <int kTN>
cudaError_t convs16(const bf16* x, const bf16* xpad, const bf16* wt, float* y1, bf16* y1hat,
                    bf16* h1, bf16* hpad, float* y2, float* part, float* stats, int n, int h,
                    int w, int c, int tiles, float eps, cudaStream_t stream) {
  const int hw = h * w;
  const unsigned st_blocks = (unsigned)(n * c / 32);
  const long long total4 = (long long)n * hw * c / 4;
  cudaError_t err;
  if ((err = conv16<kTN>(x, xpad, wt, y1, part, n, h, w, c, tiles, stream)) != cudaSuccess)
    return err;
  in_stats16_kernel<<<st_blocks, 256, 0, stream>>>(part, stats, c, tiles, hw, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  norm_relu16_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(y1), stats, y1hat, h1, hpad, total4, h, w, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = conv16<kTN>(h1, hpad, wt + (size_t)9 * c * c, y2, part, n, h, w, c, tiles,
                         stream)) != cudaSuccess)
    return err;
  in_stats16_kernel<<<st_blocks, 256, 0, stream>>>(part, stats + 2 * c, c, tiles, hw, eps);
  return cudaGetLastError();
}

// the GEMM tiles' width of a call: 64 where 128-wide tiles would leave SMs
// idle
cudaError_t narrow_tiles(int n, int tiles, int c, bool* narrow) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *narrow = (long long)n * tiles * (c / BN) < sms;
  return err;
}

}  // namespace

// The GEMM tiles are 128 output channels wide, or 64 where 128-wide tiles
// would leave SMs idle (batch 1 at 64^2: 64 tiles for 132 SMs).
extern "C" int nemar_resblock_fwd(const float* x, const float* w1, const float* w2, float* wsplit,
                                  float* y1, float* y2, float* part, float* stats, float* out,
                                  int n, int h, int w, int c, float eps, cudaStream_t stream) {
  const int hw = h * w;
  const int tiles = (hw + BM - 1) / BM;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool narrow = (long long)n * tiles * (c / BN) < sms;
  split_transpose_kernel<<<dim3((unsigned)(c / 32), (unsigned)(c / 32), 18), dim3(32, 8), 0,
                           stream>>>(w1, w2, wsplit, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = narrow ? convs<64>(x, wsplit, y1, y2, part, stats, n, h, w, c, tiles, eps, stream)
               : convs<128>(x, wsplit, y1, y2, part, stats, n, h, w, c, tiles, eps, stream);
  if (err != cudaSuccess) return (int)err;
  const long long total4 = (long long)n * hw * c / 4;
  const int r_threads = 256;
  const unsigned r_blocks = (unsigned)((total4 + r_threads - 1) / r_threads);
  residual_kernel<<<r_blocks, r_threads, 0, stream>>>(
      x, reinterpret_cast<const float4*>(y2), stats, out, total4, hw, c);
  return (int)cudaGetLastError();
}

// The bf16 variant: x, w1, w2, wt (2, 9, C, C), pads (2, N, H + 2, W + 2, C:
// x's and h1's reflect-padded copies, written where a tile's pixels are
// image rows: row_boxes), y1hat, h1, out bf16; y1, y2, part, stats fp32.
// Tiles as the fp32 forward's.
extern "C" int nemar_resblock_fwd_bf16(const bf16* x, const bf16* w1, const bf16* w2, bf16* wt,
                                       bf16* pads, float* y1, bf16* y1hat, bf16* h1, float* y2,
                                       float* part, float* stats, bf16* out, int n, int h, int w,
                                       int c, float eps, cudaStream_t stream) {
  const int hw = h * w;
  const int tiles = (hw + BM - 1) / BM;
  bool narrow = false;
  cudaError_t err = narrow_tiles(n, tiles, c, &narrow);
  if (err != cudaSuccess) return (int)err;
  const bool box = row_boxes(w, BM);
  bf16* xpad = box ? pads : nullptr;
  bf16* hpad = box ? pads + (size_t)n * (h + 2) * (w + 2) * c : nullptr;
  if ((err = prep16(w1, w2, wt, x, xpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  err = narrow ? convs16<64>(x, xpad, wt, y1, y1hat, h1, hpad, y2, part, stats, n, h, w, c, tiles,
                             eps, stream)
               : convs16<128>(x, xpad, wt, y1, y1hat, h1, hpad, y2, part, stats, n, h, w, c,
                              tiles, eps, stream);
  if (err != cudaSuccess) return (int)err;
  const long long total4 = (long long)n * hw * c / 4;
  residual_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      x, reinterpret_cast<const float4*>(y2), stats, out, total4, hw, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The band form (--mesh_spatial; ops/conv_fused.py:block_band_fwd_cuda): x's
// rows are this rank's band of the frame, the statistics the frame's. The
// forward's launches, cut where a statistic needs every rank's tiles (the
// caller all-gathers the tile partials between them) and where conv2 needs
// y1's halo rows (the caller exchanges them); both convs read a source that
// holds its halo rows (ConvOp's kHp). Four launchers, each a few launches:
//   conv1: W1, W2's split, conv1 over xp (N, H + 2, W, C) -> y1, part;
//   stats: (mu, rstd) into stats' slot from every rank's part;
//   conv2: conv2 over y1p (N, H + 2, W, C) with IN1 + relu on the fly;
//   residual: (mu2, rstd2) from every rank's part, out = x + IN2(y2).
// parts: (ranks, N * tiles, 2, C), tiles = ceil(H_most * W / 128) of the
// largest band (a smaller band's partials zero past its own), and
// band_hw each rank's H * W (the host's; band.cuh): the bands may be
// uneven, one row or empty (no tile: the GEMM launchers launch nothing).
//
// The bf16 variant's band form (the *_bf16 launchers) rounds where the
// bf16 forward does: x, W1, W2 bf16, y1 and y2 fp32 with their tile
// statistics, y1hat and h1 bf16 on the band, out bf16. conv2 reads h1
// with its halo rows (h1p, N, H + 2, W, C bf16: the caller exchanges the
// bf16 rows, the frame's reflection at its edges), not y1, so the rows
// the ranks exchange are the bf16 values the whole-frame variant's conv2
// reads. Four launchers:
//   conv1_bf16: W1, W2 -> W^T per tap (bf16), conv1 over xp -> y1, part;
//   norm_relu_bf16: (mu1, rstd1) from every rank's part, y1hat and h1;
//   conv2_bf16: conv2 over h1p -> y2, part;
//   residual_bf16: (mu2, rstd2) from every rank's part, out = x + IN2(y2).
// ---------------------------------------------------------------------------
extern "C" int nemar_resblock_band_conv1(const float* xp, const float* w1, const float* w2,
                                         float* wsplit, float* y1, float* part, int n, int h,
                                         int w, int c, cudaStream_t stream) {
  const int tiles = (h * w + BM - 1) / BM;
  if (tiles == 0) return 0;  // an empty band: no tile (the caller's partials are zeros)
  bool narrow = false;
  cudaError_t err = narrow_tiles(n, tiles, c, &narrow);
  if (err != cudaSuccess) return (int)err;
  split_transpose_kernel<<<dim3((unsigned)(c / 32), (unsigned)(c / 32), 18), dim3(32, 8), 0,
                           stream>>>(w1, w2, wsplit, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = narrow ? conv<false, 64, true>(xp, nullptr, wsplit, y1, part, n, h, w, c, tiles, stream)
               : conv<false, 128, true>(xp, nullptr, wsplit, y1, part, n, h, w, c, tiles, stream);
  return (int)err;
}

// band_hw: each rank's pixels (host ints); tiles: the largest band's, the
// stride of each rank's partials
extern "C" int nemar_resblock_band_stats(const float* parts, float* stats, const int* band_hw,
                                         int ranks, int slot, int n, int tiles, int c, float eps,
                                         cudaStream_t stream) {
  BandPixels bp;
  if (!band_pixels(band_hw, ranks, bp)) return (int)cudaErrorInvalidValue;
  in_stats_kernel<<<(unsigned)((n * c + 255) / 256), 256, 0, stream>>>(
      parts, stats + (size_t)2 * slot * c, n, c, tiles, eps, bp, (long long)n * tiles * 2 * c);
  return (int)cudaGetLastError();
}

extern "C" int nemar_resblock_band_conv2(const float* y1p, const float* stats, const float* wsplit,
                                         float* y2, float* part, int n, int h, int w, int c,
                                         cudaStream_t stream) {
  const int tiles = (h * w + BM - 1) / BM;
  if (tiles == 0) return 0;
  bool narrow = false;
  cudaError_t err = narrow_tiles(n, tiles, c, &narrow);
  if (err != cudaSuccess) return (int)err;
  const float* w2split = wsplit + (size_t)18 * c * c;
  err = narrow ? conv<true, 64, true>(y1p, stats, w2split, y2, part, n, h, w, c, tiles, stream)
               : conv<true, 128, true>(y1p, stats, w2split, y2, part, n, h, w, c, tiles, stream);
  return (int)err;
}

namespace {

// (mu2, rstd2) from every rank's part, out = x + IN2(y2); x and out of the
// step's element type T
template <class T>
int band_residual(const float* parts, float* stats, const int* band_hw, const T* x,
                  const float* y2, T* out, int ranks, int n, int hw, int tiles, int c, float eps,
                  cudaStream_t stream) {
  const int err =
      nemar_resblock_band_stats(parts, stats, band_hw, ranks, 1, n, tiles, c, eps, stream);
  if (err != 0) return err;
  const long long total4 = (long long)n * hw * c / 4;
  if (total4 == 0) return 0;
  residual_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      x, reinterpret_cast<const float4*>(y2), stats, out, total4, hw, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nemar_resblock_band_residual(const float* parts, float* stats, const int* band_hw,
                                            const float* x, const float* y2, float* out, int ranks,
                                            int n, int hw, int tiles, int c, float eps,
                                            cudaStream_t stream) {
  return band_residual(parts, stats, band_hw, x, y2, out, ranks, n, hw, tiles, c, eps, stream);
}

extern "C" int nemar_resblock_band_conv1_bf16(const bf16* xp, const bf16* w1, const bf16* w2,
                                              bf16* wt, float* y1, float* part, int n, int h,
                                              int w, int c, cudaStream_t stream) {
  const int tiles = (h * w + BM - 1) / BM;
  if (tiles == 0) return 0;
  bool narrow = false;
  cudaError_t err = narrow_tiles(n, tiles, c, &narrow);
  if (err != cudaSuccess) return (int)err;
  if ((err = prep16(w1, w2, wt, nullptr, nullptr, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  err = narrow ? conv16<64, true>(xp, nullptr, wt, y1, part, n, h, w, c, tiles, stream)
               : conv16<128, true>(xp, nullptr, wt, y1, part, n, h, w, c, tiles, stream);
  return (int)err;
}

extern "C" int nemar_resblock_band_norm_relu_bf16(const float* parts, float* stats,
                                                  const int* band_hw, const float* y1,
                                                  bf16* y1hat, bf16* h1, int ranks, int n,
                                                  int hw, int tiles, int c, float eps,
                                                  cudaStream_t stream) {
  const int err =
      nemar_resblock_band_stats(parts, stats, band_hw, ranks, 0, n, tiles, c, eps, stream);
  if (err != 0) return err;
  const long long total4 = (long long)n * hw * c / 4;
  if (total4 == 0) return 0;
  norm_relu16_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(y1), stats, y1hat, h1, nullptr, total4, hw, 1, c);
  return (int)cudaGetLastError();
}

extern "C" int nemar_resblock_band_conv2_bf16(const bf16* h1p, const bf16* wt, float* y2,
                                              float* part, int n, int h, int w, int c,
                                              cudaStream_t stream) {
  const int tiles = (h * w + BM - 1) / BM;
  if (tiles == 0) return 0;
  bool narrow = false;
  cudaError_t err = narrow_tiles(n, tiles, c, &narrow);
  if (err != cudaSuccess) return (int)err;
  const bf16* w2t = wt + (size_t)9 * c * c;
  err = narrow ? conv16<64, true>(h1p, nullptr, w2t, y2, part, n, h, w, c, tiles, stream)
               : conv16<128, true>(h1p, nullptr, w2t, y2, part, n, h, w, c, tiles, stream);
  return (int)err;
}

extern "C" int nemar_resblock_band_residual_bf16(const float* parts, float* stats,
                                                 const int* band_hw, const bf16* x,
                                                 const float* y2, bf16* out, int ranks, int n,
                                                 int hw, int tiles, int c, float eps,
                                                 cudaStream_t stream) {
  return band_residual(parts, stats, band_hw, x, y2, out, ranks, n, hw, tiles, c, eps, stream);
}
