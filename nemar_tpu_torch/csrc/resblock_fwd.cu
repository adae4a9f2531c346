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
#include <cuda_runtime.h>

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
// tile's per-column (mean, M2) to part.
template <bool kNorm, int kTN>
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
    const float* sb = src + (size_t)b * h * w * c;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const bool valid = ruv[i] >= 0;
      const int su = reflect((ruv[i] >> 16) + dy - 1, h), sv = reflect((ruv[i] & 0xffff) + dx - 1, w);
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
// tile order: mean = sum_t n_t m_t / HW, M2 = sum_t (M2_t + n_t (m_t - mean)^2)
__global__ void in_stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int n,
                                int c, int tiles, int hw, float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  const int b = idx / c, ch = idx - b * c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double mean = 0.0;
  for (int t = 0; t < tiles; ++t) mean += (double)min(BM, hw - t * BM) * (double)p[(size_t)t * 2 * c];
  mean /= (double)hw;
  double m2 = 0.0;
  for (int t = 0; t < tiles; ++t) {
    const double d = (double)p[(size_t)t * 2 * c] - mean;
    m2 += (double)p[(size_t)t * 2 * c + c] + (double)min(BM, hw - t * BM) * d * d;
  }
  float* s = stats + (size_t)b * 4 * c + ch;
  s[0] = (float)mean;
  s[c] = (float)(1.0 / sqrt(m2 / (double)hw + (double)eps));
}

// 6: out = x + (y2 - mu2) * rstd2, float4-wide.
__global__ void residual_kernel(const float4* __restrict__ x, const float4* __restrict__ y,
                                const float* __restrict__ stats, float4* __restrict__ out,
                                long long total4, int hw, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const int b = (int)(e / ((long long)hw * c));
  const float* mu = stats + (size_t)b * 4 * c + 2 * c + ch;
  const float* rs = mu + c;
  const float4 xv = x[i], yv = y[i];
  out[i] = make_float4(xv.x + (yv.x - mu[0]) * rs[0], xv.y + (yv.y - mu[1]) * rs[1],
                       xv.z + (yv.z - mu[2]) * rs[2], xv.w + (yv.w - mu[3]) * rs[3]);
}

template <bool kNorm, int kTN>
cudaError_t conv(const float* src, const float* stats, const float* wsplit, float* y, float* part,
                 int n, int h, int w, int c, int tiles, cudaStream_t stream) {
  ConvOp<kNorm, kTN> op;
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
  in_stats_kernel<<<st_blocks, 256, 0, stream>>>(part, stats, n, c, tiles, hw, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = conv<true, kTN>(y1, stats, wsplit + (size_t)18 * c * c, y2, part, n, h, w, c, tiles,
                             stream)) != cudaSuccess)
    return err;
  in_stats_kernel<<<st_blocks, 256, 0, stream>>>(part, stats + 2 * c, n, c, tiles, hw, eps);
  return cudaGetLastError();
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
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y2), stats,
      reinterpret_cast<float4*>(out), total4, hw, c);
  return (int)cudaGetLastError();
}
