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
// against 4 MiB of activation; this first version runs it as fp32 FMAs
// (67 TFLOP/s peak, far below the tensor cores; mma.sync / wgmma are later
// work).
//
// The TPU kernel keeps one whole sample (4 MiB fp32 here) resident in
// 100 MiB of VMEM, so its IN statistics are a plain reduction. A Hopper
// block has at most 227 KB of shared memory, so the statistics need a
// reduction across blocks. The design is deterministic and has five
// launches, all counted as one fused_resblock call by the wrapper:
//
//   1. conv1: implicit GEMM over NHWC, M = N*H*W pixels, N = C_out,
//      K = 9*C_in. Reflect padding is computed in the load (-1 -> 1,
//      H -> H-2), so no padded copy is made. 64x128 output tiles, 8-deep
//      K slices staged in shared memory (double-buffered, register
//      prefetch), 8x8 outputs per thread, fp32 FMA. The epilogue writes
//      y1 and, per tile and channel, the tile mean and the sum of squared
//      deviations from it (a tile is 64 pixels of one sample).
//   2. stats: one thread per (n, c) merges the tiles' (mean, M2) in a fixed
//      order (Chan's parallel formula) into (mu1, rstd1).
//   3. conv2: the same conv kernel; it applies relu((y1 - mu1) * rstd1) to
//      every value it stages, so h1 is never written. Reflection commutes
//      with this per-channel map.
//   4. stats: (mu2, rstd2).
//   5. out = x + (y2 - mu2) * rstd2.
//
// Layouts: x, y1, y2, out (N, H, W, C) fp32; W1, W2 (3, 3, C, C) HWIO fp32
// (row k = (dy*3 + dx)*C + ci of a (9C, C) matrix); stats (N, 4, C) =
// (mu1, rstd1, mu2, rstd2) as in the TPU kernel; part (N*H*W/64, 2, C).
// Requirements (checked by the wrapper): C % 128 == 0, H*W % 64 == 0,
// H, W >= 2, 16-byte aligned pointers.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block tile
constexpr int BN = 128;  // output channels per block tile
constexpr int BK = 8;    // reduction depth per stage (inside one tap)
constexpr int TM = 8;    // pixels per thread
constexpr int TN = 8;    // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
static_assert(THREADS == BN, "the epilogue gives each thread one channel of the tile");
static_assert(BM * BK == 4 * THREADS && BN * BK == 8 * THREADS, "loader shapes");

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// A thread owns pixel rows {ty*4 + i, 32 + ty*4 + i} and channel columns
// {tx*4 + j, 64 + tx*4 + j} (i, j < 4): each quarter-warp then reads 128
// contiguous bytes of shared memory per float4 load, without bank conflicts.
__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 32) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

template <bool kNormReluIn>
__global__ void __launch_bounds__(THREADS)
conv3x3_reflect_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ in_stats, float* __restrict__ y,
                       float* __restrict__ part, int h, int w, int c) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ float red[BM / TM][BN];
  __shared__ float tile_mean[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int hw = h * w;
  const int m0 = blockIdx.x * BM;   // first pixel of the tile, over N*H*W
  const int n0 = blockIdx.y * BN;   // first output channel
  const int b = m0 / hw;            // a tile never straddles two samples

  // A loader: one pixel, four consecutive input channels (BM*BK/4 = 128).
  const int a_p = tid >> 1;
  const int a_c = (tid & 1) * 4;
  const int pix = m0 + a_p - b * hw;
  const int oh = pix / w, ow = pix - (pix / w) * w;
  const float* xb = x + (size_t)b * hw * c;
  const float* mu = kNormReluIn ? in_stats + (size_t)b * 4 * c : nullptr;
  const float* rs = kNormReluIn ? mu + c : nullptr;
  // B loader: rows b_r and b_r + 4 of the K slice, four output channels.
  const int b_r = tid >> 5;
  const int b_c = (tid & 31) * 4;

  const int slices_per_tap = c / BK;
  const int ktiles = 9 * slices_per_tap;

  // The A operand of the next K slice is loaded into registers before the
  // current slice's FMAs and stored to shared memory after them, so the
  // global-load latency hides behind the math. conv2's prologue
  // relu((v - mu) * rstd) is applied at the store, not at the load, for the
  // same reason.
  struct ALoad { float4 v, mu, rs; };
  auto load_a = [&](int kt) {
    const int tap = kt / slices_per_tap;
    const int ci = (kt - tap * slices_per_tap) * BK + a_c;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int ih = reflect(oh + dy - 1, h), iw = reflect(ow + dx - 1, w);
    ALoad a;
    a.v = *reinterpret_cast<const float4*>(xb + ((size_t)ih * w + iw) * c + ci);
    if (kNormReluIn) {
      a.mu = *reinterpret_cast<const float4*>(mu + ci);
      a.rs = *reinterpret_cast<const float4*>(rs + ci);
    }
    return a;
  };
  auto load_b = [&](int kt, float4& r0, float4& r1) {
    const float* row = wt + (size_t)(kt * BK + b_r) * c + n0 + b_c;
    r0 = *reinterpret_cast<const float4*>(row);
    r1 = *reinterpret_cast<const float4*>(row + (size_t)4 * c);
  };
  auto store = [&](int buf, const ALoad& a, const float4& b0, const float4& b1) {
    float4 v = a.v;
    if (kNormReluIn) {
      v.x = fmaxf((v.x - a.mu.x) * a.rs.x, 0.f);
      v.y = fmaxf((v.y - a.mu.y) * a.rs.y, 0.f);
      v.z = fmaxf((v.z - a.mu.z) * a.rs.z, 0.f);
      v.w = fmaxf((v.w - a.mu.w) * a.rs.w, 0.f);
    }
    As[buf][a_c + 0][a_p] = v.x;
    As[buf][a_c + 1][a_p] = v.y;
    As[buf][a_c + 2][a_p] = v.z;
    As[buf][a_c + 3][a_p] = v.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_r][b_c]) = b0;
    *reinterpret_cast<float4*>(&Bs[buf][b_r + 4][b_c]) = b1;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  ALoad a_reg;
  float4 b_reg0, b_reg1;
  a_reg = load_a(0);
  load_b(0, b_reg0, b_reg1);
  store(0, a_reg, b_reg0, b_reg1);
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      a_reg = load_a(kt + 1);
      load_b(kt + 1, b_reg0, b_reg1);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) store(cur ^ 1, a_reg, b_reg0, b_reg1);
    __syncthreads();
  }

  // ---- epilogue: write y, then the tile's per-channel (mean, M2) ----
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* yrow = y + (size_t)(m0 + row_of(ty, i)) * c + n0;
    *reinterpret_cast<float4*>(yrow + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(yrow + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) s += acc[i][j];
    red[ty][col_of(tx, j)] = s;
  }
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < BM / TM; ++t) s += red[t][tid];
    tile_mean[tid] = s * (1.f / BM);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float m = tile_mean[col_of(tx, j)];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float d = acc[i][j] - m;
      q = fmaf(d, d, q);
    }
    red[ty][col_of(tx, j)] = q;
  }
  __syncthreads();
  {
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < BM / TM; ++t) q += red[t][tid];
    float* p = part + (size_t)blockIdx.x * 2 * c + n0 + tid;
    p[0] = tile_mean[tid];
    p[c] = q;
  }
}

// Merge the per-tile (mean, M2) of one sample into (mu, rstd), fixed order.
__global__ void in_stats_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                int n, int c, int tiles, float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  const int b = idx / c, ch = idx - b * c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  float mean = 0.f;
  for (int t = 0; t < tiles; ++t) mean += p[(size_t)t * 2 * c];
  mean /= (float)tiles;
  float m2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float d = p[(size_t)t * 2 * c] - mean;
    m2 += p[(size_t)t * 2 * c + c] + (float)BM * d * d;
  }
  const float var = m2 / ((float)tiles * (float)BM);
  float* s = stats + (size_t)b * 4 * c + ch;
  s[0] = mean;
  s[c] = 1.f / sqrtf(var + eps);
}

// out = x + (y2 - mu2) * rstd2, float4-wide.
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

}  // namespace

extern "C" int nemar_resblock_fwd(const float* x, const float* w1, const float* w2,
                                  float* y1, float* y2, float* part, float* stats,
                                  float* out, int n, int h, int w, int c, float eps,
                                  cudaStream_t stream) {
  const int hw = h * w;
  const int tiles = hw / BM;
  const dim3 conv_grid((unsigned)(n * tiles), (unsigned)(c / BN));
  const int st_threads = 256;
  const unsigned st_blocks = (unsigned)((n * c + st_threads - 1) / st_threads);
  cudaError_t err;

  conv3x3_reflect_kernel<false><<<conv_grid, THREADS, 0, stream>>>(x, w1, nullptr, y1, part, h, w, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_stats_kernel<<<st_blocks, st_threads, 0, stream>>>(part, stats, n, c, tiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  conv3x3_reflect_kernel<true><<<conv_grid, THREADS, 0, stream>>>(y1, w2, stats, y2, part, h, w, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_stats_kernel<<<st_blocks, st_threads, 0, stream>>>(part, stats + 2 * c, n, c, tiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long total4 = (long long)n * hw * c / 4;
  const int r_threads = 256;
  const unsigned r_blocks = (unsigned)((total4 + r_threads - 1) / r_threads);
  residual_kernel<<<r_blocks, r_threads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y2), stats,
      reinterpret_cast<float4*>(out), total4, hw, c);
  return (int)cudaGetLastError();
}
