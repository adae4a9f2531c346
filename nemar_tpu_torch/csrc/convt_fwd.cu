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
#include <cuda_runtime.h>

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
// tile's per-column (mean, M2) to part.
template <int kTN>
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
    const float* xb = x + (size_t)b * h * w * ci;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int ii = (rij[i] >> 16) + dy, jj = (rij[i] & 0xffff) + dx;
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

__global__ void __launch_bounds__(ST_LANES * ST_WARPS)
convt_stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int c, int tiles,
                   int hw, float eps) {
  __shared__ double red[ST_WARPS][ST_LANES];
  __shared__ double mean_s[ST_LANES];
  const int lane = threadIdx.x % ST_LANES, warp = threadIdx.x / ST_LANES;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * ST_LANES + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * 4 * tiles * 2 * c + ch;
  const int per_sample = 4 * tiles;
  double s = 0.0;
  for (int t = warp; live && t < per_sample; t += ST_WARPS)
    s += (double)min(BM, hw - (t % tiles) * BM) * (double)p[(size_t)t * 2 * c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    double m = 0.0;
    for (int k = 0; k < ST_WARPS; ++k) m += red[k][lane];
    mean_s[lane] = m / (4.0 * (double)hw);
  }
  __syncthreads();
  const double mean = mean_s[lane];
  double m2 = 0.0;
  for (int t = warp; live && t < per_sample; t += ST_WARPS) {
    const double d = (double)p[(size_t)t * 2 * c] - mean;
    m2 += (double)p[(size_t)t * 2 * c + c] + (double)min(BM, hw - (t % tiles) * BM) * d * d;
  }
  red[warp][lane] = m2;
  __syncthreads();
  if (warp == 0 && live) {
    double q = 0.0;
    for (int k = 0; k < ST_WARPS; ++k) q += red[k][lane];
    float* st = stats + (size_t)b * 2 * c + ch;
    st[0] = (float)mean;
    st[c] = (float)(1.0 / sqrt(q / (4.0 * (double)hw) + (double)eps));
  }
}

// 4: yhat = (y - mu) * rstd in place; out = relu(yhat). float4-wide.
__global__ void convt_apply_kernel(float4* __restrict__ y, const float* __restrict__ stats,
                                   float4* __restrict__ out, long long total4, long long per_sample,
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
  y[i] = yh;
  out[i] = make_float4(fmaxf(yh.x, 0.f), fmaxf(yh.y, 0.f), fmaxf(yh.z, 0.f), fmaxf(yh.w, 0.f));
}

// 2
template <int kTN>
cudaError_t planes(const float* x, const float* wsplit, float* y, float* part, int n, int h, int w,
                   int ci, int co, int tiles, cudaStream_t stream) {
  ConvtFwdOp<kTN> op;
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
                       ST_LANES * ST_WARPS, 0, stream>>>(part, stats, co, tiles, hw, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_sample = 4LL * hw * co;
  const long long total4 = n * per_sample / 4;
  convt_apply_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<float4*>(yhat), stats, reinterpret_cast<float4*>(out), total4, per_sample,
      co);
  return (int)cudaGetLastError();
}
