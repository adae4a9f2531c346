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
// fp32 FMA peak, against 8-17 MB of activations. Three launches, counted as
// one call:
//
//   1. the four planes' GEMMs on the templated FMA core
//      (gemm_core.cuh: 64 x 128 tiles, 8-deep double-buffered K slices),
//      a tile being 64 pixels of one plane of one sample. The epilogue
//      writes y to its interleaved place (N, 2H, 2W, Co) and, per channel,
//      the tile's mean and sum of squared deviations over its valid pixels;
//   2. a block per (n, 32 channels) merges the 4 planes' tiles in a fixed
//      order in fp64 (Chan's formula, weighted by each tile's pixel count)
//      into (mu, rstd);
//   3. yhat = (y - mu) * rstd in place, and out = relu(yhat).
//
// yhat and (mu, rstd) are kept for K-convt-bwd, as the TPU kernel keeps its
// normalised planes and statistics.
//
// Layouts: x (N, H, W, Ci); W (3, 3, Ci, Co) HWIO, flax ConvTranspose's
// kernel; yhat, out (N, 2H, 2W, Co); stats (N, 2, Co) = (mu, rstd); part
// (N * 4 * tiles, 2, Co), tiles = ceil(H*W / 64). All fp32. Requirements
// (checked by the wrapper): Ci % 4 == 0, Co % 4 == 0, 16-byte aligned
// pointers.
#include <cuda_runtime.h>

#include "gemm_core.cuh"

namespace {

using gemm::BK;
using gemm::BLoader;
using gemm::BM;
using gemm::BN;
using gemm::gemm_kernel;
using gemm::THREADS;
using gemm::zero4;

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

struct ConvtFwdOp {
  static constexpr bool kTileStats = true;
  const float* x;
  const float* w;
  float* y;
  float* part;
  int h, w_, ci, co, tiles;
  // per thread
  int n, plane, py, px, tile, m0, n0, a_p, a_c, i, j, spt, ntx;
  bool valid;
  BLoader bl;
  struct Stage { float4 a, b0, b1; };

  __device__ void setup(int tid) {
    const int bid = blockIdx.x;  // (n, plane, tile)
    tile = bid % tiles;
    plane = (bid / tiles) % 4;
    n = bid / (tiles * 4);
    py = plane >> 1;
    px = plane & 1;
    m0 = tile * BM;
    n0 = blockIdx.y * BN;
    a_p = tid >> 1;
    a_c = (tid & 1) * 4;
    const int pix = m0 + a_p;
    valid = pix < h * w_;
    i = pix / w_;
    j = pix - i * w_;
    spt = (ci + BK - 1) / BK;
    ntx = px == 0 ? 2 : 1;
    bl.init(tid);
  }
  __device__ int ktiles() const { return (py == 0 ? 2 : 1) * ntx * spt; }
  __device__ void load(int kt, Stage& s) const {
    const int tap = kt / spt;
    const int cs = (kt - tap * spt) * BK;
    int ky, dy, kx, dx;
    parity_tap(py, tap / ntx, ky, dy);
    parity_tap(px, tap % ntx, kx, dx);
    const int ii = i + dy, jj = j + dx, c = cs + a_c;
    s.a = (valid && ii >= 0 && jj >= 0 && c < ci)
              ? *reinterpret_cast<const float4*>(x + (((size_t)n * h + ii) * w_ + jj) * ci + c)
              : zero4();
    const int r0 = cs + bl.b_r, col = n0 + bl.b_c;
    const float* wk = w + (size_t)(ky * 3 + kx) * ci * co;
    s.b0 = (r0 < ci && col < co) ? *reinterpret_cast<const float4*>(wk + (size_t)r0 * co + col)
                                 : zero4();
    s.b1 = (r0 + 4 < ci && col < co)
               ? *reinterpret_cast<const float4*>(wk + (size_t)(r0 + 4) * co + col) : zero4();
  }
  __device__ void store(float (&A)[BK][BM], float (&B)[BK][BN], const Stage& s) const {
    A[a_c + 0][a_p] = s.a.x;
    A[a_c + 1][a_p] = s.a.y;
    A[a_c + 2][a_p] = s.a.z;
    A[a_c + 3][a_p] = s.a.w;
    *reinterpret_cast<float4*>(&B[bl.b_r][bl.b_c]) = s.b0;
    *reinterpret_cast<float4*>(&B[bl.b_r + 4][bl.b_c]) = s.b1;
  }
  __device__ void write(int r, int col, float4 val) const {
    const int pix = m0 + r;
    if (pix >= h * w_ || n0 + col >= co) return;
    const int oi = 2 * (pix / w_) + py, oj = 2 * (pix % w_) + px;
    *reinterpret_cast<float4*>(y + (((size_t)n * 2 * h + oi) * 2 * w_ + oj) * co + n0 + col) = val;
  }
  __device__ int rows_in_tile() const { return min(BM, h * w_ - m0); }
  __device__ void write_stats(int col, float mean, float m2) const {
    if (n0 + col >= co) return;
    float* p = part + ((size_t)((n * 4 + plane) * tiles + tile) * 2) * co + n0 + col;
    p[0] = mean;
    p[co] = m2;
  }
};

// (mu, rstd) per (n, c) from the 4 planes' tile partials, in fp64: mean =
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

// yhat = (y - mu) * rstd in place; out = relu(yhat). float4-wide.
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

}  // namespace

extern "C" int nemar_convt_in_fwd(const float* x, const float* w, float* yhat, float* part,
                                  float* stats, float* out, int n, int h, int w_, int ci, int co,
                                  float eps, cudaStream_t stream) {
  const int hw = h * w_;
  const int tiles = (hw + BM - 1) / BM;
  ConvtFwdOp op;
  op.x = x;
  op.w = w;
  op.y = yhat;
  op.part = part;
  op.h = h;
  op.w_ = w_;
  op.ci = ci;
  op.co = co;
  op.tiles = tiles;
  gemm_kernel<<<dim3((unsigned)(n * 4 * tiles), (unsigned)((co + BN - 1) / BN)), THREADS, 0,
                stream>>>(op);
  cudaError_t err = cudaGetLastError();
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
