// K-convt-bwd: the backward of K-convt (convt_fwd.cu),
//
//   out = relu(yhat),  yhat = IN(convT(x, W)),
//
// given g = d out and K-convt's saved yhat and (mu, rstd): dx and dW. The
// conv bias is inert through IN and no input, so it gets no gradient.
//
// Replaces the TPU kernel nemar_tpu/ops/attic/convt_fused.py:_bwd_kernel
// (B5's backward).
//
// What bounds it on the H100: arithmetic. dW and dx each cost the forward's
// 2.42 GFLOP per image and stage, around an instance-norm backward over the
// 2H x 2W output that moves a few tens of MB. The TPU kernel keeps a sample
// in VMEM and carries dW across its sequential grid; Hopper blocks run in no
// order, so every sum across blocks here is a partial buffer merged in a
// fixed order (no float atomics: two identical runs are bit-identical).
// Six launches, counted as one call:
//
//   1-3. gh = g * (yhat > 0); per (n, c) the means m1 = mean(gh) and
//        m2 = mean(gh * yhat) over the 4 planes together (per-tile partial
//        sums, a fixed-order fp64 merge by a block per (n, 32 channels));
//        dz = rstd * (gh - m1 - yhat * m2).
//   4.   dW[ky, kx] = sum over pixels (n, i, j) of x[n, i + dy, j + dx] (x)
//        dz[n, 2i + py, 2j + px], the tap's one parity plane (py, dy) from
//        the forward's table: a GEMM M = 9 * Ci (tap, ci), N = Co,
//        K = N*H*W, split over pixel ranges into a partial buffer, then
//        summed in split order (as K-block-bwd's weight gradients).
//   5-6. dx[n, i, j] = sum over the 9 taps of dz[n, 2i + 2 - ky, 2j + 2 - kx]
//        . W[ky, kx]^T (zero past the output's edge), the TPU kernel's _AXB
//        table: a GEMM M = N*H*W pixels, N = Ci, K = 9 * Co (tap, co) with
//        wt = W transposed to (3, 3, Co, Ci).
//
// All three GEMMs run on the templated FMA core (gemm_core.cuh).
//
// Layouts: x, dx (N, H, W, Ci); yhat, g, dz (N, 2H, 2W, Co); stats
// (N, 2, Co) = (mu, rstd); wt (3, 3, Co, Ci); dw (3, 3, Ci, Co) HWIO;
// part_in (N * tiles, 2, Co), tiles = ceil(4*H*W / 64); means (N, 2, Co);
// part_w (splits, 9 * Ci, Co). All fp32. Requirements (checked by the
// wrapper): Ci % 4 == 0, Co % 4 == 0, 16-byte aligned pointers,
// pix_per_split % 8 == 0.
#include <cuda_runtime.h>

#include "gemm_core.cuh"

namespace {

using gemm::BK;
using gemm::BLoader;
using gemm::BM;
using gemm::BN;
using gemm::gemm_kernel;
using gemm::split_sum_kernel;
using gemm::THREADS;
using gemm::zero4;

constexpr int IN_TILE = 64;  // output pixels per IN-backward partial

// ---------------------------------------------------------------------------
// 1-3. the instance norm + relu backward over the 4 planes
// ---------------------------------------------------------------------------
// One block per (64-pixel tile of one sample, 128-channel block), one thread
// per channel.
__global__ void in_bwd_partial_kernel(const float* __restrict__ g, const float* __restrict__ yh,
                                      float* __restrict__ part, int pixels, int c, int tiles) {
  const int blk = blockIdx.x;  // (n, tile)
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const int b = blk / tiles;
  const int t = blk - b * tiles;
  const int p0 = t * IN_TILE;
  const int cnt = min(IN_TILE, pixels - p0);
  float s1 = 0.f, s2 = 0.f;
  for (int q = 0; q < cnt; ++q) {
    const size_t idx = ((size_t)b * pixels + p0 + q) * c + ch;
    const float y = yh[idx];
    const float gv = y > 0.f ? g[idx] : 0.f;
    s1 += gv;
    s2 = fmaf(gv, y, s2);
  }
  float* p = part + (size_t)blk * 2 * c + ch;
  p[0] = s1;
  p[c] = s2;
}

// means (N, 2, C) = (mean(gh), mean(gh * yhat)): fp64, fixed order. A block
// owns one sample and 32 channels (a lane each); warp k takes the partials
// t = k, k + 32, ..., and warp 0 adds the 32 warps' sums in warp order.
constexpr int MG_LANES = 32, MG_WARPS = 32;

__global__ void __launch_bounds__(MG_LANES * MG_WARPS)
in_bwd_merge_kernel(const float* __restrict__ part, float* __restrict__ means, int c, int tiles,
                    int pixels) {
  __shared__ double red[2][MG_WARPS][MG_LANES];
  const int lane = threadIdx.x % MG_LANES, warp = threadIdx.x / MG_LANES;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * MG_LANES + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double s1 = 0.0, s2 = 0.0;
  for (int t = warp; live && t < tiles; t += MG_WARPS) {
    s1 += (double)p[(size_t)t * 2 * c];
    s2 += (double)p[(size_t)t * 2 * c + c];
  }
  red[0][warp][lane] = s1;
  red[1][warp][lane] = s2;
  __syncthreads();
  if (warp == 0 && live) {
    double m1 = 0.0, m2 = 0.0;
    for (int k = 0; k < MG_WARPS; ++k) {
      m1 += red[0][k][lane];
      m2 += red[1][k][lane];
    }
    float* m = means + (size_t)b * 2 * c + ch;
    m[0] = (float)(m1 / pixels);
    m[c] = (float)(m2 / pixels);
  }
}

__global__ void in_bwd_apply_kernel(const float4* __restrict__ g, const float4* __restrict__ yh,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, float4* __restrict__ dz,
                                    long long total4, long long per_sample, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const int b = (int)(e / per_sample);
  const float* rs = stats + (size_t)b * 2 * c + c + ch;
  const float* m1 = means + (size_t)b * 2 * c + ch;
  const float* m2 = m1 + c;
  const float4 gv4 = g[i], yv4 = yh[i];
  const float gin[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
  const float yin[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gv = yin[k] > 0.f ? gin[k] : 0.f;
    o[k] = rs[k] * (gv - m1[k] - yin[k] * m2[k]);
  }
  dz[i] = make_float4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------------------
// 4. dW partials: part[s][tap*Ci + ci][co] = sum over the pixels p of split
// s of x[b, i + dy, j + dx, ci] * dz[b, 2i + py, 2j + px, co]
// ---------------------------------------------------------------------------
struct ConvtWgradOp {
  static constexpr bool kTileStats = false;
  const float* x;
  const float* dz;
  float* part;
  int h, w_, ci, co, total, pix_per_split;
  // per thread
  int tap, ci0, n0, py, px, dy, dx, p0, a_k, a_c;
  BLoader bl;
  struct Stage { float4 a, b0, b1; };

  __device__ void setup(int tid) {
    const int mtiles = (ci + BM - 1) / BM;  // 64-row tiles within one tap
    tap = blockIdx.x / mtiles;
    ci0 = (blockIdx.x - tap * mtiles) * BM;
    n0 = blockIdx.y * BN;
    const int ky = tap / 3, kx = tap - (tap / 3) * 3;
    py = ky == 1;
    px = kx == 1;
    dy = ky == 0 ? -1 : 0;
    dx = kx == 0 ? -1 : 0;
    a_k = tid >> 4;        // pixel of the K slice, 0..7
    a_c = (tid & 15) * 4;  // four consecutive rows (input channels)
    p0 = blockIdx.z * pix_per_split;
    bl.init(tid);
  }
  __device__ int ktiles() const { return pix_per_split / BK; }
  // the dz offset of plane pixel p, or -1 past the last pixel
  __device__ long long dz_row(int p) const {
    if (p >= total) return -1;
    const int hw = h * w_;
    const int b = p / hw;
    const int pix = p - b * hw;
    const int i = pix / w_, j = pix - (pix / w_) * w_;
    return (((long long)b * 2 * h + 2 * i + py) * 2 * w_ + 2 * j + px) * co;
  }
  __device__ void load(int kt, Stage& s) const {
    const int hw = h * w_;
    const int p = p0 + kt * BK + a_k;
    const int c = ci0 + a_c;
    s.a = zero4();
    if (p < total && c < ci) {
      const int b = p / hw;
      const int pix = p - b * hw;
      const int ii = pix / w_ + dy, jj = pix - (pix / w_) * w_ + dx;
      if (ii >= 0 && jj >= 0)
        s.a = *reinterpret_cast<const float4*>(x + (((size_t)b * h + ii) * w_ + jj) * ci + c);
    }
    const int col = n0 + bl.b_c;
    const long long r0 = dz_row(p0 + kt * BK + bl.b_r);
    const long long r1 = dz_row(p0 + kt * BK + bl.b_r + 4);
    s.b0 = (r0 >= 0 && col < co) ? *reinterpret_cast<const float4*>(dz + r0 + col) : zero4();
    s.b1 = (r1 >= 0 && col < co) ? *reinterpret_cast<const float4*>(dz + r1 + col) : zero4();
  }
  __device__ void store(float (&A)[BK][BM], float (&B)[BK][BN], const Stage& s) const {
    *reinterpret_cast<float4*>(&A[a_k][a_c]) = s.a;
    *reinterpret_cast<float4*>(&B[bl.b_r][bl.b_c]) = s.b0;
    *reinterpret_cast<float4*>(&B[bl.b_r + 4][bl.b_c]) = s.b1;
  }
  __device__ void write(int r, int col, float4 val) const {
    if (ci0 + r >= ci || n0 + col >= co) return;
    float* dst = part + ((size_t)blockIdx.z * 9 * ci + (size_t)tap * ci + ci0 + r) * co + n0 + col;
    *reinterpret_cast<float4*>(dst) = val;
  }
};

// ---------------------------------------------------------------------------
// 5-6. dx[p, ci] = sum_{tap, co} dz[b, 2i + 2 - ky, 2j + 2 - kx, co] * wt[tap, co, ci]
// ---------------------------------------------------------------------------
struct ConvtDgradOp {
  static constexpr bool kTileStats = false;
  const float* dz;
  const float* wt;
  float* dx;
  int h, w_, ci, co, total;
  // per thread
  int m0, n0, a_p, a_c, b, i, j, spt;
  bool valid;
  BLoader bl;
  struct Stage { float4 a, b0, b1; };

  __device__ void setup(int tid) {
    const int hw = h * w_;
    m0 = blockIdx.x * BM;
    n0 = blockIdx.y * BN;
    a_p = tid >> 1;
    a_c = (tid & 1) * 4;
    const int p = m0 + a_p;
    valid = p < total;
    b = p / hw;
    const int pix = p - b * hw;
    i = pix / w_;
    j = pix - i * w_;
    spt = (co + BK - 1) / BK;
    bl.init(tid);
  }
  __device__ int ktiles() const { return 9 * spt; }
  __device__ void load(int kt, Stage& s) const {
    const int tap = kt / spt;
    const int cs = (kt - tap * spt) * BK;
    const int ky = tap / 3, kx = tap - (tap / 3) * 3;
    const int oi = 2 * i + 2 - ky, oj = 2 * j + 2 - kx;
    const int c = cs + a_c;
    s.a = (valid && oi < 2 * h && oj < 2 * w_ && c < co)
              ? *reinterpret_cast<const float4*>(
                    dz + (((size_t)b * 2 * h + oi) * 2 * w_ + oj) * co + c)
              : zero4();
    const int r0 = cs + bl.b_r, col = n0 + bl.b_c;
    const float* wk = wt + (size_t)tap * co * ci;
    s.b0 = (r0 < co && col < ci) ? *reinterpret_cast<const float4*>(wk + (size_t)r0 * ci + col)
                                 : zero4();
    s.b1 = (r0 + 4 < co && col < ci)
               ? *reinterpret_cast<const float4*>(wk + (size_t)(r0 + 4) * ci + col) : zero4();
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
    const int p = m0 + r;
    if (p >= total || n0 + col >= ci) return;
    *reinterpret_cast<float4*>(dx + (size_t)p * ci + n0 + col) = val;
  }
};

}  // namespace

extern "C" int nemar_convt_in_bwd(const float* x, const float* wt, const float* yhat,
                                  const float* stats, const float* g, float* dz, float* part_in,
                                  float* means, float* part_w, float* dw, float* dx, int n, int h,
                                  int w_, int ci, int co, int splits, int pix_per_split,
                                  cudaStream_t stream) {
  const int pixels = 4 * h * w_;  // of one sample's output
  const int tiles = (pixels + IN_TILE - 1) / IN_TILE;
  cudaError_t err;
  in_bwd_partial_kernel<<<dim3((unsigned)(n * tiles), (unsigned)((co + 127) / 128)), 128, 0,
                          stream>>>(g, yhat, part_in, pixels, co, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_bwd_merge_kernel<<<dim3((unsigned)((co + MG_LANES - 1) / MG_LANES), (unsigned)n),
                        MG_LANES * MG_WARPS, 0, stream>>>(part_in, means, co, tiles, pixels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_sample = (long long)pixels * co;
  const long long total4 = n * per_sample / 4;
  in_bwd_apply_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(yhat), stats, means,
      reinterpret_cast<float4*>(dz), total4, per_sample, co);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int total = n * h * w_;  // input pixels = each plane's pixels
  ConvtWgradOp wop;
  wop.x = x;
  wop.dz = dz;
  wop.part = part_w;
  wop.h = h;
  wop.w_ = w_;
  wop.ci = ci;
  wop.co = co;
  wop.total = total;
  wop.pix_per_split = pix_per_split;
  gemm_kernel<<<dim3((unsigned)(9 * ((ci + BM - 1) / BM)), (unsigned)((co + BN - 1) / BN),
                     (unsigned)splits), THREADS, 0, stream>>>(wop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long w4 = (long long)9 * ci * co / 4;
  split_sum_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), reinterpret_cast<float4*>(dw), w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ConvtDgradOp dop;
  dop.dz = dz;
  dop.wt = wt;
  dop.dx = dx;
  dop.h = h;
  dop.w_ = w_;
  dop.ci = ci;
  dop.co = co;
  dop.total = total;
  gemm_kernel<<<dim3((unsigned)((total + BM - 1) / BM), (unsigned)((ci + BN - 1) / BN)), THREADS,
                0, stream>>>(dop);
  return (int)cudaGetLastError();
}
