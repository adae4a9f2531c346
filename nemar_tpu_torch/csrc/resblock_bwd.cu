// K-block-bwd: backward of the fused ResNet trunk block (K-block),
//
//   out = x + IN(conv3x3_reflect(relu(IN(conv3x3_reflect(x, W1))), W2)),
//
// given g = d out: dx, dW1, dW2. The conv biases are inert through IN and
// are no inputs, so they get no gradient.
//
// Replaces the TPU kernels nemar_tpu/ops/conv_fused.py:_bwd_pallas_kstack
// (two pallas_calls, stage B2 then B1) and :_bwd_pallas (the same VJP in
// the taps/planes layouts), reached through fused_resblock's custom VJP.
//
// What bounds it on the H100: arithmetic. The VJP is four implicit GEMMs of
// the forward's size (two dgrads, two wgrads), 4 * 2 * N*H*W * 9C * C =
// 19.3 GFLOP per sample at 64x64x256, around two instance-norm backward
// reductions that move a few MB. Like K-block, this first version runs the
// GEMMs as fp32 FMAs on the same 64x128x8 tile (8x8 outputs per thread,
// double-buffered shared memory, register prefetch); the tensor cores are
// later work. The GEMM core is gemm_core.cuh's, shared with K-convt(-bwd).
//
// The TPU kernels hold one sample in VMEM and carry dW across sequential
// grid steps; Hopper blocks run in parallel and in no order, so every
// cross-block sum here is a partial buffer merged in a fixed order, and the
// whole backward is deterministic. Ten launches, counted as one call:
//
//   1-3. dz2 = rstd2 * (g - mean(g) - y2hat * mean(g * y2hat)), per (n, c):
//        per-tile partial sums, a fixed-order fp64 merge, an elementwise
//        apply. y2hat = (y2 - mu2) * rstd2 from the saved forward values.
//   4.   dW2 = sum_p pad(h1)[p + tap] (x) dz2[p]: GEMM M = 9C (tap, ci),
//        N = C, K = pixels, split over SPLITS pixel ranges into a partial
//        buffer (SPLITS * 9C * C floats), then a fixed-order sum. h1 =
//        relu((y1 - mu1) * rstd1) is rebuilt as the operand is staged, as
//        the forward's conv2 does, so h1 is never written.
//   5.   dh1 = the reflect-padded conv's adjoint of dz2 through W2^T: GEMM
//        M = pixels, N = C (ci), K = 9C (tap, co). The reflect-pad adjoint
//        (nemar_tpu/ops/conv_fused.py:_pad_adjoint) is folded into the
//        operand's index map: input pixel u is read by output row i through
//        tap dy iff reflect(i + dy - 1) == u, which is i = u - dy + 1 and,
//        on the edges, also i = 0 (dy = 0, u = 1) or i = H - 1 (dy = 2,
//        u = H - 2); likewise for columns. The staged operand is the sum of
//        those (at most 2 x 2) dz values. Every edge and corner is checked
//        against the plain version, which folds explicitly.
//   6-8. dz1 from gh = dh1 * (y1hat > 0), as in 1-3.
//   9.   dW1 = sum_p pad(x)[p + tap] (x) dz1[p], as in 4.
//   10.  dx = g + the adjoint of dz1 through W1^T, as in 5.
//
// Layouts: x, y1, y2, g, dz, dh1, dx (N, H, W, C) fp32; stats (N, 4, C) =
// (mu1, rstd1, mu2, rstd2), the forward's; w1t, w2t (3, 3, C_out, C_in),
// i.e. HWIO with the last two axes swapped (row (tap * C + co) of a (9C, C)
// matrix); dw1, dw2 (3, 3, C_in, C_out) HWIO; part_in (N*H*W/64, 2, C);
// means (N, 2, C); part_w (SPLITS, 9C, C). Requirements (checked by the
// wrapper): C % 128 == 0, H*W % 64 == 0, H, W >= 2, 16-byte aligned
// pointers, (N*H*W) % (SPLITS * 8) == 0.
#include <cuda_runtime.h>

#include "gemm_core.cuh"

namespace {

using gemm::add4;
using gemm::BK;
using gemm::BLoader;
using gemm::BM;
using gemm::BN;
using gemm::gemm_kernel;
using gemm::split_sum_kernel;
using gemm::THREADS;

constexpr int IN_TILE = 64;  // pixels per IN-backward partial

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// dgrad: out[m, ci] = add[m, ci] + sum_{tap, co} A[m, (tap, co)] * wt[tap*C + co, ci],
// A[(b, u, v), (tap, co)] = sum of dz[b, i, j, co] over the rows i with
// reflect(i + dy - 1) == u and the columns j with reflect(j + dx - 1) == v.
struct DgradOp {
  static constexpr bool kTileStats = false;
  const float* dz;
  const float* wt;
  const float* add;  // nullptr: no residual
  float* out;
  int h, w, c;
  // per thread
  int m0, n0, a_p, a_c, u, v;
  const float* dzb;
  BLoader bl;
  struct Stage { float4 a, b0, b1; };

  __device__ void setup(int tid) {
    const int hw = h * w;
    m0 = blockIdx.x * BM;  // a tile never straddles two samples
    n0 = blockIdx.y * BN;
    const int b = m0 / hw;
    a_p = tid >> 1;
    a_c = (tid & 1) * 4;
    const int pix = m0 + a_p - b * hw;
    u = pix / w;
    v = pix - u * w;
    dzb = dz + (size_t)b * hw * c;
    bl.init(tid);
  }
  __device__ int ktiles() const { return 9 * (c / BK); }
  __device__ void load(int kt, Stage& s) const {
    const int spt = c / BK;
    const int tap = kt / spt;
    const int co = (kt - tap * spt) * BK + a_c;
    const int dy = tap / 3, dx = tap - dy * 3;
    int ri[2], cj[2], nr = 0, nc = 0;
    const int i0 = u - dy + 1, j0 = v - dx + 1;
    if (i0 >= 0 && i0 < h) ri[nr++] = i0;
    if (dy == 0 && u == 1) ri[nr++] = 0;
    if (dy == 2 && u == h - 2) ri[nr++] = h - 1;
    if (j0 >= 0 && j0 < w) cj[nc++] = j0;
    if (dx == 0 && v == 1) cj[nc++] = 0;
    if (dx == 2 && v == w - 2) cj[nc++] = w - 1;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < nr; ++r)
      for (int q = 0; q < nc; ++q)
        a = add4(a, *reinterpret_cast<const float4*>(dzb + ((size_t)ri[r] * w + cj[q]) * c + co));
    s.a = a;
    const float* row = wt + (size_t)(kt * BK + bl.b_r) * c + n0 + bl.b_c;
    s.b0 = *reinterpret_cast<const float4*>(row);
    s.b1 = *reinterpret_cast<const float4*>(row + (size_t)4 * c);
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
    const size_t idx = (size_t)(m0 + r) * c + n0 + col;
    if (add) val = add4(val, *reinterpret_cast<const float4*>(add + idx));
    *reinterpret_cast<float4*>(out + idx) = val;
  }
};

// wgrad partial: part[s][tap*C + ci][co] = sum over the pixels p of split s
// of src'[b, reflect(u + dy - 1), reflect(v + dx - 1), ci] * dz[p, co], with
// src' = src, or relu((src - mu1) * rstd1) when kNormRelu (h1 from y1).
template <bool kNormRelu>
struct WgradOp {
  static constexpr bool kTileStats = false;
  const float* src;
  const float* stats;
  const float* dz;
  float* part;
  int h, w, c, pix_per_split;
  // per thread
  int m0, n0, ci, dy, dx, p0, a_k, a_c;
  BLoader bl;
  struct Stage { float4 a, mu, rs, b0, b1; };

  __device__ void setup(int tid) {
    m0 = blockIdx.x * BM;  // 64 rows (tap, ci) of one tap: C % 64 == 0
    n0 = blockIdx.y * BN;
    const int tap = m0 / c;
    dy = tap / 3;
    dx = tap - dy * 3;
    a_k = tid >> 4;         // pixel of the K slice, 0..7
    a_c = (tid & 15) * 4;   // four consecutive rows (input channels)
    ci = m0 - tap * c + a_c;
    p0 = blockIdx.z * pix_per_split;
    bl.init(tid);
  }
  __device__ int ktiles() const { return pix_per_split / BK; }
  __device__ void load(int kt, Stage& s) const {
    const int hw = h * w;
    const int p = p0 + kt * BK + a_k;
    const int b = p / hw;
    const int pix = p - b * hw;
    const int u = pix / w, v = pix - (pix / w) * w;
    const int ih = reflect(u + dy - 1, h), iw = reflect(v + dx - 1, w);
    s.a = *reinterpret_cast<const float4*>(src + (((size_t)b * h + ih) * w + iw) * c + ci);
    if (kNormRelu) {
      const float* mu = stats + (size_t)b * 4 * c + ci;
      s.mu = *reinterpret_cast<const float4*>(mu);
      s.rs = *reinterpret_cast<const float4*>(mu + c);
    }
    const float* row = dz + (size_t)(p0 + kt * BK + bl.b_r) * c + n0 + bl.b_c;
    s.b0 = *reinterpret_cast<const float4*>(row);
    s.b1 = *reinterpret_cast<const float4*>(row + (size_t)4 * c);
  }
  __device__ void store(float (&A)[BK][BM], float (&B)[BK][BN], const Stage& s) const {
    float4 a = s.a;
    if (kNormRelu) {
      a.x = fmaxf((a.x - s.mu.x) * s.rs.x, 0.f);
      a.y = fmaxf((a.y - s.mu.y) * s.rs.y, 0.f);
      a.z = fmaxf((a.z - s.mu.z) * s.rs.z, 0.f);
      a.w = fmaxf((a.w - s.mu.w) * s.rs.w, 0.f);
    }
    *reinterpret_cast<float4*>(&A[a_k][a_c]) = a;
    *reinterpret_cast<float4*>(&B[bl.b_r][bl.b_c]) = s.b0;
    *reinterpret_cast<float4*>(&B[bl.b_r + 4][bl.b_c]) = s.b1;
  }
  __device__ void write(int r, int col, float4 val) const {
    const size_t rows = (size_t)9 * c;
    float* dst = part + (size_t)blockIdx.z * rows * c + (size_t)(m0 + r) * c + n0 + col;
    *reinterpret_cast<float4*>(dst) = val;
  }
};

// ---------------------------------------------------------------------------
// Instance-norm backward: dz = rstd * (gv - mean(gv) - yhat * mean(gv * yhat))
// per (n, c). kStage 2: gv = g, yhat = (y2 - mu2) * rstd2.
//             kStage 1: yhat = (y1 - mu1) * rstd1, gv = dh1 * (yhat > 0).
// ---------------------------------------------------------------------------
template <int kStage>
__device__ __forceinline__ void in_bwd_terms(float gin, float yv, float mu, float rs,
                                             float& gv, float& yh) {
  yh = (yv - mu) * rs;
  gv = (kStage == 1 && !(yh > 0.f)) ? 0.f : gin;
}

// One block per (64-pixel tile, 128-channel block), one thread per channel.
template <int kStage>
__global__ void in_bwd_partial_kernel(const float* __restrict__ g, const float* __restrict__ y,
                                      const float* __restrict__ stats,
                                      float* __restrict__ part, int hw, int c) {
  const int tile = blockIdx.x;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const int m0 = tile * IN_TILE;
  const int b = m0 / hw;
  const float* st = stats + (size_t)b * 4 * c + (kStage == 2 ? 2 * c : 0) + ch;
  const float mu = st[0], rs = st[c];
  float s1 = 0.f, s2 = 0.f;
  for (int i = 0; i < IN_TILE; ++i) {
    const size_t idx = (size_t)(m0 + i) * c + ch;
    float gv, yh;
    in_bwd_terms<kStage>(g[idx], y[idx], mu, rs, gv, yh);
    s1 += gv;
    s2 = fmaf(gv, yh, s2);
  }
  float* p = part + (size_t)tile * 2 * c + ch;
  p[0] = s1;
  p[c] = s2;
}

// means (N, 2, C) = (mean(gv), mean(gv * yhat)): fixed-order fp64 merge.
__global__ void in_bwd_merge_kernel(const float* __restrict__ part, float* __restrict__ means,
                                    int n, int c, int tiles, int hw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  const int b = idx / c, ch = idx - b * c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double s1 = 0.0, s2 = 0.0;
  for (int t = 0; t < tiles; ++t) {
    s1 += (double)p[(size_t)t * 2 * c];
    s2 += (double)p[(size_t)t * 2 * c + c];
  }
  float* m = means + (size_t)b * 2 * c + ch;
  m[0] = (float)(s1 / hw);
  m[c] = (float)(s2 / hw);
}

template <int kStage>
__global__ void in_bwd_apply_kernel(const float4* __restrict__ g, const float4* __restrict__ y,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, float4* __restrict__ dz,
                                    long long total4, int hw, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int ch = (int)(e % c);
  const int b = (int)(e / ((long long)hw * c));
  const float* mu = stats + (size_t)b * 4 * c + (kStage == 2 ? 2 * c : 0) + ch;
  const float* rs = mu + c;
  const float* m1 = means + (size_t)b * 2 * c + ch;
  const float* m2 = m1 + c;
  const float4 gv4 = g[i], yv4 = y[i];
  const float gin[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
  const float yin[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float gv, yh;
    in_bwd_terms<kStage>(gin[k], yin[k], mu[k], rs[k], gv, yh);
    o[k] = rs[k] * (gv - m1[k] - yh * m2[k]);
  }
  dz[i] = make_float4(o[0], o[1], o[2], o[3]);
}

template <int kStage>
cudaError_t in_bwd(const float* g, const float* y, const float* stats, float* part, float* means,
                   float* dz, int n, int hw, int c, cudaStream_t stream) {
  const int tiles = hw / IN_TILE;
  in_bwd_partial_kernel<kStage><<<dim3((unsigned)(n * tiles), (unsigned)(c / 128)), 128, 0, stream>>>(
      g, y, stats, part, hw, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_merge_kernel<<<(unsigned)((n * c + 255) / 256), 256, 0, stream>>>(part, means, n, c, tiles, hw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total4 = (long long)n * hw * c / 4;
  in_bwd_apply_kernel<kStage><<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(y), stats, means,
      reinterpret_cast<float4*>(dz), total4, hw, c);
  return cudaGetLastError();
}

template <bool kNormRelu>
cudaError_t wgrad(const float* src, const float* stats, const float* dz, float* part, float* dw,
                  int n, int h, int w, int c, int splits, cudaStream_t stream) {
  WgradOp<kNormRelu> op;
  op.src = src;
  op.stats = stats;
  op.dz = dz;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.pix_per_split = n * h * w / splits;
  gemm_kernel<<<dim3((unsigned)(9 * c / BM), (unsigned)(c / BN), (unsigned)splits), THREADS, 0,
                stream>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total4 = (long long)9 * c * c / 4;
  split_sum_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dw), total4, splits);
  return cudaGetLastError();
}

cudaError_t dgrad(const float* dz, const float* wt, const float* add, float* out, int n, int h,
                  int w, int c, cudaStream_t stream) {
  DgradOp op;
  op.dz = dz;
  op.wt = wt;
  op.add = add;
  op.out = out;
  op.h = h;
  op.w = w;
  op.c = c;
  gemm_kernel<<<dim3((unsigned)(n * h * w / BM), (unsigned)(c / BN)), THREADS, 0, stream>>>(op);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nemar_resblock_bwd(const float* x, const float* y1, const float* y2,
                                  const float* stats, const float* g, const float* w1t,
                                  const float* w2t, float* dz, float* dh1, float* part_in,
                                  float* means, float* part_w, float* dw1, float* dw2, float* dx,
                                  int n, int h, int w, int c, int splits, cudaStream_t stream) {
  const int hw = h * w;
  cudaError_t err;
  // stage 2: through IN2 and conv2 -> dW2, dh1
  if ((err = in_bwd<2>(g, y2, stats, part_in, means, dz, n, hw, c, stream)) != cudaSuccess) return (int)err;
  if ((err = wgrad<true>(y1, stats, dz, part_w, dw2, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  if ((err = dgrad(dz, w2t, nullptr, dh1, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  // stage 1: through relu, IN1 and conv1 -> dW1, dx = g + conv1's adjoint
  if ((err = in_bwd<1>(dh1, y1, stats, part_in, means, dz, n, hw, c, stream)) != cudaSuccess) return (int)err;
  if ((err = wgrad<false>(x, stats, dz, part_w, dw1, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  return (int)dgrad(dz, w1t, g, dx, n, h, w, c, stream);
}
