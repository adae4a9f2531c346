// K-block-bwd: backward of the fused ResNet trunk block (K-block),
//
//   out = x + IN(conv3x3_reflect(relu(IN(conv3x3_reflect(x, W1))), W2)),
//
// given g = d out: dx, dW1, dW2. The conv biases are inert through IN and
// are no inputs, so they get no gradient.
//
// Replaces the TPU kernels nemar_tpu/ops/conv_fused.py:_bwd_pallas_kstack
// (pallas_calls at :544 and :557, stage B2 then B1) and :_bwd_pallas (:603,
// :616, the same VJP in the taps/planes layouts), reached through
// fused_resblock's custom VJP.
//
// What bounds it on the H100: arithmetic. The VJP is four implicit GEMMs of
// the forward's size (two dgrads, two wgrads), 4 * 2 * N*H*W * 9C * C =
// 19.3 GFLOP per sample at 64x64x256 (154.6 GFLOP at batch 8: 2.31 ms at the
// fp32 FMA peak of 67 TFLOP/s), around two instance-norm backwards that
// move a few hundred MB. The GEMMs run on the tensor cores in 3xTF32
// (gemm_tc.cuh): each fp32 product is three TF32 MMAs (small*big +
// big*small + big*big, big = tf32(x), small = x - big), chained over one K
// slice and added to an fp32 total, which keeps fp32-level accuracy; the
// tensor-core bound is then 3 x 154.6 GFLOP at 495 TFLOP/s = 0.94 ms a b8
// call. 1xTF32 would be 3x cheaper but misses fp32 by ~3e-4 of the largest
// value at K = 2304 (tests/test_torch_tf32_split.py), far from the fp32
// plain version this kernel is held to. All four run on wgmma (m64n128k8,
// A from registers): the dgrads' operands are both K-major (dz along co, W
// in HWIO along co); the wgrads' are both pixel-major (K outermost), and
// their B tile is transposed in shared memory into the K-major layout
// wgmma wants for TF32. Operands reach shared memory by cp.async into a
// 4-stage ring.
//
// The TPU kernels hold one sample in VMEM and carry dW across sequential
// grid steps; Hopper blocks run in parallel and in no order, so every
// cross-block sum here is a partial buffer merged in a fixed order, and the
// whole backward is deterministic (no atomics). Twelve launches, counted as
// one call:
//
//   1-3. dz2 = rstd2 * (g - mean(g) - y2hat * mean(g * y2hat)), per (n, c):
//        per-tile partial sums, a fixed-order fp64 merge, an elementwise
//        apply. y2hat = (y2 - mu2) * rstd2 from the saved forward values.
//        The merge launch also splits W1 and W2 into TF32 big and small
//        parts for the dgrads' B operand.
//   4-5. dW2 = sum_p pad(h1)[p + tap] (x) dz2[p]: GEMM M = 9C (tap, ci),
//        N = C, K = pixels, split over SPLITS pixel ranges into a partial
//        buffer (SPLITS * 9C * C floats), then a fixed-order sum. h1 =
//        relu((y1 - mu1) * rstd1) is rebuilt at fragment load, before the
//        TF32 split, as the forward's conv2 does, so h1 is never written.
//   6.   dpad2 = the zero-padded full correlation of dz2 with W2^T on the
//        (H+2) x (W+2) domain: GEMM M = N (H+2)(W+2), N = C (ci), K = 9C
//        (tap, co), A[(b, U, V), (tap, co)] = dz2[b, U - dy, V - dx, co] or 0
//        off the frame (cp.async zero fill), B = W2 in HWIO as it is. The
//        reflect pad's adjoint is then a fold of dpad's four border lines
//        onto rows / columns 1 and H-2 (W-2), in
//        ops/conv_fused.py:reflect_pad_adjoint's order. This is design (b):
//        the folded index map of design (a) sums 2-4 values for the rows and
//        columns 1 and H-2, and a column 1 lies in every tile, so no tile
//        would stay pure cp.async. The fold costs 6% more GEMM rows at 64^2
//        and one more read of the border lines; it is done where dh1 is
//        read (7-9), so dh1 is never written.
//   7-9. dz1 from gh = dh1 * (y1hat > 0), dh1 = fold(dpad2), as in 1-3.
//   10.  dW1's partials = sum_p pad(x)[p + tap] (x) dz1[p], as in 4.
//   11.  dpad1 from dz1 and W1, as in 6.
//   12.  dx = g + fold(dpad1), and dW1 = the fixed-order sum of 10's
//        partials, in one launch (two independent element-wise passes).
//
// Layouts: x, y1, y2, g, dz, dx (N, H, W, C) fp32; dpad (N, H+2, W+2, C);
// stats (N, 4, C) = (mu1, rstd1, mu2, rstd2), the forward's; w1, w2, dw1,
// dw2 (3, 3, C_in, C_out) HWIO; wsplit (4, 9C, C) = (W1 big, W1 small, W2
// big, W2 small); part_in (N*H*W/64, 2, C); means (N, 2, C); part_w
// (SPLITS, 9C, C). Requirements (checked by the wrapper): C % 128 == 0,
// H*W % 64 == 0, H, W >= 2, 16-byte aligned pointers, N (H+2)(W+2) C
// < 2^31 (32-bit offsets in the dgrad's loader).
#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

using tc::BK;
using tc::BM;
using tc::BN;
using tc::CHUNKS;
using tc::cp_async16;

constexpr int IN_TILE = 64;  // pixels per IN-backward partial

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <class T>
__device__ __forceinline__ T load(const float* p) { return *reinterpret_cast<const T*>(p); }

// reflect_pad_adjoint(dpad, 1) at (b, u, v), channels ch.. (1 or 4 of them):
// the padded row U = u + 1 plus padded row 0 (U == 2) then row H + 1
// (U == H - 1); then, on those row sums, column V = v + 1 plus column 0
// (V == 2) then column W + 1 (V == W - 1).
template <class T>
__device__ __forceinline__ T fold(const float* __restrict__ dpad, int b, int u, int v, int ch,
                                  int h, int w, int c) {
  const int wp = w + 2, U = u + 1, V = v + 1;
  const float* base = dpad + (size_t)b * (h + 2) * wp * c + ch;
  auto row_sum = [&](int col) {
    T s = load<T>(base + ((size_t)U * wp + col) * c);
    if (U == 2) s = add(s, load<T>(base + (size_t)col * c));
    if (U == h - 1) s = add(s, load<T>(base + ((size_t)(h + 1) * wp + col) * c));
    return s;
  };
  T s = row_sum(V);
  if (V == 2) s = add(s, row_sum(0));
  if (V == w - 1) s = add(s, row_sum(w + 1));
  return s;
}

// The gradient arriving at an instance norm, at pixel p (global index):
// stage 2 reads g; stage 1 reads dh1 = fold(dpad2).
template <int kStage, class T>
__device__ __forceinline__ T grad_at(const float* __restrict__ src, int p, int ch, int h, int w,
                                     int c) {
  if constexpr (kStage == 2) {
    return load<T>(src + (size_t)p * c + ch);
  } else {
    const int hw = h * w, b = p / hw, pix = p - b * hw, u = pix / w;
    return fold<T>(src, b, u, pix - u * w, ch, h, w, c);
  }
}

// ---------------------------------------------------------------------------
// GEMM operands for tc::gemm_tc_kernel
// ---------------------------------------------------------------------------

// dgrad: dpad[(b, U, V), ci] = sum_{tap, co} dz[b, U - dy, V - dx, co] * w[tap][ci][co]
struct DgradOp {
  static constexpr bool kNormRelu = false;
  static constexpr bool kTileStats = false;
  static constexpr int kTileN = BN;
  const float* dz;
  // W in HWIO, split into tf32 big and small parts: B(k = (tap, co), n = ci)
  // is K-major as it lies
  const float* wbig;
  const float* wsmall;
  float* dpad;
  int h, wd, c, rows;  // rows = N (H+2)(W+2)
  // per thread, for its A rows: the offset of (sample, U, V) as if it were
  // a pixel of dz, and U << 16 | V (U = 0x7fff past the last row)
  int m0, n0, kc;
  int roff[CHUNKS], ruv[CHUNKS];

  __device__ void setup(int tid) {
    m0 = blockIdx.x * BM;
    n0 = blockIdx.y * BN;
    kc = tc::kmajor_k(tid);
    const int wp = wd + 2, plane = (h + 2) * wp;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int m = m0 + tc::kmajor_row(tid, i);
      const int b = m / plane, r = m - b * plane;
      const int u = r / wp, v = r - u * wp;
      roff[i] = ((b * h + u) * wd + v) * c;
      ruv[i] = m < rows ? (u << 16) | v : 0x7fff0000;
    }
  }
  __device__ int ktiles() const { return 9 * c / BK; }
  __device__ void load(int kt, float* As, float* Bb, float* Bs, int tid) const {
    const int k0 = kt * BK;
    const int tap = k0 / c;
    const int co = k0 - tap * c + kc;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int shift = (dy * wd + dx) * c - co;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int si = (ruv[i] >> 16) - dy, sj = (ruv[i] & 0xffff) - dx;
      const bool valid = (unsigned)si < (unsigned)h && (unsigned)sj < (unsigned)wd;
      cp_async16(tc::kmajor_at(As, tc::kmajor_row(tid, i), kc), valid ? dz + (roff[i] - shift) : dz,
                 valid);
    }
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int nr = tc::kmajor_row(tid, i);
      const size_t src = ((size_t)tap * c + n0 + nr) * c + co;
      const int dst = tc::swizzled_off(nr, kc / 4);
      cp_async16(Bb + dst, wbig + src, true);
      cp_async16(Bs + dst, wsmall + src, true);
    }
  }
  template <class V>
  __device__ void write(int r, int col, V val) const {
    const int m = m0 + r;
    if (m < rows) *reinterpret_cast<V*>(dpad + (size_t)m * c + n0 + col) = val;
  }
};

// wgrad partial: part[s][tap*C + ci][co] = sum over the pixels p of split s
// of src'[b, reflect(u + dy - 1), reflect(v + dx - 1), ci] * dz[p, co], with
// src' = src, or relu((src - mu1) * rstd1) when kNorm (h1 from y1). Split s
// takes the K slices [s T / S, (s + 1) T / S) of the T = N*H*W / 32.
template <bool kNorm>
struct WgradOp {
  static constexpr bool kNormRelu = kNorm;
  static constexpr int kTileN = BN;
  const float* src;
  const float* stats;
  const float* dz;
  float* part;
  int h, w, c, ktiles_total, splits;
  // per thread
  int m0, n0, ci0, dy, dx, kt0, nkt, col;

  __device__ void setup(int tid) {
    m0 = blockIdx.x * BM;  // 128 rows (tap, ci) of one tap: C % 128 == 0
    n0 = blockIdx.y * BN;
    const int tap = m0 / c;
    ci0 = m0 - tap * c;
    dy = tap / 3;
    dx = tap - 3 * dy;
    const int s = blockIdx.z;
    kt0 = (int)((long long)s * ktiles_total / splits);
    nkt = (int)((long long)(s + 1) * ktiles_total / splits) - kt0;
    col = tc::mmajor_col(tid);
  }
  __device__ int ktiles() const { return nkt; }
  __device__ void load(int kt, float* As, float* Bs, int tid) const {
    // this thread's rows k = warp + 8 i (i < 4) are the warp's: lane l works
    // out the reflected source pixel of row warp + 8 (l % 4), shared by shuffles
    const int p0 = (kt0 + kt) * BK, kw = tid >> 5;
    int src_pix;
    {
      const int hw = h * w;
      const int p = p0 + kw + 8 * (tid & 3);
      const int b = p / hw, pix = p - b * hw;
      const int u = pix / w, v = pix - u * w;
      src_pix = (b * h + reflect(u + dy - 1, h)) * w + reflect(v + dx - 1, w);
    }
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int k = kw + 8 * i;
      const int sp = __shfl_sync(0xffffffffu, src_pix, i);
      cp_async16(tc::mmajor_at(As, k, col), src + (size_t)sp * c + ci0 + col, true);
      cp_async16(tc::mmajor_at(Bs, k, col), dz + (size_t)(p0 + k) * c + n0 + col, true);
    }
  }
  // a K slice never straddles two samples: H*W % 32 == 0
  __device__ int sample_of(int kt) const { return (kt0 + kt) * BK / (h * w); }
  __device__ void norm_params(int b, int r, float& mu, float& rs) const {
    const float* st = stats + (size_t)b * 4 * c + ci0 + r;
    mu = st[0];
    rs = st[c];
  }
  template <class V>
  __device__ void write(int r, int cl, V val) const {
    float* dst = part + ((size_t)blockIdx.z * 9 * c + m0 + r) * c + n0 + cl;
    *reinterpret_cast<V*>(dst) = val;
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
__global__ void in_bwd_partial_kernel(const float* __restrict__ gsrc, const float* __restrict__ y,
                                      const float* __restrict__ stats,
                                      float* __restrict__ part, int h, int w, int c) {
  const int tile = blockIdx.x;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const int m0 = tile * IN_TILE;
  const int b = m0 / (h * w);
  const float* st = stats + (size_t)b * 4 * c + (kStage == 2 ? 2 * c : 0) + ch;
  const float mu = st[0], rs = st[c];
  float s1 = 0.f, s2 = 0.f;
  for (int i = 0; i < IN_TILE; ++i) {
    float gv, yh;
    in_bwd_terms<kStage>(grad_at<kStage, float>(gsrc, m0 + i, ch, h, w, c),
                         y[(size_t)(m0 + i) * c + ch], mu, rs, gv, yh);
    s1 += gv;
    s2 = fmaf(gv, yh, s2);
  }
  float* p = part + (size_t)tile * 2 * c + ch;
  p[0] = s1;
  p[c] = s2;
}

// means (N, 2, C) = (mean(gv), mean(gv * yhat)): fixed-order fp64 merge.
// Blocks past merge_blocks split the weights w1, w2 (w4 float4s each) into
// wsplit = (w1 big, w1 small, w2 big, w2 small), for the dgrads' B operand.
__global__ void in_bwd_merge_kernel(const float* __restrict__ part, float* __restrict__ means,
                                    int n, int c, int tiles, int hw, int merge_blocks,
                                    const float4* __restrict__ w1, const float4* __restrict__ w2,
                                    uint4* __restrict__ wsplit, long long w4) {
  if ((int)blockIdx.x >= merge_blocks) {
    const long long i = (long long)(blockIdx.x - merge_blocks) * blockDim.x + threadIdx.x;
    if (i >= 2 * w4) return;
    const int which = (int)(i / w4);
    const long long e = i - which * w4;
    const float4 v = which ? w2[e] : w1[e];
    uint4 big, small;
    tc::split_tf32(v.x, big.x, small.x);
    tc::split_tf32(v.y, big.y, small.y);
    tc::split_tf32(v.z, big.z, small.z);
    tc::split_tf32(v.w, big.w, small.w);
    wsplit[(2 * which) * w4 + e] = big;
    wsplit[(2 * which + 1) * w4 + e] = small;
    return;
  }
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
__global__ void in_bwd_apply_kernel(const float* __restrict__ gsrc, const float4* __restrict__ y,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, float4* __restrict__ dz,
                                    long long total4, int h, int w, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long e = i * 4;
  const int p = (int)(e / c);
  const int ch = (int)(e - (long long)p * c);
  const int b = p / (h * w);
  const float* mu = stats + (size_t)b * 4 * c + (kStage == 2 ? 2 * c : 0) + ch;
  const float* rs = mu + c;
  const float* m1 = means + (size_t)b * 2 * c + ch;
  const float* m2 = m1 + c;
  const float4 gv4 = grad_at<kStage, float4>(gsrc, p, ch, h, w, c), yv4 = y[i];
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

// out = sum over the splits of part, in split order; float4-wide
__device__ __forceinline__ void split_sum(const float4* __restrict__ part, float4* __restrict__ out,
                                          long long i, long long total4, int splits) {
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) s = add(s, part[(size_t)k * total4 + i]);
  out[i] = s;
}

__global__ void split_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                 long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total4) split_sum(part, out, i, total4, splits);
}

// 12: blocks [0, fold_blocks) write dx = g + fold(dpad1), the rest dW1
__global__ void finish_kernel(const float* __restrict__ g, const float* __restrict__ dpad,
                              float4* __restrict__ dx, const float4* __restrict__ part,
                              float4* __restrict__ dw, long long total4_x, long long total4_w,
                              int splits, int fold_blocks, int h, int w, int c) {
  if ((int)blockIdx.x < fold_blocks) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total4_x) return;
    const long long e = i * 4;
    const int p = (int)(e / c);
    const int ch = (int)(e - (long long)p * c);
    dx[i] = add(load<float4>(g + e), grad_at<1, float4>(dpad, p, ch, h, w, c));
  } else {
    const long long i = (long long)(blockIdx.x - fold_blocks) * blockDim.x + threadIdx.x;
    if (i < total4_w) split_sum(part, dw, i, total4_w, splits);
  }
}

// 1-3 / 7-9
template <int kStage>
cudaError_t in_bwd(const float* gsrc, const float* y, const float* stats, float* part,
                   float* means, float* dz, int n, int h, int w, int c, cudaStream_t stream,
                   const float* w1 = nullptr, const float* w2 = nullptr, float* wsplit = nullptr) {
  const int hw = h * w, tiles = hw / IN_TILE;
  in_bwd_partial_kernel<kStage><<<dim3((unsigned)(n * tiles), (unsigned)(c / 128)), 128, 0, stream>>>(
      gsrc, y, stats, part, h, w, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (n * c + 255) / 256;
  const long long w4 = w1 ? (long long)9 * c * c / 4 : 0;
  in_bwd_merge_kernel<<<(unsigned)(merge_blocks + (2 * w4 + 255) / 256), 256, 0, stream>>>(
      part, means, n, c, tiles, hw, merge_blocks, reinterpret_cast<const float4*>(w1),
      reinterpret_cast<const float4*>(w2), reinterpret_cast<uint4*>(wsplit), w4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total4 = (long long)n * hw * c / 4;
  in_bwd_apply_kernel<kStage><<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      gsrc, reinterpret_cast<const float4*>(y), stats, means, reinterpret_cast<float4*>(dz),
      total4, h, w, c);
  return cudaGetLastError();
}

// 4 / 10: the split-K partials of a weight gradient
template <bool kNorm>
cudaError_t wgrad(const float* src, const float* stats, const float* dz, float* part, int n, int h,
                  int w, int c, int splits, cudaStream_t stream) {
  WgradOp<kNorm> op;
  op.src = src;
  op.stats = stats;
  op.dz = dz;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.ktiles_total = n * h * w / BK;
  op.splits = splits;
  return tc::launch_wgmma_mn(op, dim3((unsigned)(9 * c / BM), (unsigned)(c / BN), (unsigned)splits),
                            stream);
}

// 6 / 11
cudaError_t dgrad(const float* dz, const float* wsplit, float* dpad, int n, int h, int wd, int c,
                  cudaStream_t stream) {
  DgradOp op;
  op.dz = dz;
  op.wbig = wsplit;
  op.wsmall = wsplit + (size_t)9 * c * c;
  op.dpad = dpad;
  op.h = h;
  op.wd = wd;
  op.c = c;
  op.rows = n * (h + 2) * (wd + 2);
  return tc::launch_wgmma(op, dim3((unsigned)((op.rows + BM - 1) / BM), (unsigned)(c / BN)), stream);
}

}  // namespace

extern "C" int nemar_resblock_bwd(const float* x, const float* y1, const float* y2,
                                  const float* stats, const float* g, const float* w1,
                                  const float* w2, float* wsplit, float* dz, float* dpad, float* part_in,
                                  float* means, float* part_w, float* dw1, float* dw2, float* dx,
                                  int n, int h, int w, int c, int splits, cudaStream_t stream) {
  cudaError_t err;
  const long long total4_w = (long long)9 * c * c / 4;
  const unsigned sum_blocks = (unsigned)((total4_w + 255) / 256);
  // stage 2: through IN2 and conv2 -> dW2, dpad2
  if ((err = in_bwd<2>(g, y2, stats, part_in, means, dz, n, h, w, c, stream, w1, w2, wsplit)) != cudaSuccess) return (int)err;
  if ((err = wgrad<true>(y1, stats, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  split_sum_kernel<<<sum_blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part_w),
                                                   reinterpret_cast<float4*>(dw2), total4_w, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = dgrad(dz, wsplit + (size_t)18 * c * c, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  // stage 1: through the fold, relu, IN1 and conv1 -> dW1, dx = g + fold(dpad1)
  if ((err = in_bwd<1>(dpad, y1, stats, part_in, means, dz, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  if ((err = wgrad<false>(x, stats, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  if ((err = dgrad(dz, wsplit, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  const long long total4_x = (long long)n * h * w * c / 4;
  const int fold_blocks = (int)((total4_x + 255) / 256);
  finish_kernel<<<(unsigned)fold_blocks + sum_blocks, 256, 0, stream>>>(
      g, dpad, reinterpret_cast<float4*>(dx), reinterpret_cast<const float4*>(part_w),
      reinterpret_cast<float4*>(dw1), total4_x, total4_w, splits, fold_blocks, h, w, c);
  return (int)cudaGetLastError();
}
