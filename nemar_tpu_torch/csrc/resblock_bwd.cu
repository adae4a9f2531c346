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
// A sample's pixels need not fill whole tiles: the instance-norm partials
// (64 pixels) and the wgrads' K slices (32 pixels) are counted per sample,
// and a sample's last one is masked (its rows past H*W are zero-filled in
// both wgrad operands, so they add nothing). Where H*W is a multiple of 32
// (of 64 for the partials) they are plain pixel ranges, walked by the
// unmasked loops.
//
// Layouts: x, y1, y2, g, dz, dx (N, H, W, C) fp32; dpad (N, H+2, W+2, C);
// stats (N, 4, C) = (mu1, rstd1, mu2, rstd2), the forward's; w1, w2, dw1,
// dw2 (3, 3, C_in, C_out) HWIO; wsplit (4, 9C, C) = (W1 big, W1 small, W2
// big, W2 small); part_in (N*ceil(H*W/64), 2, C); means (N, 2, C); part_w
// (SPLITS, 9C, C). Requirements (checked by the wrapper): C % 128 == 0,
// H, W >= 2, 16-byte aligned pointers, N (H+2)(W+2) C < 2^31 (32-bit
// offsets in the dgrad's loader).
//
// The bf16 variant (--bf16; nemar_resblock_bwd_bf16) is the same backward
// with bf16 operands, from the bf16 K-block's saved y1hat, h1 (bf16) and
// y2, stats (fp32). It rounds where the TPU kernels store the compute
// dtype (conv_fused.py:_bwd2_kernel_kstack, _bwd1_kernel_kstack): dz2, dh1
// = fold(dpad2) as the IN1 backward reads it, dz1 and dx to bf16, and
// dW1, dW2 to the weights' bf16; the sums, dpad and the partials stay fp32.
//
// What bounds it: arithmetic, 154.6 GFLOP a b8 call at 989 TFLOP/s = 0.156
// ms, against ~0.45 GB of IN passes and partials (0.13 ms at 3.35 TB/s).
// The design: the four GEMMs on the bf16 core (gemm_tc.cuh:
// warp-specialised, persistent, one slice's MMAs in flight); the wgrads'
// operands as TMA boxes (dz, and reflect-padded copies of x and h1 written
// by one pad launch where a 64-pixel K slice is image rows: slice_boxes),
// the dgrads' B (W as it lies) as boxes and their A (dz shifted by the tap
// over the padded domain, no box) as the producer's copies; the IN
// backward's merge eight loads deep (in_bwd_merge16_kernel); dW2's split
// sum in the last launch beside dW1's. Twelve launches (eleven without the
// pad):
//
//   1.     x and h1 -> their reflect-padded copies;
//   2-4.   dz2 as 1-3 above (partials, merge, apply);
//   5.     dW2's split-K partials (from h1, dz2);
//   6.     dpad2 from dz2 and W2;
//   7-9.   dz1 from gh = dh1 * (y1hat > 0), dh1 = fold(dpad2);
//   10.    dW1's partials (from x, dz1);
//   11.    dpad1 from dz1 and W1;
//   12.    dx = g + fold(dpad1), dW1 and dW2 = the fixed-order sums of
//          their partials.
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
using bf16 = __nv_bfloat16;

// V = float (one value) or float4 (4 adjacent ones) of an fp32 or a bf16
// tensor, in fp32 registers
template <class V>
__device__ __forceinline__ V load(const float* p) { return *reinterpret_cast<const V*>(p); }
template <class V>
__device__ __forceinline__ V load(const bf16* p) {
  if constexpr (std::is_same_v<V, float>) {
    return tc::load1(p);
  } else {
    return tc::load4(p);
  }
}

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
// stage 2 reads g (S = the element type); stage 1 reads dh1 = fold(dpad2).
template <int kStage, class V, class S>
__device__ __forceinline__ V grad_at(const S* __restrict__ src, int p, int ch, int h, int w,
                                     int c) {
  if constexpr (kStage == 2) {
    return load<V>(src + (size_t)p * c + ch);
  } else {
    const int hw = h * w, b = p / hw, pix = p - b * hw, u = pix / w;
    return fold<V>(src, b, u, pix - u * w, ch, h, w, c);
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
// src' = src, or relu((src - mu1) * rstd1) when kNorm (h1 from y1). K slice
// k is the 32 pixels from (k % kps) * 32 of sample k / kps (kps = ceil(H*W /
// 32) a sample; rows past the sample are zeros, which only kTail, H*W not a
// multiple of 32, has to mask). Split s takes the K slices [s T / S, (s + 1)
// T / S) of the T = N * kps. kHp (the band form): src holds each sample's
// H + 2 rows, its halo rows already in place, read at row u + dy (only W is
// reflected).
template <bool kNorm, bool kTail, bool kHp = false>
struct WgradOp {
  static constexpr bool kNormRelu = kNorm;
  static constexpr int kTileN = BN;
  const float* src;
  const float* stats;
  const float* dz;
  float* part;
  int h, w, c, kps, ktiles_total, splits;
  // per thread
  int m0, n0, ci0, dy, dx, kt0, nkt, col;

  // the source row of output row u at tap row dy, and a sample's source rows
  __device__ int src_row(int u) const { return kHp ? u + dy : reflect(u + dy - 1, h); }
  __device__ int src_rows() const { return kHp ? h + 2 : h; }

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
    // out the reflected source pixel of row warp + 8 (l % 4), shared by
    // shuffles (-1 past the sample: both operands' rows are zero-filled)
    const int hw = h * w, kw = tid >> 5;
    if constexpr (!kTail) {
      const int p0 = (kt0 + kt) * BK;
      int src_pix;
      {
        const int p = p0 + kw + 8 * (tid & 3);
        const int b = p / hw, pix = p - b * hw;
        const int u = pix / w, v = pix - u * w;
        src_pix = (b * src_rows() + src_row(u)) * w + reflect(v + dx - 1, w);
      }
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int k = kw + 8 * i;
        const int sp = __shfl_sync(0xffffffffu, src_pix, i);
        cp_async16(tc::mmajor_at(As, k, col), src + (size_t)sp * c + ci0 + col, true);
        cp_async16(tc::mmajor_at(Bs, k, col), dz + (size_t)(p0 + k) * c + n0 + col, true);
      }
    } else {
      const int slice = kt0 + kt, b = slice / kps;
      const int q0 = (slice - b * kps) * BK;
      int src_pix;
      {
        const int pix = q0 + kw + 8 * (tid & 3);
        const int u = pix / w, v = pix - u * w;
        src_pix = pix < hw ? (b * src_rows() + src_row(u)) * w + reflect(v + dx - 1, w) : -1;
      }
      const float* dzb = dz + ((size_t)b * hw + q0) * c + n0 + col;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int k = kw + 8 * i;
        const int sp = __shfl_sync(0xffffffffu, src_pix, i);
        const bool valid = sp >= 0;
        cp_async16(tc::mmajor_at(As, k, col), valid ? src + (size_t)sp * c + ci0 + col : src,
                   valid);
        cp_async16(tc::mmajor_at(Bs, k, col), valid ? dzb + (size_t)k * c : dz, valid);
      }
    }
  }
  // a K slice never straddles two samples: each sample's slices are its own
  __device__ int sample_of(int kt) const { return (kt0 + kt) / kps; }
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
// per (n, c), T the element type of the block's activations (float, or bf16
// in the bf16 variant), the arithmetic fp32.
//   kStage 2: gv = g (T), yhat = (y2 - mu2) * rstd2 (y2 fp32 in both).
//   kStage 1: gv = dh1 * (yhat > 0), dh1 = fold(dpad2) rounded to T (the
//             TPU kernel stores dh1 in the compute dtype); yhat = (y1 - mu1)
//             * rstd1 from fp32's y1, the bf16 variant's saved y1hat as it is.
// G and Y: the types of the gradient's source and of y at each stage.
// ---------------------------------------------------------------------------
template <int kStage, class T>
using InG = std::conditional_t<kStage == 2, T, float>;
template <int kStage, class T>
using InY = std::conditional_t<kStage == 1, T, float>;

template <int kStage, class T, class V>
__device__ __forceinline__ V in_grad(const InG<kStage, T>* __restrict__ src, int p, int ch, int h,
                                     int w, int c) {
  const V v = grad_at<kStage, V>(src, p, ch, h, w, c);
  if constexpr (kStage == 1) {
    return tc::rounded<T>(v);
  } else {
    return v;
  }
}

template <int kStage, class T>
__device__ __forceinline__ void in_bwd_terms(float gin, float yv, float mu, float rs,
                                             float& gv, float& yh) {
  yh = (kStage == 1 && !std::is_same_v<T, float>) ? yv : (yv - mu) * rs;
  gv = (kStage == 1 && !(yh > 0.f)) ? 0.f : gin;
}

// One block per (64-pixel tile, 128-channel block), one thread per channel;
// tile t of sample b covers its pixels [t * 64, min((t + 1) * 64, H*W)).
template <int kStage, class T>
__global__ void in_bwd_partial_kernel(const InG<kStage, T>* __restrict__ gsrc,
                                      const InY<kStage, T>* __restrict__ y,
                                      const float* __restrict__ stats,
                                      float* __restrict__ part, int h, int w, int c, int tiles) {
  const int tile = blockIdx.x;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const int hw = h * w, b = tile / tiles, t = tile - b * tiles;
  const int m0 = b * hw + t * IN_TILE, count = min(IN_TILE, hw - t * IN_TILE);
  const float* st = stats + (size_t)b * 4 * c + (kStage == 2 ? 2 * c : 0) + ch;
  const float mu = st[0], rs = st[c];
  float s1 = 0.f, s2 = 0.f;
  // PIX pixels' loads issued together (the fold's are conditional: the
  // compiler would not hoist them), then added in pixel order
  constexpr int PIX = 8;
  auto add_pixels = [&](int i0, int n) {
    float gin[PIX], yin[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (k < n) {
        gin[k] = in_grad<kStage, T, float>(gsrc, m0 + i0 + k, ch, h, w, c);
        yin[k] = tc::load1(y + (size_t)(m0 + i0 + k) * c + ch);
      }
    }
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (k < n) {
        float gv, yh;
        in_bwd_terms<kStage, T>(gin[k], yin[k], mu, rs, gv, yh);
        s1 += gv;
        s2 = fmaf(gv, yh, s2);
      }
    }
  };
  // a whole tile with a fixed trip count (the compiler unrolls it), else the
  // sample's tail: the same pixels in the same order either way
  if (count == IN_TILE) {
    for (int i = 0; i < IN_TILE; i += PIX) add_pixels(i, PIX);
  } else {
    for (int i = 0; i < count; i += PIX) add_pixels(i, min(PIX, count - i));
  }
  float* p = part + (size_t)tile * 2 * c + ch;
  p[0] = s1;
  p[c] = s2;
}

// means (N, 2, C) = (mean(gv), mean(gv * yhat)): fixed-order fp64 merge.
// Blocks past merge_blocks split the weights w1, w2 (w4 float4s each) into
// wsplit = (w1 big, w1 small, w2 big, w2 small), for the dgrads' B operand.
// The band form (--mesh_spatial) merges every rank's partials, `ranks`
// blocks `rank_stride` floats apart, rank by rank (tiles the largest
// band's, a smaller band's partials zero past its own); pixels is then the
// frame's.
__global__ void in_bwd_merge_kernel(const float* __restrict__ part, float* __restrict__ means,
                                    int n, int c, int tiles, long long pixels, int merge_blocks,
                                    const float4* __restrict__ w1, const float4* __restrict__ w2,
                                    uint4* __restrict__ wsplit, long long w4, int ranks,
                                    long long rank_stride) {
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
  double s1 = 0.0, s2 = 0.0;
  for (int r = 0; r < ranks; ++r) {
    const float* p = part + (size_t)r * rank_stride + (size_t)b * tiles * 2 * c + ch;
    for (int t = 0; t < tiles; ++t) {
      s1 += (double)p[(size_t)t * 2 * c];
      s2 += (double)p[(size_t)t * 2 * c + c];
    }
  }
  float* m = means + (size_t)b * 2 * c + ch;
  m[0] = (float)(s1 / pixels);
  m[c] = (float)(s2 / pixels);
}

template <int kStage, class T>
__global__ void in_bwd_apply_kernel(const InG<kStage, T>* __restrict__ gsrc,
                                    const InY<kStage, T>* __restrict__ y,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, T* __restrict__ dz,
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
  const float4 gv4 = in_grad<kStage, T, float4>(gsrc, p, ch, h, w, c), yv4 = tc::load4(y + e);
  const float gin[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
  const float yin[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float gv, yh;
    in_bwd_terms<kStage, T>(gin[k], yin[k], mu[k], rs[k], gv, yh);
    o[k] = rs[k] * (gv - m1[k] - yh * m2[k]);
  }
  tc::store4(dz + e, make_float4(o[0], o[1], o[2], o[3]));
}

// out = sum over the splits of part, in split order, float4-wide; stored
// as T (rounded to bf16 in the bf16 variant)
template <class T>
__device__ __forceinline__ void split_sum(const float4* __restrict__ part, T* __restrict__ out,
                                          long long i, long long total4, int splits) {
  float4 s = part[i];
#pragma unroll 4
  for (int k = 1; k < splits; ++k) s = add(s, part[(size_t)k * total4 + i]);
  tc::store4(out + 4 * i, s);
}

template <class T>
__global__ void split_sum_kernel(const float4* __restrict__ part, T* __restrict__ out,
                                 long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total4) split_sum(part, out, i, total4, splits);
}

// 12: blocks [0, fold_blocks) write dx = g + fold(dpad1), the rest dW1
template <class T>
__global__ void finish_kernel(const T* __restrict__ g, const float* __restrict__ dpad,
                              T* __restrict__ dx, const float4* __restrict__ part,
                              T* __restrict__ dw, long long total4_x, long long total4_w,
                              int splits, int fold_blocks, int h, int w, int c) {
  if ((int)blockIdx.x < fold_blocks) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total4_x) return;
    const long long e = i * 4;
    const int p = (int)(e / c);
    const int ch = (int)(e - (long long)p * c);
    tc::store4(dx + e, add(load<float4>(g + e), grad_at<1, float4>(dpad, p, ch, h, w, c)));
  } else {
    const long long i = (long long)(blockIdx.x - fold_blocks) * blockDim.x + threadIdx.x;
    if (i < total4_w) split_sum(part, dw, i, total4_w, splits);
  }
}

// 1-3 / 7-9 (the fp32 backward's merge also splits W1 and W2)
template <int kStage, class T>
cudaError_t in_bwd(const InG<kStage, T>* gsrc, const InY<kStage, T>* y, const float* stats,
                   float* part, float* means, T* dz, int n, int h, int w, int c,
                   cudaStream_t stream, const float* w1 = nullptr, const float* w2 = nullptr,
                   float* wsplit = nullptr) {
  const int hw = h * w, tiles = (hw + IN_TILE - 1) / IN_TILE;
  in_bwd_partial_kernel<kStage, T><<<dim3((unsigned)(n * tiles), (unsigned)(c / 128)), 128, 0, stream>>>(
      gsrc, y, stats, part, h, w, c, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (n * c + 255) / 256;
  const long long w4 = w1 ? (long long)9 * c * c / 4 : 0;
  in_bwd_merge_kernel<<<(unsigned)(merge_blocks + (2 * w4 + 255) / 256), 256, 0, stream>>>(
      part, means, n, c, tiles, hw, merge_blocks, reinterpret_cast<const float4*>(w1),
      reinterpret_cast<const float4*>(w2), reinterpret_cast<uint4*>(wsplit), w4, 1, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total4 = (long long)n * hw * c / 4;
  in_bwd_apply_kernel<kStage, T><<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      gsrc, y, stats, means, dz, total4, h, w, c);
  return cudaGetLastError();
}

// 4 / 10: the split-K partials of a weight gradient
template <bool kNorm, bool kTail, bool kHp = false>
cudaError_t wgrad_op(const float* src, const float* stats, const float* dz, float* part, int n,
                     int h, int w, int c, int splits, cudaStream_t stream) {
  WgradOp<kNorm, kTail, kHp> op;
  op.src = src;
  op.stats = stats;
  op.dz = dz;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.kps = (h * w + BK - 1) / BK;
  op.ktiles_total = n * op.kps;
  op.splits = splits;
  return tc::launch_wgmma_mn(op, dim3((unsigned)(9 * c / BM), (unsigned)(c / BN), (unsigned)splits),
                            stream);
}

template <bool kNorm, bool kHp = false>
cudaError_t wgrad(const float* src, const float* stats, const float* dz, float* part, int n, int h,
                  int w, int c, int splits, cudaStream_t stream) {
  return (h * w) % BK
             ? wgrad_op<kNorm, true, kHp>(src, stats, dz, part, n, h, w, c, splits, stream)
             : wgrad_op<kNorm, false, kHp>(src, stats, dz, part, n, h, w, c, splits, stream);
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

// ---------------------------------------------------------------------------
// bf16 variant (nemar_resblock_bwd_bf16): its GEMM operands; the
// instance-norm backwards, split sums and finish are the templates above
// ---------------------------------------------------------------------------
// wgrad partial, bf16 operands: part[s][tap*C + ci][co] = sum over the
// pixels of split s of src[b, reflect(u + dy - 1), reflect(v + dx - 1), ci]
// * dz[p, co]. K slice k is the 64 pixels from (k % kps) * 64 of sample
// k / kps (kps = ceil(H*W / 64)); rows past the sample are zeros. Both
// operands are pixel-major, read by wgmma as they lie (MN-major). B (dz, as
// (N, H W, C)) is two TMA boxes of 64 channels x 64 pixels, zeros past the
// sample; A is two (tma_a: the reflect-padded source, (N, H + 2, W + 2, C),
// the slice's pixels whole image rows or part of one: W divides 64 or 64
// divides W) or the producer's cp.async copies from src, reflected in the
// index and zero-filled past the sample. kHp (the band form): src holds
// each sample's H + 2 rows, its halo rows in place, read at row u + dy.
template <bool kHp = false>
struct WgradOp16 : tc::Bf16Loads {
  static constexpr bool kMN = true;
  static constexpr bool kTileStats = false;
  static constexpr int kTileN = BN;
  const bf16* src;
  float* part;
  int h, w, c, kps, ktiles_total, splits;
  int m0, n0, ci0, dy, dx, kt0, nkt, split;

  __device__ void setup(int, uint3 blk) {
    m0 = blk.x * BM;  // 128 rows (tap, ci) of one tap: C % 128 == 0
    n0 = blk.y * BN;
    const int tap = m0 / c;
    ci0 = m0 - tap * c;
    dy = tap / 3;
    dx = tap - 3 * dy;
    split = blk.z;
    kt0 = (int)((long long)split * ktiles_total / splits);
    nkt = (int)((long long)(split + 1) * ktiles_total / splits) - kt0;
  }
  __device__ int ktiles() const { return nkt; }
  // A by cp.async (tma_a false)
  __device__ void load(int kt, unsigned char* As, unsigned char*, int ptid) const {
    const int slice = kt0 + kt, b = slice / kps, hw = h * w;
    const int q0 = (slice - b * kps) * tc::BK16;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int q = ptid + tc::PTHREADS * i, k = q >> 4, ch = 8 * (q & 15);
      const int pix = q0 + k;
      const bool valid = pix < hw;
      const int u = pix / w, v = pix - u * w;
      const size_t sp = kHp ? ((size_t)b * (h + 2) + u + dy) * w + reflect(v + dx - 1, w)
                            : ((size_t)b * h + reflect(u + dy - 1, h)) * w + reflect(v + dx - 1, w);
      tc::cp_async16b(As + tc::mn16(k, q & 15), valid ? src + sp * c + ci0 + ch : src, valid);
    }
  }
  // B from dz (maps.b); with tma_a, A from the padded source (maps.a) at
  // pixel (u0 + dy, v0 + dx): 64 channels each
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    const int slice = kt0 + kt, b = slice / kps;
    const int q0 = (slice - b * kps) * tc::BK16;
    if (tma_a) {
      const int u0 = q0 / w, v0 = q0 - u0 * w;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tc::tma_load(As + 8192 * j, &maps.a, bar, ci0 + 64 * j, v0 + dx, u0 + dy, b);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) tc::tma_load(Bs + 8192 * j, &maps.b, bar, n0 + 64 * j, q0, b);
  }
  __device__ void write(int r, int cl, float2 val) const {
    tc::store2(part + ((size_t)split * 9 * c + m0 + r) * c + n0 + cl, val);
  }
};

// dgrad, bf16 operands: dpad[(b, U, V), ci] = sum_{tap, co} dz[b, U - dy, V - dx, co]
// * w[tap][ci][co], dpad fp32. B (W in HWIO, K-major along co) is a TMA
// box. A is dz shifted by the tap, zero off the frame: with tma_a (W a
// multiple of 64) the output domain is cut into boxes, so that A is a TMA
// box of dz with the frame's zeros its out-of-bounds fill: a sample's
// main tiles, two padded rows U0, U0 + 1 by 64 columns V0 .. V0 + 63 (box
// 64 x 64 x 2 at (V0 - dx, U0 - dy)), then its edge tiles, 64 padded rows
// by the columns W, W + 1 (box 64 x 2 x 64 at (W - dx, U0 - dy), maps.a2);
// otherwise a tile is 128 consecutive pixels of the padded domain (rows of
// W + 2 pixels: no box) and A is the producer's cp.async copies.
struct DgradOp16 : tc::Bf16Loads {
  static constexpr bool kMN = false;
  static constexpr bool kTileStats = false;
  static constexpr int kTileN = BN;
  const bf16* dz;
  float* dpad;
  int h, wd, c, rows;
  int main_tiles, sample_tiles;  // tma_a: a sample's main tiles, and with its edge tiles
  int m0, n0, kc;
  int b, u0, v0;  // tma_a: the tile's sample, first padded row and column
  bool edge;
  int roff[tc::PCHUNKS], ruv[tc::PCHUNKS];

  __device__ void setup(int ptid, uint3 blk) {
    n0 = blk.y * BN;
    if (tma_a) {
      b = blk.x / sample_tiles;
      const int t = blk.x - b * sample_tiles;
      edge = t >= main_tiles;
      if (edge) {
        u0 = 64 * (t - main_tiles);
        v0 = wd;
      } else {
        const int wb = wd / 64, rp = t / wb;
        u0 = 2 * rp;
        v0 = 64 * (t - rp * wb);
      }
      return;
    }
    m0 = blk.x * BM;
    kc = ptid & 7;
    const int wp = wd + 2, plane = (h + 2) * wp;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int m = m0 + tc::prow(ptid, i);
      const int bb = m / plane, r = m - bb * plane;
      const int u = r / wp, v = r - u * wp;
      roff[i] = ((bb * h + u) * wd + v) * c;
      ruv[i] = m < rows ? (u << 16) | v : 0x7fff0000;
    }
  }
  __device__ int ktiles() const { return 9 * c / tc::BK16; }
  // A by cp.async (tma_a false)
  __device__ void load(int kt, unsigned char* As, unsigned char*, int ptid) const {
    const int k0 = kt * tc::BK16;
    const int tap = k0 / c;
    const int co = k0 - tap * c + 8 * kc;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int shift = (dy * wd + dx) * c - co;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int si = (ruv[i] >> 16) - dy, sj = (ruv[i] & 0xffff) - dx;
      const bool valid = (unsigned)si < (unsigned)h && (unsigned)sj < (unsigned)wd;
      tc::cp_async16b(As + tc::swz16(tc::prow(ptid, i), kc), valid ? dz + (roff[i] - shift) : dz,
                      valid);
    }
  }
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    const int k0 = kt * tc::BK16;
    const int tap = k0 / c, co = k0 - tap * c;
    if (tma_a) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      tc::tma_load(As, edge ? &maps.a2 : &maps.a, bar, co, v0 - dx, u0 - dy, b);
    }
    tc::tma_load(Bs, &maps.b, bar, co, tap * c + n0);
  }
  __device__ void write(int r, int col, float2 val) const {
    if (tma_a) {
      const int u = u0 + (edge ? r >> 1 : r >> 6), v = v0 + (edge ? r & 1 : r & 63);
      if (u < h + 2)
        tc::store2(dpad + (((size_t)b * (h + 2) + u) * (wd + 2) + v) * c + n0 + col, val);
      return;
    }
    const int m = m0 + r;
    if (m < rows) tc::store2(dpad + (size_t)m * c + n0 + col, val);
  }
};

// 4 / 9: a weight gradient's split-K partials; A from the padded source pad
// by TMA where given, else copied from src
template <bool kHp = false>
cudaError_t wgrad16(const bf16* src, const bf16* pad, const bf16* dz, float* part, int n, int h,
                    int w, int c, int splits, cudaStream_t stream) {
  WgradOp16<kHp> op;
  op.src = src;
  op.part = part;
  op.h = h;
  op.w = w;
  op.c = c;
  op.kps = (h * w + tc::BK16 - 1) / tc::BK16;
  op.ktiles_total = n * op.kps;
  op.splits = splits;
  op.tma_b = true;
  op.tma_a = pad != nullptr;
  tc::TmaMaps maps{};
  cudaError_t err = cudaSuccess;
  if (op.ktiles_total > 0) {  // an empty band loads nothing
    err = tc::pixels_map(&maps.b, dz, n, h * w, c);
    if (err == cudaSuccess && pad != nullptr) {
      const int bw = min(w, tc::BK16);
      err = tc::image_map(&maps.a, pad, n, h + 2, w + 2, c, bw, tc::BK16 / bw);
    }
  }
  if (err != cudaSuccess) return err;
  return tc::launch_bf16(op, dim3((unsigned)(9 * c / BM), (unsigned)(c / BN), (unsigned)splits),
                         stream, maps);
}

// 5 / 10: dz's boxes where W is a multiple of 64 (and the band not empty)
cudaError_t dgrad16(const bf16* dz, const bf16* w, float* dpad, int n, int h, int wd, int c,
                    cudaStream_t stream) {
  DgradOp16 op;
  op.dz = dz;
  op.dpad = dpad;
  op.h = h;
  op.wd = wd;
  op.c = c;
  op.rows = n * (h + 2) * (wd + 2);
  op.tma_b = true;
  op.tma_a = wd % 64 == 0 && h > 0;
  op.main_tiles = (h + 3) / 2 * (wd / 64);
  op.sample_tiles = op.main_tiles + (h + 2 + 63) / 64;
  tc::TmaMaps maps{};
  cudaError_t err = tc::weight_map(&maps.b, w, c, BN);
  if (err == cudaSuccess && op.tma_a) err = tc::image_map(&maps.a, dz, n, h, wd, c, 64, 2);
  if (err == cudaSuccess && op.tma_a) err = tc::image_map(&maps.a2, dz, n, h, wd, c, 2, 64);
  if (err != cudaSuccess) return err;
  const int mtiles = op.tma_a ? n * op.sample_tiles : (op.rows + BM - 1) / BM;
  return tc::launch_bf16(op, dim3((unsigned)mtiles, (unsigned)(c / BN)), stream, maps);
}

// whether a 64-pixel K slice of a W-wide frame is a box of whole image rows
// (or of part of one): W divides 64 or 64 divides W
inline bool slice_boxes(int w) { return w % tc::BK16 == 0 || tc::BK16 % w == 0; }

// 1: the reflect-padded copies (N, H + 2, W + 2, C) of x and h1, 8 channels
// a thread
__global__ void pad16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h1,
                             bf16* __restrict__ pads, long long chunks, int h, int w, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * chunks) return;
  const int which = i >= chunks;
  const long long e = (i - which * chunks) * 8;
  const int ch = (int)(e % c);
  const long long pix = e / c;
  const int v = (int)(pix % (w + 2));
  const long long r = pix / (w + 2);
  const int u = (int)(r % (h + 2)), b = (int)(r / (h + 2));
  const bf16* src = which ? h1 : x;
  *reinterpret_cast<uint4*>(pads + which * chunks * 8 + e) = *reinterpret_cast<const uint4*>(
      src + (((size_t)b * h + reflect(u - 1, h)) * w + reflect(v - 1, w)) * c + ch);
}

// 3 / 8's merge: means (N, 2, C) = (mean(gv), mean(gv * yhat)) from the
// sample's partials in fp64: a block takes 32 channels of one sample, its
// warp j summing the tiles t = j (mod 8) in tile order, then the 8 sums are
// added in warp order (a fixed order)
__global__ void in_bwd_merge16_kernel(const float* __restrict__ part, float* __restrict__ means,
                                      int c, int tiles, long long pixels) {
  __shared__ double red[2][8][32];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  const int b = idx / c, ch = idx - b * c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double s1 = 0.0, s2 = 0.0;
  for (int t = j; t < tiles; t += 8) {
    s1 += (double)p[(size_t)t * 2 * c];
    s2 += (double)p[(size_t)t * 2 * c + c];
  }
  red[0][j][lane] = s1;
  red[1][j][lane] = s2;
  __syncthreads();
  if (j == 0) {
    s1 = s2 = 0.0;
    for (int k = 0; k < 8; ++k) {
      s1 += red[0][k][lane];
      s2 += red[1][k][lane];
    }
    float* m = means + (size_t)b * 2 * c + ch;
    m[0] = (float)(s1 / pixels);
    m[c] = (float)(s2 / pixels);
  }
}

// 2-3 / 6-8: the IN backward's partials, merge and apply at bf16
template <int kStage>
cudaError_t in_bwd16(const InG<kStage, bf16>* gsrc, const InY<kStage, bf16>* y,
                     const float* stats, float* part, float* means, bf16* dz, int n, int h, int w,
                     int c, cudaStream_t stream) {
  const int hw = h * w, tiles = (hw + IN_TILE - 1) / IN_TILE;
  in_bwd_partial_kernel<kStage, bf16><<<dim3((unsigned)(n * tiles), (unsigned)(c / 128)), 128, 0,
                                        stream>>>(gsrc, y, stats, part, h, w, c, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_merge16_kernel<<<(unsigned)(n * c / 32), 256, 0, stream>>>(part, means, c, tiles, hw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total4 = (long long)n * hw * c / 4;
  in_bwd_apply_kernel<kStage, bf16><<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      gsrc, y, stats, means, dz, total4, h, w, c);
  return cudaGetLastError();
}

// 11: blocks [0, fold_blocks) write dx = g + fold(dpad1), the next
// sum_blocks dW1 = the sum of part1's splits, the last dW2 = part2's
__global__ void finish16_kernel(const bf16* __restrict__ g, const float* __restrict__ dpad,
                                bf16* __restrict__ dx, const float4* __restrict__ part1,
                                bf16* __restrict__ dw1, const float4* __restrict__ part2,
                                bf16* __restrict__ dw2, long long total4_x, long long total4_w,
                                int splits, int fold_blocks, int sum_blocks, int h, int w,
                                int c) {
  const int blk = blockIdx.x;
  if (blk < fold_blocks) {
    const long long i = (long long)blk * blockDim.x + threadIdx.x;
    if (i >= total4_x) return;
    const long long e = i * 4;
    const int p = (int)(e / c);
    const int ch = (int)(e - (long long)p * c);
    tc::store4(dx + e, add(load<float4>(g + e), grad_at<1, float4>(dpad, p, ch, h, w, c)));
    return;
  }
  const int second = blk >= fold_blocks + sum_blocks;
  const long long i =
      (long long)(blk - fold_blocks - second * sum_blocks) * blockDim.x + threadIdx.x;
  if (i < total4_w) split_sum(second ? part2 : part1, second ? dw2 : dw1, i, total4_w, splits);
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
  if ((err = in_bwd<2, float>(g, y2, stats, part_in, means, dz, n, h, w, c, stream, w1, w2, wsplit)) != cudaSuccess) return (int)err;
  if ((err = wgrad<true>(y1, stats, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  split_sum_kernel<<<sum_blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part_w), dw2,
                                                   total4_w, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = dgrad(dz, wsplit + (size_t)18 * c * c, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  // stage 1: through the fold, relu, IN1 and conv1 -> dW1, dx = g + fold(dpad1)
  if ((err = in_bwd<1, float>(dpad, y1, stats, part_in, means, dz, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  if ((err = wgrad<false>(x, stats, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess) return (int)err;
  if ((err = dgrad(dz, wsplit, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  const long long total4_x = (long long)n * h * w * c / 4;
  const int fold_blocks = (int)((total4_x + 255) / 256);
  finish_kernel<<<(unsigned)fold_blocks + sum_blocks, 256, 0, stream>>>(
      g, dpad, dx, reinterpret_cast<const float4*>(part_w), dw1, total4_x, total4_w, splits,
      fold_blocks, h, w, c);
  return (int)cudaGetLastError();
}

// The bf16 variant: x, y1hat, h1, g, w1, w2, pads (2, N, H + 2, W + 2, C: x's
// and h1's reflect-padded copies, written where a K slice's pixels are
// image rows: slice_boxes), dz, dw1, dw2, dx bf16; y2, stats, dpad,
// part_in, means, part_w (2, SPLITS, 9C, C: dW1's, then dW2's partials)
// fp32. The weight gradients' K slices are 64 pixels; the dgrads read the
// bf16 W as it lies (no split).
extern "C" int nemar_resblock_bwd_bf16(const bf16* x, const bf16* y1hat, const bf16* h1,
                                       const float* y2, const float* stats, const bf16* g,
                                       const bf16* w1, const bf16* w2, bf16* pads, bf16* dz,
                                       float* dpad, float* part_in, float* means, float* part_w,
                                       bf16* dw1, bf16* dw2, bf16* dx, int n, int h, int w, int c,
                                       int splits, cudaStream_t stream) {
  cudaError_t err;
  const long long total4_w = (long long)9 * c * c / 4;
  const int sum_blocks = (int)((total4_w + 255) / 256);
  float* part_w2 = part_w + (size_t)splits * 9 * c * c;
  const bool box = slice_boxes(w);
  const long long chunks = (long long)n * (h + 2) * (w + 2) * c / 8;
  const bf16* xpad = box ? pads : nullptr;
  const bf16* hpad = box ? pads + chunks * 8 : nullptr;
  if (box) {
    pad16_kernel<<<(unsigned)((2 * chunks + 255) / 256), 256, 0, stream>>>(x, h1, pads, chunks, h,
                                                                           w, c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // stage 2: through IN2 and conv2 -> dW2's partials, dpad2
  if ((err = in_bwd16<2>(g, y2, stats, part_in, means, dz, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = wgrad16(h1, hpad, dz, part_w2, n, h, w, c, splits, stream)) != cudaSuccess)
    return (int)err;
  if ((err = dgrad16(dz, w2, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  // stage 1: through the fold, relu, IN1 and conv1 -> dW1's partials, dpad1
  if ((err = in_bwd16<1>(dpad, y1hat, stats, part_in, means, dz, n, h, w, c, stream)) !=
      cudaSuccess)
    return (int)err;
  if ((err = wgrad16(x, xpad, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess)
    return (int)err;
  if ((err = dgrad16(dz, w1, dpad, n, h, w, c, stream)) != cudaSuccess) return (int)err;
  // dx = g + fold(dpad1); dW1, dW2 the sums of their partials
  const long long total4_x = (long long)n * h * w * c / 4;
  const int fold_blocks = (int)((total4_x + 255) / 256);
  finish16_kernel<<<(unsigned)(fold_blocks + 2 * sum_blocks), 256, 0, stream>>>(
      g, dpad, dx, reinterpret_cast<const float4*>(part_w), dw1,
      reinterpret_cast<const float4*>(part_w2), dw2, total4_x, total4_w, splits, fold_blocks,
      sum_blocks, h, w, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The band form (--mesh_spatial; ops/conv_fused.py:block_band_bwd_cuda): the
// backward's launches over this rank's band, cut where the IN backward's
// means need every rank's partials (the caller all-gathers them) and where
// a dgrad's padded gradient holds rows of the neighbours' bands (the caller
// sends them to their owners and zeroes them: spatial.fold_halo_rows; the
// frame's edges keep the fold of the reflection). The wgrads read the
// forward's padded sources (x and y1 with their halo rows: WgradOp's kHp);
// dW1 and dW2 are the band's shares. parts: (ranks, N * tiles, 2, C),
// tiles = ceil(H_most * W / 64) of the largest band (a smaller band's
// partials zero past its own), merged over the frame's `pixels`.
// ---------------------------------------------------------------------------
// IN2's (stage 2: gsrc = g, y = y2) or IN1's (stage 1: gsrc = dpad2, folded
// where it is read, y = y1) partials. The bf16 variant's band form (the
// *_bf16 launchers) is the bf16 backward's launches cut the same way, from
// the bf16 band forward's saved values: stage 2 reads g (bf16) and y2,
// stage 1 dpad2 and y1hat (bf16); its wgrads read xp and h1p (bf16, H + 2
// rows), its dgrads W1 and W2 as they lie; dz, dW1, dW2 and dx bf16.
namespace {

// stage 2's (g, y2) or stage 1's (dpad2, y1 or y1hat) partials, T the
// step's element type
template <class T>
cudaError_t band_part(const void* gsrc, const void* y, const float* stats, float* part,
                      int stage, int n, int h, int w, int c, cudaStream_t stream) {
  const int tiles = (h * w + IN_TILE - 1) / IN_TILE;
  if (tiles == 0) return cudaSuccess;  // an empty band: the caller's partials are zeros
  const dim3 grid((unsigned)(n * tiles), (unsigned)(c / 128));
  if (stage == 2)
    in_bwd_partial_kernel<2, T><<<grid, 128, 0, stream>>>(
        static_cast<const InG<2, T>*>(gsrc), static_cast<const InY<2, T>*>(y), stats, part, h,
        w, c, tiles);
  else
    in_bwd_partial_kernel<1, T><<<grid, 128, 0, stream>>>(
        static_cast<const InG<1, T>*>(gsrc), static_cast<const InY<1, T>*>(y), stats, part, h,
        w, c, tiles);
  return cudaGetLastError();
}

// the means over the frame's `pixels` from every rank's partials, `tiles`
// (the largest band's) a rank (and, given w1, W1's and W2's split)
cudaError_t band_merge(const float* parts, float* means, int ranks, int tiles, long long pixels,
                       int n, int c, cudaStream_t stream, const float* w1 = nullptr,
                       const float* w2 = nullptr, float* wsplit = nullptr) {
  const int merge_blocks = (n * c + 255) / 256;
  const long long w4 = w1 ? (long long)9 * c * c / 4 : 0;
  in_bwd_merge_kernel<<<(unsigned)(merge_blocks + (2 * w4 + 255) / 256), 256, 0, stream>>>(
      parts, means, n, c, tiles, pixels, merge_blocks,
      reinterpret_cast<const float4*>(w1), reinterpret_cast<const float4*>(w2),
      reinterpret_cast<uint4*>(wsplit), w4, ranks, (long long)n * tiles * 2 * c);
  return cudaGetLastError();
}

template <int kStage, class T>
cudaError_t band_apply(const InG<kStage, T>* gsrc, const InY<kStage, T>* y, const float* stats,
                       const float* means, T* dz, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const long long total4 = (long long)n * h * w * c / 4;
  if (total4 == 0) return cudaSuccess;
  in_bwd_apply_kernel<kStage, T><<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
      gsrc, y, stats, means, dz, total4, h, w, c);
  return cudaGetLastError();
}

// dx = g + fold(dpad1), and dW1 = the sum of its partials
template <class T>
cudaError_t band_finish(const T* g, const float* dpad, T* dx, const float* part_w, T* dw1, int n,
                        int h, int w, int c, int splits, cudaStream_t stream) {
  const long long total4_w = (long long)9 * c * c / 4;
  const unsigned sum_blocks = (unsigned)((total4_w + 255) / 256);
  const long long total4_x = (long long)n * h * w * c / 4;
  const int fold_blocks = (int)((total4_x + 255) / 256);
  finish_kernel<<<(unsigned)fold_blocks + sum_blocks, 256, 0, stream>>>(
      g, dpad, dx, reinterpret_cast<const float4*>(part_w), dw1, total4_x, total4_w, splits,
      fold_blocks, h, w, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nemar_resblock_band_bwd_part(const float* gsrc, const float* y,
                                            const float* stats, float* part, int stage, int n,
                                            int h, int w, int c, cudaStream_t stream) {
  return (int)band_part<float>(gsrc, y, stats, part, stage, n, h, w, c, stream);
}

// IN2's means (and W1's, W2's split), dz2, dW2 (from y1p, H + 2 rows) and
// dpad2
extern "C" int nemar_resblock_band_bwd_dz2(const float* parts, float* means, const float* w1,
                                           const float* w2, float* wsplit, const float* g,
                                           const float* y2, const float* stats, float* dz,
                                           const float* y1p, float* part_w, float* dw2,
                                           float* dpad, int ranks, int tiles, long long pixels,
                                           int n, int h, int w, int c, int splits,
                                           cudaStream_t stream) {
  cudaError_t err;
  if ((err = band_merge(parts, means, ranks, tiles, pixels, n, c, stream, w1, w2, wsplit)) !=
      cudaSuccess)
    return (int)err;
  if ((err = band_apply<2>(g, y2, stats, means, dz, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = wgrad<true, true>(y1p, stats, dz, part_w, n, h, w, c, splits, stream)) !=
      cudaSuccess)
    return (int)err;
  const long long total4_w = (long long)9 * c * c / 4;
  split_sum_kernel<<<(unsigned)((total4_w + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw2, total4_w, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)dgrad(dz, wsplit + (size_t)18 * c * c, dpad, n, h, w, c, stream);
}

// IN1's means, dz1 from fold(dpad2), dW1's partials (from xp, H + 2 rows)
// and dpad1 (written over dpad2, which the apply has read)
extern "C" int nemar_resblock_band_bwd_dz1(const float* parts, float* means, const float* wsplit,
                                           float* dpad, const float* y1, const float* stats,
                                           float* dz, const float* xp, float* part_w, int ranks,
                                           int tiles, long long pixels, int n, int h, int w, int c,
                                           int splits, cudaStream_t stream) {
  cudaError_t err;
  if ((err = band_merge(parts, means, ranks, tiles, pixels, n, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = band_apply<1>(dpad, y1, stats, means, dz, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = wgrad<false, true>(xp, stats, dz, part_w, n, h, w, c, splits, stream)) !=
      cudaSuccess)
    return (int)err;
  return (int)dgrad(dz, wsplit, dpad, n, h, w, c, stream);
}

extern "C" int nemar_resblock_band_bwd_dx(const float* g, const float* dpad, float* dx,
                                          const float* part_w, float* dw1, int n, int h, int w,
                                          int c, int splits, cudaStream_t stream) {
  return (int)band_finish(g, dpad, dx, part_w, dw1, n, h, w, c, splits, stream);
}

extern "C" int nemar_resblock_band_bwd_part_bf16(const void* gsrc, const void* y,
                                                 const float* stats, float* part, int stage,
                                                 int n, int h, int w, int c,
                                                 cudaStream_t stream) {
  return (int)band_part<bf16>(gsrc, y, stats, part, stage, n, h, w, c, stream);
}

// IN2's means, dz2, dW2 (from h1p, H + 2 rows) and dpad2
extern "C" int nemar_resblock_band_bwd_dz2_bf16(const float* parts, float* means, const bf16* g,
                                                const float* y2, const float* stats, bf16* dz,
                                                const bf16* h1p, const bf16* w2, float* part_w,
                                                bf16* dw2, float* dpad, int ranks, int tiles,
                                                long long pixels, int n, int h, int w, int c,
                                                int splits, cudaStream_t stream) {
  cudaError_t err;
  if ((err = band_merge(parts, means, ranks, tiles, pixels, n, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = band_apply<2>(g, y2, stats, means, dz, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = wgrad16<true>(h1p, nullptr, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess)
    return (int)err;
  const long long total4_w = (long long)9 * c * c / 4;
  split_sum_kernel<<<(unsigned)((total4_w + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw2, total4_w, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)dgrad16(dz, w2, dpad, n, h, w, c, stream);
}

// IN1's means, dz1 from fold(dpad2), dW1's partials (from xp, H + 2 rows)
// and dpad1 (written over dpad2, which the apply has read)
extern "C" int nemar_resblock_band_bwd_dz1_bf16(const float* parts, float* means, float* dpad,
                                                const bf16* y1hat, const float* stats, bf16* dz,
                                                const bf16* xp, const bf16* w1, float* part_w,
                                                int ranks, int tiles, long long pixels, int n,
                                                int h, int w, int c, int splits,
                                                cudaStream_t stream) {
  cudaError_t err;
  if ((err = band_merge(parts, means, ranks, tiles, pixels, n, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = band_apply<1>(dpad, y1hat, stats, means, dz, n, h, w, c, stream)) != cudaSuccess)
    return (int)err;
  if ((err = wgrad16<true>(xp, nullptr, dz, part_w, n, h, w, c, splits, stream)) != cudaSuccess)
    return (int)err;
  return (int)dgrad16(dz, w1, dpad, n, h, w, c, stream);
}

// dx = g + fold(dpad1), and dW1 = the sum of its partials, both bf16
extern "C" int nemar_resblock_band_bwd_dx_bf16(const bf16* g, const float* dpad, bf16* dx,
                                               const float* part_w, bf16* dw1, int n, int h,
                                               int w, int c, int splits, cudaStream_t stream) {
  return (int)band_finish(g, dpad, dx, part_w, dw1, n, h, w, c, splits, stream);
}
