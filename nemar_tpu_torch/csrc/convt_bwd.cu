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
// 2H x 2W output that moves a few tens of MB. Both GEMMs run on the wgmma
// core of gemm_tc.cuh in 3xTF32 (fp32-level accuracy; the tensor-core
// bound is 3 x 2 x 2.42 GFLOP at 495 TFLOP/s = 29 us per image and stage),
// with every operand row and every channel past Ci or Co zero-filled by
// cp.async, so any Ci, Co % 4 == 0 runs. The TPU kernel keeps a sample in
// VMEM and carries dW across its sequential grid; Hopper blocks run in no
// order, so every sum across blocks here is a partial buffer merged in a
// fixed order (no float atomics: two identical runs are bit-identical).
// Six launches, counted as one call:
//
//   1-3. gh = g * (yhat > 0); per (n, c) the means m1 = mean(gh) and
//        m2 = mean(gh * yhat) over the 4 planes together (per-tile partial
//        sums, a fixed-order fp64 merge by a block per (n, 32 channels));
//        dz = rstd * (gh - m1 - yhat * m2). Launch 3's blocks past the
//        apply also split W into TF32 big and small parts for the dgrad.
//   4.   dW[ky, kx] = sum over pixels (n, i, j) of x[n, i + dy, j + dx] (x)
//        dz[n, 2i + py, 2j + px], the tap's one parity plane (py, dy) from
//        the forward's table: a GEMM M = 9 * Ci (tap, ci), N = Co,
//        K = N*H*W, on gemm_wgmma_mn_kernel (A = x shifted by the tap, B =
//        the parity plane of dz, both pixel-major), split over pixel ranges
//        into a partial buffer (as K-block-bwd's weight gradients), 64 or
//        128 output channels a tile;
//   5.   dW = the partials summed in split order;
//   6.   dx[n, i, j] = sum over the 9 taps of dz[n, 2i + 2 - ky, 2j + 2 - kx]
//        . W[ky, kx]^T (zero past the output's edge), the TPU kernel's _AXB
//        table: a GEMM M = N*H*W pixels, N = Ci, K = 9 * Co (tap, co) on
//        gemm_wgmma_kernel, A = dz along co, B = W in HWIO as it lies
//        (K-major: rows ci, co contiguous), as K-block-bwd's dgrad reads W.
//
// Layouts: x, dx (N, H, W, Ci); yhat, g, dz (N, 2H, 2W, Co); stats
// (N, 2, Co) = (mu, rstd); w, dw (3, 3, Ci, Co) HWIO; wsplit (2, 9 * Ci, Co)
// = (W big, W small); part_in (N * tiles, 2, Co), tiles = ceil(4*H*W / 64);
// means (N, 2, Co); part_w (splits, 9 * Ci, Co). All fp32. Requirements
// (checked by the wrapper): Ci % 4 == 0, Co % 4 == 0, 16-byte aligned
// pointers, pix_per_split % 32 == 0.
#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

using tc::BK;
using tc::BM;
using tc::CHUNKS;
using tc::cp_async16;

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

// blocks [0, apply_blocks): dz; the rest split w (w4 float4s) into
// wsplit = (w big, w small) for the dgrad's B operand
__global__ void in_bwd_apply_kernel(const float4* __restrict__ g, const float4* __restrict__ yh,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, float4* __restrict__ dz,
                                    long long total4, long long per_sample, int c,
                                    int apply_blocks, const float4* __restrict__ w,
                                    uint4* __restrict__ wsplit, long long w4) {
  if ((int)blockIdx.x >= apply_blocks) {
    const long long i = (long long)(blockIdx.x - apply_blocks) * blockDim.x + threadIdx.x;
    if (i >= w4) return;
    const float4 v = w[i];
    uint4 big, small;
    tc::split_tf32(v.x, big.x, small.x);
    tc::split_tf32(v.y, big.y, small.y);
    tc::split_tf32(v.z, big.z, small.z);
    tc::split_tf32(v.w, big.w, small.w);
    wsplit[i] = big;
    wsplit[w4 + i] = small;
    return;
  }
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
template <int kTN>
struct ConvtWgradOp {
  static constexpr bool kNormRelu = false;
  static constexpr int kTileN = kTN;  // output channels per tile: 128 or 64
  const float* x;
  const float* dz;
  float* part;
  int h, w, ci, co, total, pix_per_split, mtiles;
  // per thread
  int tap, ci0, n0, py, px, dy, dx, p0, nkt, col;

  __device__ void setup(int tid) {
    tap = blockIdx.x / mtiles;  // mtiles 128-row tiles (ci) within one tap
    ci0 = (blockIdx.x - tap * mtiles) * BM;
    n0 = blockIdx.y * kTN;
    const int ky = tap / 3, kx = tap - 3 * ky;
    py = ky == 1;
    px = kx == 1;
    dy = ky == 0 ? -1 : 0;
    dx = kx == 0 ? -1 : 0;
    p0 = blockIdx.z * pix_per_split;
    nkt = (min(pix_per_split, total - p0) + BK - 1) / BK;
    col = tc::mmajor_col(tid);
  }
  __device__ int ktiles() const { return nkt; }
  __device__ void load(int kt, float* As, float* Bs, int tid) const {
    // this thread's rows k = warp + 8 i (i < 4) are the warp's: lane l works
    // out, for row warp + 8 (l % 4), the pixel of x (-1 off the frame or past
    // the last pixel) and that of dz (-1 past the last pixel), shared by
    // shuffles
    const int pk = p0 + kt * BK, kw = tid >> 5;
    int xs, zs;
    {
      const int p = pk + kw + 8 * (tid & 3);
      const int hw = h * w, b = p / hw, pix = p - b * hw;
      const int i = pix / w, j = pix - (pix / w) * w;
      const bool in = p < total;
      xs = in && i + dy >= 0 && j + dx >= 0 ? (b * h + i + dy) * w + j + dx : -1;
      zs = in ? (b * 2 * h + 2 * i + py) * 2 * w + 2 * j + px : -1;
    }
    const bool cin = ci0 + col < ci, nin = n0 + col < co;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int k = kw + 8 * i;
      const int sx = __shfl_sync(0xffffffffu, xs, i), sz = __shfl_sync(0xffffffffu, zs, i);
      const bool va = cin && sx >= 0, vb = nin && sz >= 0;
      cp_async16(tc::mmajor_at(As, k, col), va ? x + (size_t)sx * ci + ci0 + col : x, va);
      if (kTN == 128 || col < kTN)
        cp_async16(tc::mmajor_at(Bs, k, col), vb ? dz + (size_t)sz * co + n0 + col : dz, vb);
    }
  }
  template <class V>
  __device__ void write(int r, int cl, V val) const {
    if (ci0 + r >= ci || n0 + cl >= co) return;
    float* dst = part + ((size_t)blockIdx.z * 9 * ci + (size_t)tap * ci + ci0 + r) * co + n0 + cl;
    *reinterpret_cast<V*>(dst) = val;
  }
};

// 5. out = sum over the splits of part, in split order; float4-wide
__global__ void split_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                 long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = part[(size_t)k * total4 + i];
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  out[i] = s;
}

// ---------------------------------------------------------------------------
// 6. dx[p, ci] = sum_{tap, co} dz[b, 2i + 2 - ky, 2j + 2 - kx, co] * w[tap][ci][co]
// ---------------------------------------------------------------------------
template <int kTN>
struct ConvtDgradOp {
  static constexpr bool kNormRelu = false;
  static constexpr bool kTileStats = false;
  static constexpr int kTileN = kTN;  // input channels per tile: 128 or 64
  const float* dz;
  // W in HWIO, split: B(k = (tap, co), n = ci) is K-major as it lies
  const float* wbig;
  const float* wsmall;
  float* dx;
  int h, w, ci, co, total;
  // per thread, for its A rows: the dz pixel of (b, 0, 0) and i << 16 | j
  // (i = 0x7fff past the last pixel: every tap falls off the output)
  int m0, n0, kc, spt;
  int rbase[CHUNKS], rij[CHUNKS];

  __device__ void setup(int tid) {
    m0 = blockIdx.x * BM;
    n0 = blockIdx.y * kTN;
    kc = tc::kmajor_k(tid);
    spt = (co + BK - 1) / BK;
    const int hw = h * w;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int p = m0 + tc::kmajor_row(tid, i);
      const int b = p / hw, pix = p - b * hw, u = pix / w;
      rbase[i] = 4 * b * hw;
      rij[i] = p < total ? (u << 16) | (pix - u * w) : 0x7fff0000;
    }
  }
  __device__ int ktiles() const { return 9 * spt; }
  __device__ void load(int kt, float* As, float* Bb, float* Bs, int tid) const {
    const int tap = kt / spt;
    const int c = (kt - tap * spt) * BK + kc;
    const int ky = tap / 3, kx = tap - 3 * ky;
    const bool cin = c < co;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int oi = 2 * (rij[i] >> 16) + 2 - ky, oj = 2 * (rij[i] & 0xffff) + 2 - kx;
      const bool valid = cin && oi < 2 * h && oj < 2 * w;
      cp_async16(tc::kmajor_at(As, tc::kmajor_row(tid, i), kc),
                 valid ? dz + (size_t)(rbase[i] + oi * 2 * w + oj) * co + c : dz, valid);
    }
#pragma unroll
    for (int i = 0; i < kTN * BK / 4 / tc::THREADS; ++i) {
      const int nr = tc::kmajor_row(tid, i);
      const bool valid = cin && n0 + nr < ci;
      const size_t off = ((size_t)tap * ci + n0 + nr) * co + c;
      const int dst = tc::swizzled_off(nr, kc / 4);
      cp_async16(Bb + dst, valid ? wbig + off : wbig, valid);
      cp_async16(Bs + dst, valid ? wsmall + off : wsmall, valid);
    }
  }
  template <class V>
  __device__ void write(int r, int col, V val) const {
    const int p = m0 + r;
    if (p < total && n0 + col < ci) *reinterpret_cast<V*>(dx + (size_t)p * ci + n0 + col) = val;
  }
};

template <int kTN>
cudaError_t wgrad(const float* x, const float* dz, float* part, int h, int w, int ci, int co,
                  int total, int splits, int pix_per_split, cudaStream_t stream) {
  ConvtWgradOp<kTN> op;
  op.x = x;
  op.dz = dz;
  op.part = part;
  op.h = h;
  op.w = w;
  op.ci = ci;
  op.co = co;
  op.total = total;
  op.pix_per_split = pix_per_split;
  op.mtiles = (ci + BM - 1) / BM;
  return tc::launch_wgmma_mn(
      op, dim3((unsigned)(9 * op.mtiles), (unsigned)((co + kTN - 1) / kTN), (unsigned)splits),
      stream);
}

template <int kTN>
cudaError_t dgrad(const float* dz, const float* wsplit, float* dx, int h, int w, int ci, int co,
                  int total, cudaStream_t stream) {
  ConvtDgradOp<kTN> op;
  op.dz = dz;
  op.wbig = wsplit;
  op.wsmall = wsplit + (size_t)9 * ci * co;
  op.dx = dx;
  op.h = h;
  op.w = w;
  op.ci = ci;
  op.co = co;
  op.total = total;
  return tc::launch_wgmma(
      op, dim3((unsigned)((total + BM - 1) / BM), (unsigned)((ci + kTN - 1) / kTN)), stream);
}

}  // namespace

extern "C" int nemar_convt_in_bwd(const float* x, const float* w, const float* yhat,
                                  const float* stats, const float* g, float* wsplit, float* dz,
                                  float* part_in, float* means, float* part_w, float* dw,
                                  float* dx, int n, int h, int w_, int ci, int co, int splits,
                                  int pix_per_split, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int pixels = 4 * h * w_;  // of one sample's output
  const int tiles = (pixels + IN_TILE - 1) / IN_TILE;
  in_bwd_partial_kernel<<<dim3((unsigned)(n * tiles), (unsigned)((co + 127) / 128)), 128, 0,
                          stream>>>(g, yhat, part_in, pixels, co, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  in_bwd_merge_kernel<<<dim3((unsigned)((co + MG_LANES - 1) / MG_LANES), (unsigned)n),
                        MG_LANES * MG_WARPS, 0, stream>>>(part_in, means, co, tiles, pixels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_sample = (long long)pixels * co;
  const long long total4 = n * per_sample / 4;
  const int apply_blocks = (int)((total4 + 255) / 256);
  const long long w4 = (long long)9 * ci * co / 4;
  in_bwd_apply_kernel<<<(unsigned)(apply_blocks + (w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(yhat), stats, means,
      reinterpret_cast<float4*>(dz), total4, per_sample, co, apply_blocks,
      reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(wsplit), w4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int total = n * h * w_;  // input pixels = each plane's pixels
  err = co <= 64 ? wgrad<64>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream)
                 : wgrad<128>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream);
  if (err != cudaSuccess) return (int)err;
  split_sum_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), reinterpret_cast<float4*>(dw), w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 64 input channels a tile where 128 would waste half of each, or leave
  // SMs idle (batch 1 at 64^2: 64 tiles of 128 x 128 for 132 SMs)
  const bool narrow = ci <= 64 || (long long)((total + BM - 1) / BM) * ((ci + 127) / 128) < sms;
  err = narrow ? dgrad<64>(dz, wsplit, dx, h, w_, ci, co, total, stream)
               : dgrad<128>(dz, wsplit, dx, h, w_, ci, co, total, stream);
  return (int)err;
}
