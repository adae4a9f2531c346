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
//
// The bf16 variant (--bf16; nemar_convt_in_bwd_bf16) takes x, W, yhat and
// g in bf16 and runs both GEMMs on the bf16 core (gemm_tc.cuh: one bf16 MMA
// a product, fp32 accumulators; the wgrad's pixel-major operands read by
// wgmma as they lie, K slices of 64 pixels; x, W and dz's parity planes as
// TMA boxes where a tile's pixels are image rows). Its instance-norm
// backward is bound by bytes (g and yhat read twice, dz written: 335 MB at
// 8 x 256^2 x 64) and runs at the card's bandwidth in three launches of
// its own: the partial sums with 16-byte loads, a block per tile of
// 256-2048 output pixels, the lanes of a block on neighbouring pixels
// (convt_partial16_kernel); the means, 8 channels a block
// (convt_means16_kernel); dz with 16-byte loads and stores
// (convt_dz16_kernel). Six launches: those three, the wgrad (at Co <= 64
// and long splits folded: ConvtWgradOp16), the split sum (split_sum16_kernel, dW rounded
// to bf16) and the dgrad (dx bf16, 16-byte stores; W read as it lies, no
// split); the sums and partials fp32. It takes Ci % 8 == 0, Co % 8 == 0,
// Co <= 2048, pix_per_split % 64 == 0. Bound: 2 x 2.42 GFLOP per image and
// stage at 989 TFLOP/s = 4.9 us.
#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

using tc::BK;
using tc::BM;
using tc::CHUNKS;
using tc::cp_async16;

constexpr int IN_TILE = 64;  // output pixels per IN-backward partial

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// 1-3. the instance norm + relu backward over the 4 planes
// ---------------------------------------------------------------------------
// One block per (64-pixel tile of one sample, 128-channel block), one thread
// per channel. T: g's and yhat's element type (float, or bf16 in the bf16
// variant); the sums are fp32.
template <class T>
__global__ void in_bwd_partial_kernel(const T* __restrict__ g, const T* __restrict__ yh,
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
    const float y = tc::load1(yh + idx);
    const float gv = y > 0.f ? tc::load1(g + idx) : 0.f;
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

// The band form (--mesh_spatial) merges every rank's partials, `ranks`
// blocks `rank_stride` floats apart, warp k taking the entries k, k + 32, ...
// of them in rank order (tiles the largest band's, a smaller band's
// partials zero past its own); pixels is then the frame's.
__global__ void __launch_bounds__(MG_LANES * MG_WARPS)
in_bwd_merge_kernel(const float* __restrict__ part, float* __restrict__ means, int c, int tiles,
                    long long pixels, int ranks, long long rank_stride) {
  __shared__ double red[2][MG_WARPS][MG_LANES];
  const int lane = threadIdx.x % MG_LANES, warp = threadIdx.x / MG_LANES;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * MG_LANES + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * tiles * 2 * c + ch;
  double s1 = 0.0, s2 = 0.0;
  for (int e = warp; live && e < ranks * tiles; e += MG_WARPS) {
    const float* q = p + (size_t)(e / tiles) * rank_stride + (size_t)(e % tiles) * 2 * c;
    s1 += (double)q[0];
    s2 += (double)q[c];
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

// blocks [0, apply_blocks): dz, stored as T; the rest split w (w4 float4s)
// into wsplit = (w big, w small) for the fp32 dgrad's B operand (none in
// the bf16 variant, whose dgrad reads W as it lies)
template <class T>
__global__ void in_bwd_apply_kernel(const T* __restrict__ g, const T* __restrict__ yh,
                                    const float* __restrict__ stats,
                                    const float* __restrict__ means, T* __restrict__ dz,
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
  const float4 gv4 = tc::load4(g + e), yv4 = tc::load4(yh + e);
  const float gin[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
  const float yin[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gv = yin[k] > 0.f ? gin[k] : 0.f;
    o[k] = rs[k] * (gv - m1[k] - yin[k] * m2[k]);
  }
  tc::store4(dz + e, make_float4(o[0], o[1], o[2], o[3]));
}

// The bf16 variant's instance-norm backward at the card's bandwidth, in two
// launches. 1: a block per (sample, tile of tile_px output pixels), each
// thread 16 bytes (8 channels) of a pixel a load, the block's lanes (256 /
// (C / 8) pixels side by side) walking the tile's pixels, four loads
// ahead; a thread's sums over its pixels in order, then the lanes' in lane
// order through shared memory. C <= 2048.
constexpr int P16_THREADS = 256;

// gh = g (yhat > 0), s1 += gh, s2 += gh yhat over the 8 channels of a load
__device__ __forceinline__ void in_bwd_sums8(uint4 gq, uint4 yq, float (&s1)[8],
                                             float (&s2)[8]) {
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gq);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yq);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 gv = __bfloat1622float2(g2[k]), yv = __bfloat1622float2(y2[k]);
    const float a = yv.x > 0.f ? gv.x : 0.f, b = yv.y > 0.f ? gv.y : 0.f;
    s1[2 * k] += a;
    s2[2 * k] = fmaf(a, yv.x, s2[2 * k]);
    s1[2 * k + 1] += b;
    s2[2 * k + 1] = fmaf(b, yv.y, s2[2 * k + 1]);
  }
}

__global__ void __launch_bounds__(P16_THREADS)
convt_partial16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ yh,
                        float* __restrict__ part, int pixels, int c, int ptiles, int tile_px) {
  __shared__ float red[2][P16_THREADS * 8];
  const int cpp = c / 8, lanes = P16_THREADS / cpp;
  const int chunk = threadIdx.x % cpp, lane = threadIdx.x / cpp;
  const int b = blockIdx.x / ptiles, t = blockIdx.x - b * ptiles;
  const int p0 = t * tile_px, cnt = min(tile_px, pixels - p0);
  float s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
  if (lane < lanes) {
    const uint4* gp = reinterpret_cast<const uint4*>(g + ((size_t)b * pixels + p0) * c) + chunk;
    const uint4* yp = reinterpret_cast<const uint4*>(yh + ((size_t)b * pixels + p0) * c) + chunk;
    int q = lane;
    for (; q + 3 * lanes < cnt; q += 4 * lanes) {
      uint4 gq[4], yq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gq[k] = gp[(size_t)(q + k * lanes) * cpp];
        yq[k] = yp[(size_t)(q + k * lanes) * cpp];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) in_bwd_sums8(gq[k], yq[k], s1, s2);
    }
    for (; q < cnt; q += lanes) in_bwd_sums8(gp[(size_t)q * cpp], yp[(size_t)q * cpp], s1, s2);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[0][lane * c + 8 * chunk + k] = s1[k];
      red[1][lane * c + 8 * chunk + k] = s2[k];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += P16_THREADS) {
    float a1 = 0.f, a2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a1 += red[0][l * c + ch];
      a2 += red[1][l * c + ch];
    }
    float* p = part + (size_t)blockIdx.x * 2 * c + ch;
    p[0] = a1;
    p[c] = a2;
  }
}

// 2: the means (N, 2, C) = (mean(gh), mean(gh yhat)) from a sample's ptiles
// partials in fp64: a block per (sample, 8 channels), 128 groups of 8
// threads, group k the partials k, k + 128, ..., the groups added by a
// fixed pairwise tree (tc::group_sum). (Merged into each block of the dz
// launch, the 256-2048 partials a sample cost every block more than this
// launch costs.)
constexpr int MG16_CH = 8, MG16_GROUPS = 128;

__global__ void __launch_bounds__(MG16_CH * MG16_GROUPS)
convt_means16_kernel(const float* __restrict__ part, float* __restrict__ means, int c,
                      int ptiles, int pixels) {
  __shared__ double red[MG16_GROUPS][MG16_CH];
  const int lane = threadIdx.x % MG16_CH, grp = threadIdx.x / MG16_CH;
  const int b = blockIdx.y, ch = blockIdx.x * MG16_CH + lane;
  const bool live = ch < c;
  const float* p = part + (size_t)b * ptiles * 2 * c + ch;
  double s1 = 0.0, s2 = 0.0;
#pragma unroll 4
  for (int e = grp; live && e < ptiles; e += MG16_GROUPS) {
    s1 += (double)p[(size_t)e * 2 * c];
    s2 += (double)p[(size_t)e * 2 * c + c];
  }
  const double m1 = tc::group_sum(red, s1, grp, lane), m2 = tc::group_sum(red, s2, grp, lane);
  if (grp == 0 && live) {
    means[(size_t)b * 2 * c + ch] = (float)(m1 / pixels);
    means[(size_t)b * 2 * c + c + ch] = (float)(m2 / pixels);
  }
}

// 3: dz = rstd (gh - m1 - yhat m2) over a range of a sample's pixels, 16
// bytes a load and a store, the sample's (m1, m2, rstd) staged in shared
// memory; a block per (range, sample).
constexpr int DZ_THREADS = 256;

__global__ void __launch_bounds__(DZ_THREADS)
convt_dz16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ yh,
                   const float* __restrict__ stats, const float* __restrict__ means,
                   bf16* __restrict__ dz, int pixels, int c) {
  extern __shared__ float mrs[];  // m1 [c], m2 [c], rstd [c]
  const int b = blockIdx.y;
  for (int ch = threadIdx.x; ch < c; ch += DZ_THREADS) {
    mrs[ch] = means[(size_t)b * 2 * c + ch];
    mrs[c + ch] = means[(size_t)b * 2 * c + c + ch];
    mrs[2 * c + ch] = stats[(size_t)b * 2 * c + c + ch];
  }
  __syncthreads();
  const int cpp = c / 8;
  const int q0 = (int)((long long)pixels * blockIdx.x / gridDim.x);
  const int q1 = (int)((long long)pixels * (blockIdx.x + 1) / gridDim.x);
  const int total = (q1 - q0) * cpp;
  const size_t base = ((size_t)b * pixels + q0) * cpp;
  const uint4* gp = reinterpret_cast<const uint4*>(g) + base;
  const uint4* yp = reinterpret_cast<const uint4*>(yh) + base;
  uint4* dp = reinterpret_cast<uint4*>(dz) + base;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += DZ_THREADS) {
    const int c8 = (i % cpp) * 8;
    const uint4 gq = gp[i], yq = yp[i];
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gq);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yq);
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 gv = __bfloat1622float2(g2[k]), yv = __bfloat1622float2(y2[k]);
      const int ch = c8 + 2 * k;
      const float a = yv.x > 0.f ? gv.x : 0.f, bb = yv.y > 0.f ? gv.y : 0.f;
      o2[k] = __floats2bfloat162_rn(mrs[2 * c + ch] * (a - mrs[ch] - yv.x * mrs[c + ch]),
                                    mrs[2 * c + ch + 1] *
                                        (bb - mrs[ch + 1] - yv.y * mrs[c + ch + 1]));
    }
    dp[i] = o;
  }
}

// the tile of convt_partial16_kernel: the largest of 2048 .. 256 pixels
// that still gives two blocks an SM
int partial16_tile(int n, int pixels, int sms) {
  int tile = 2048;
  while (tile > 256 && (long long)n * ((pixels + tile - 1) / tile) < 2LL * sms) tile /= 2;
  return tile;
}

// ---------------------------------------------------------------------------
// 4. dW partials: part[s][tap*Ci + ci][co] = sum over the pixels p of split
// s of x[b, i + dy, j + dx, ci] * dz[b, 2i + py, 2j + px, co]
// ---------------------------------------------------------------------------
// kBand (the band form): x holds each sample's H + 1 rows, the halo row
// above the band first; dz each sample's 2H + 1 rows, the halo row below
// the band last (never read here: the band's pixels' planes are its rows).
template <int kTN, bool kBand = false>
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
      constexpr int hb = kBand ? 1 : 0;
      xs = in && i + dy + hb >= 0 && j + dx >= 0 ? (b * (h + hb) + i + dy + hb) * w + j + dx : -1;
      zs = in ? (b * (2 * h + hb) + 2 * i + py) * 2 * w + 2 * j + px : -1;
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

// 5. out = sum over the splits of part, in split order, float4-wide (fp32
// dW)
__global__ void split_sum_kernel(const float4* __restrict__ part, float* __restrict__ out,
                                 long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = part[(size_t)k * total4 + i];
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  tc::store4(out + 4 * i, s);
}

// 5 (the bf16 variant, whole frame and band form): split_sum_kernel's sums
// in its order, the partials' loads issued eight splits ahead of the adds
// (one dependent load a split left it waiting on memory), dW rounded to bf16
constexpr int SPLIT_DEPTH = 8;

__global__ void split_sum16_kernel(const float4* __restrict__ part, bf16* __restrict__ out,
                                   long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float4 s = part[i];
  for (int k0 = 1; k0 < splits; k0 += SPLIT_DEPTH) {
    float4 v[SPLIT_DEPTH];
#pragma unroll
    for (int k = 0; k < SPLIT_DEPTH; ++k)
      if (k0 + k < splits) v[k] = part[(size_t)(k0 + k) * total4 + i];
#pragma unroll
    for (int k = 0; k < SPLIT_DEPTH; ++k)
      if (k0 + k < splits) s = make_float4(s.x + v[k].x, s.y + v[k].y, s.z + v[k].z, s.w + v[k].w);
  }
  tc::store4(out + 4 * i, s);
}

// ---------------------------------------------------------------------------
// 6. dx[p, ci] = sum_{tap, co} dz[b, 2i + 2 - ky, 2j + 2 - kx, co] * w[tap][ci][co]
// ---------------------------------------------------------------------------
// kBand (the band form): dz holds each sample's 2H + 1 rows, the halo row
// below the band last (zeros at the frame's bottom), so output row 2i + 2
// of the band's last input row is read from it.
template <int kTN, bool kBand = false>
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
      rbase[i] = kBand ? b * (2 * h + 1) * 2 * w : 4 * b * hw;
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
      const bool valid = cin && oi < 2 * h + (kBand ? 1 : 0) && oj < 2 * w;
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

template <int kTN, bool kBand = false>
cudaError_t wgrad(const float* x, const float* dz, float* part, int h, int w, int ci, int co,
                  int total, int splits, int pix_per_split, cudaStream_t stream) {
  ConvtWgradOp<kTN, kBand> op;
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

template <int kTN, bool kBand = false>
cudaError_t dgrad(const float* dz, const float* wsplit, float* dx, int h, int w, int ci, int co,
                  int total, cudaStream_t stream) {
  ConvtDgradOp<kTN, kBand> op;
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

// ---------------------------------------------------------------------------
// bf16 variant (nemar_convt_in_bwd_bf16): its GEMM operands; the
// instance-norm backward and the split sum are the templates above
// ---------------------------------------------------------------------------

// dz (N, 2H, 2W, Co) as (N, H, 2, W, 2 Co): an output parity plane's pixel
// (i, j) at coordinates (px Co + c, j, py, i, n), read in boxes of 64
// channels x bw x bh pixels of one plane
cudaError_t parity_map(CUtensorMap* map, const bf16* dz, int n, int h, int w, int co, int bw,
                       int bh) {
  const long long dims[5] = {2LL * co, w, 2, h, n};
  const int box[5] = {tc::BK16, bw, 1, bh, 1};
  return tc::bf16_map(map, dz, 5, dims, box);
}

// 4: dW partials with bf16 operands, K slices of 64 pixels (pix_per_split
// a multiple of 64); x shifted by the tap (M-major: ci) and the tap's
// parity plane of dz (N-major: co), both read by wgmma as they lie; kBand
// as ConvtWgradOp's. Where a slice's 64 pixels are image rows of one
// sample (H W a multiple of 64, W dividing 64 or 64 dividing W), A is two
// TMA boxes of x (tma_a: 64 channels each, the frame's zeros and Ci's the
// out-of-bounds fill) and, outside the band form and at Co a multiple of
// 64, B is TMA boxes of dz's parity plane (tma_b: dz as (N, H, 2, W,
// 2 Co), the plane's parities fixed coordinates); else the producer's
// cp.async copies, masked in the index. kFold (Co <= 64, kTN 128): a tile
// is a row tap ky and a column offset dx (0, then -1) against both column
// parities of the row parity (2 Co channels side by side in that view):
// the taps (ky, 2) | (ky, 1) share A at dx = 0, and (ky, 0) takes the
// first Co columns at dx = -1 (the rest, no tap's, are not written), so A
// is read 6 times where 9 tiles read it, for a third more MMAs: faster on
// long splits (batch 8), slower on short ones (batch 1).
template <int kTN, bool kBand = false, bool kFold = false>
struct ConvtWgradOp16 : tc::Bf16Loads {
  static constexpr bool kMN = true;
  static constexpr bool kTileStats = false;
  static constexpr int kTileN = kTN;
  static_assert(!kFold || (kTN == 128 && !kBand), "a folded tile: both parities, one frame");
  const bf16* x;
  const bf16* dz;
  float* part;
  int h, w, ci, co, total, pix_per_split, mtiles;
  int tap, ci0, n0, ky, py, px, dy, dx, p0, nkt, split;

  __device__ void setup(int, uint3 blk) {
    tap = blk.x / mtiles;  // (ky, kx), or folded (ky, dx)
    ci0 = (blk.x - tap * mtiles) * BM;
    n0 = blk.y * kTN;
    ky = kFold ? tap / 2 : tap / 3;
    const int kx = kFold ? (tap % 2 == 1 ? 0 : 2) : tap - 3 * ky;
    py = ky == 1;
    px = kFold ? 0 : kx == 1;
    dy = ky == 0 ? -1 : 0;
    dx = kx == 0 ? -1 : 0;
    split = blk.z;
    p0 = split * pix_per_split;
    nkt = (min(pix_per_split, total - p0) + tc::BK16 - 1) / tc::BK16;
  }
  __device__ int ktiles() const { return nkt; }
  // (the pixel of x, or -1 off the frame or past the last pixel; that of dz)
  __device__ void pixels(int p, int& xs, int& zs) const {
    const int hw = h * w, b = p / hw, pix = p - b * hw;
    const int i = pix / w, j = pix - (pix / w) * w;
    const bool in = p < total;
    constexpr int hb = kBand ? 1 : 0;
    xs = in && i + dy + hb >= 0 && j + dx >= 0 ? (b * (h + hb) + i + dy + hb) * w + j + dx : -1;
    zs = in ? (b * (2 * h + hb) + 2 * i + py) * 2 * w + 2 * j + px : -1;
  }
  __device__ void load(int kt, unsigned char* As, unsigned char* Bs, int ptid) const {
    const int pk = p0 + kt * tc::BK16;
    if (!tma_a) {
#pragma unroll
      for (int i = 0; i < tc::PCHUNKS; ++i) {
        const int q = ptid + tc::PTHREADS * i, k = q >> 4, ch = 8 * (q & 15);
        int xs, zs;
        pixels(pk + k, xs, zs);
        const bool va = ci0 + ch < ci && xs >= 0;
        tc::cp_async16b(As + tc::mn16(k, q & 15), va ? x + (size_t)xs * ci + ci0 + ch : x, va);
      }
    }
    if (tma_b) return;
    // kFold: the row's 2 Co channels from px = 0's pixel on, both parities
    const int cols = kFold ? 2 * co : co;
#pragma unroll
    for (int i = 0; i < kTN * 8 / tc::PTHREADS; ++i) {
      const int q = ptid + tc::PTHREADS * i, k = q / (kTN / 8), cc = q % (kTN / 8), ch = 8 * cc;
      int xs, zs;
      pixels(pk + k, xs, zs);
      const bool vb = n0 + ch < cols && zs >= 0;
      tc::cp_async16b(Bs + tc::mn16(k, cc), vb ? dz + (size_t)zs * co + n0 + ch : dz, vb);
    }
  }
  // the slice's sample and first pixel (u0, v0) of its rows
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    const int pk = p0 + kt * tc::BK16, hw = h * w, b = pk / hw, q0 = pk - b * hw;
    const int u0 = q0 / w, v0 = q0 - u0 * w;
    if (tma_a) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tc::tma_load(As + 8192 * j, &maps.a, bar, ci0 + 64 * j, v0 + dx, u0 + dy + (kBand ? 1 : 0),
                     b);
    }
    if (tma_b) {
#pragma unroll
      for (int j = 0; j < kTN / 64; ++j)
        tc::tma_load(Bs + 8192 * j, &maps.b, bar, px * co + n0 + 64 * j, v0, py, u0, b);
    }
  }
  __device__ void write(int r, int cl, float2 val) const {
    int t = tap, c = n0 + cl;
    if constexpr (kFold) {
      // column (px, c): tap (ky, 2) | (ky, 1) at dx = 0, (ky, 0) | none at dx = -1
      const int pxn = c >= co;
      if (pxn && dx) return;
      c -= pxn * co;
      t = ky * 3 + (dx ? 0 : 2 - pxn);
    }
    if (ci0 + r >= ci || c >= co) return;
    tc::store2(part + ((size_t)split * 9 * ci + (size_t)t * ci + ci0 + r) * co + c, val);
  }
};

// 6: dx with bf16 operands (dz along co, W in HWIO as it lies), dx bf16;
// kBand as ConvtDgradOp's. B (W as (9, Ci, Co)) is a TMA box; A is one
// (tma_a, outside the band form: a tile's 128 pixels image rows of one
// sample, Co a multiple of 64) of dz as (N, H, 2, W, 2 Co), the tap's
// output parities fixed coordinates and its offsets (i + 1 for ky = 0)
// zeros past the frame, or else the producer's cp.async copies.
template <int kTN, bool kBand = false>
struct ConvtDgradOp16 : tc::Bf16Loads {
  static constexpr bool kMN = false;
  static constexpr bool kTileStats = false;
  static constexpr bool kTileEpilogue = true;
  static constexpr int kTileN = kTN;
  const bf16* dz;
  const bf16* w;
  bf16* dx;
  int h, wd, ci, co, total;
  int m0, n0, kc, spt;
  int rbase[tc::PCHUNKS], rij[tc::PCHUNKS];

  __device__ void setup(int ptid, uint3 blk) {
    m0 = blk.x * BM;
    n0 = blk.y * kTN;
    kc = ptid & 7;
    spt = (co + tc::BK16 - 1) / tc::BK16;
    const int hw = h * wd;
    if (tma_a) return;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int p = m0 + tc::prow(ptid, i);
      const int b = p / hw, pix = p - b * hw, u = pix / wd;
      rbase[i] = kBand ? b * (2 * h + 1) * 2 * wd : 4 * b * hw;
      rij[i] = p < total ? (u << 16) | (pix - u * wd) : 0x7fff0000;
    }
  }
  __device__ int ktiles() const { return 9 * spt; }
  // A by cp.async (tma_a false)
  __device__ void load(int kt, unsigned char* As, unsigned char*, int ptid) const {
    const int tap = kt / spt;
    const int c = (kt - tap * spt) * tc::BK16 + 8 * kc;
    const int ky = tap / 3, kx = tap - 3 * ky;
    const bool cin = c < co;
#pragma unroll
    for (int i = 0; i < tc::PCHUNKS; ++i) {
      const int oi = 2 * (rij[i] >> 16) + 2 - ky, oj = 2 * (rij[i] & 0xffff) + 2 - kx;
      const bool valid = cin && oi < 2 * h + (kBand ? 1 : 0) && oj < 2 * wd;
      tc::cp_async16b(As + tc::swz16(tc::prow(ptid, i), kc),
                      valid ? dz + (size_t)(rbase[i] + oi * 2 * wd + oj) * co + c : dz, valid);
    }
  }
  // B (maps.b: W as (9, Ci, Co)); with tma_a, A (maps.a: dz as (N, H, 2, W,
  // 2 Co)) at output row 2 (u0 + (ky == 0)) + (ky == 1), column likewise
  __device__ void load_tma(int kt, unsigned char* As, unsigned char* Bs, uint64_t* bar,
                           const tc::TmaMaps& maps) const {
    const int tap = kt / spt;
    const int c = (kt - tap * spt) * tc::BK16;
    if (tma_a) {
      const int ky = tap / 3, kx = tap - 3 * ky, hw = h * wd;
      const int b = m0 / hw, pix = m0 - b * hw, u0 = pix / wd, v0 = pix - u0 * wd;
      tc::tma_load(As, &maps.a, bar, (kx == 1) * co + c, v0 + (kx == 0), ky == 1, u0 + (ky == 0),
                   b);
    }
    tc::tma_load(Bs, &maps.b, bar, c, n0, tap);
  }
  // dx 16 bytes a lane (tc::store_bf16_rows): whole 32-byte sectors a warp
  __device__ void tile_epilogue(const float (&acc)[kTN / 2], int row0, int g, int t) const {
    const int p0 = m0 + row0 + g, p1 = p0 + 8;
    tc::store_bf16_rows<kTN>(acc, t, p0 < total ? dx + (size_t)p0 * ci + n0 : nullptr,
                             p1 < total ? dx + (size_t)p1 * ci + n0 : nullptr, ci - n0);
  }
};

// the pixels a split from which the wgrad folds (16 K slices)
constexpr int WGRAD_FOLD_PIXELS = 16 * tc::BK16;

template <int kTN, bool kBand = false, bool kFold = false>
cudaError_t wgrad16(const bf16* x, const bf16* dz, float* part, int h, int w, int ci, int co,
                    int total, int splits, int pix_per_split, cudaStream_t stream) {
  ConvtWgradOp16<kTN, kBand, kFold> op;
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
  const int hw = h * w;
  op.tma_a = hw > 0 && hw % tc::BK16 == 0 && (w % tc::BK16 == 0 || tc::BK16 % w == 0);
  op.tma_b = op.tma_a && !kBand && co % 64 == 0;
  tc::TmaMaps maps{};
  cudaError_t err = cudaSuccess;
  if (op.tma_a) {
    const int bw = min(w, tc::BK16);
    err = tc::image_map(&maps.a, x, total / hw, h + (kBand ? 1 : 0), w, ci, bw, tc::BK16 / bw);
  }
  if (err == cudaSuccess && op.tma_b) {
    const int bw = min(w, tc::BK16);
    err = parity_map(&maps.b, dz, total / hw, h, w, co, bw, tc::BK16 / bw);
  }
  if (err != cudaSuccess) return err;
  const int taps = kFold ? 6 : 9, cols = kFold ? 2 * co : co;
  return tc::launch_bf16(op, dim3((unsigned)(taps * op.mtiles), (unsigned)((cols + kTN - 1) / kTN),
                                  (unsigned)splits),
                         stream, maps);
}

template <int kTN, bool kBand = false>
cudaError_t dgrad16(const bf16* dz, const bf16* w, bf16* dx, int h, int wd, int ci, int co,
                    int total, cudaStream_t stream) {
  ConvtDgradOp16<kTN, kBand> op;
  op.dz = dz;
  op.w = w;
  op.dx = dx;
  op.h = h;
  op.wd = wd;
  op.ci = ci;
  op.co = co;
  op.total = total;
  const int hw = h * wd;
  op.tma_b = true;
  op.tma_a = !kBand && hw > 0 && hw % BM == 0 && co % 64 == 0 && (wd % BM == 0 || BM % wd == 0);
  tc::TmaMaps maps{};
  const long long wdims[3] = {co, ci, 9};
  const int wbox[3] = {tc::BK16, kTN, 1};
  cudaError_t err = tc::bf16_map(&maps.b, w, 3, wdims, wbox);
  if (err == cudaSuccess && op.tma_a) {
    const int bw = min(wd, BM);
    err = parity_map(&maps.a, dz, total / hw, h, wd, co, bw, BM / bw);
  }
  if (err != cudaSuccess) return err;
  return tc::launch_bf16(
      op, dim3((unsigned)((total + BM - 1) / BM), (unsigned)((ci + kTN - 1) / kTN)), stream, maps);
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
                        MG_LANES * MG_WARPS, 0, stream>>>(part_in, means, co, tiles, pixels, 1,
                                                          0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_sample = (long long)pixels * co;
  const long long total4 = n * per_sample / 4;
  const int apply_blocks = (int)((total4 + 255) / 256);
  const long long w4 = (long long)9 * ci * co / 4;
  in_bwd_apply_kernel<<<(unsigned)(apply_blocks + (w4 + 255) / 256), 256, 0, stream>>>(
      g, yhat, stats, means, dz, total4, per_sample, co, apply_blocks,
      reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(wsplit), w4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int total = n * h * w_;  // input pixels = each plane's pixels
  err = co <= 64 ? wgrad<64>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream)
                 : wgrad<128>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream);
  if (err != cudaSuccess) return (int)err;
  split_sum_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw, w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 64 input channels a tile where 128 would waste half of each, or leave
  // SMs idle (batch 1 at 64^2: 64 tiles of 128 x 128 for 132 SMs)
  const bool narrow = ci <= 64 || (long long)((total + BM - 1) / BM) * ((ci + 127) / 128) < sms;
  err = narrow ? dgrad<64>(dz, wsplit, dx, h, w_, ci, co, total, stream)
               : dgrad<128>(dz, wsplit, dx, h, w_, ci, co, total, stream);
  return (int)err;
}

// The bf16 variant: x, w, yhat, g, dz, dw, dx bf16; stats, part_in (at
// least N ceil(4 H W / 256) partials), means, part_w fp32.
// pix_per_split % 64 == 0; Ci, Co multiples of 8, Co <= 2048.
extern "C" int nemar_convt_in_bwd_bf16(const bf16* x, const bf16* w, const bf16* yhat,
                                       const float* stats, const bf16* g, bf16* dz,
                                       float* part_in, float* means, float* part_w, bf16* dw,
                                       bf16* dx, int n, int h, int w_, int ci, int co, int splits,
                                       int pix_per_split, cudaStream_t stream) {
  if (co > 8 * P16_THREADS) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int pixels = 4 * h * w_;
  const int tile_px = partial16_tile(n, pixels, sms);
  const int ptiles = (pixels + tile_px - 1) / tile_px;
  convt_partial16_kernel<<<(unsigned)(n * ptiles), P16_THREADS, 0, stream>>>(
      g, yhat, part_in, pixels, co, ptiles, tile_px);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  convt_means16_kernel<<<dim3((unsigned)((co + MG16_CH - 1) / MG16_CH), (unsigned)n),
                          MG16_CH * MG16_GROUPS, 0, stream>>>(part_in, means, co, ptiles, pixels);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // about four blocks an SM, a range of at least 64 pixels each
  const int ranges = max(1, min((pixels + 63) / 64, (4 * sms + n - 1) / n));
  convt_dz16_kernel<<<dim3((unsigned)ranges, (unsigned)n), DZ_THREADS,
                       3 * co * (int)sizeof(float), stream>>>(g, yhat, stats, means, dz, pixels,
                                                               co);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int total = n * h * w_;
  // folded where a split's slices are many (batch 8); at a few slices a
  // split (batch 1) the folded tiles' third more MMAs cost more than the A
  // reads they save
  if (co > 64)
    err = wgrad16<128>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream);
  else if (pix_per_split >= WGRAD_FOLD_PIXELS)
    err = wgrad16<128, false, true>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split,
                                    stream);
  else
    err = wgrad16<64>(x, dz, part_w, h, w_, ci, co, total, splits, pix_per_split, stream);
  if (err != cudaSuccess) return (int)err;
  const long long w4 = (long long)9 * ci * co / 4;
  split_sum16_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw, w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool narrow = ci <= 64 || (long long)((total + BM - 1) / BM) * ((ci + 127) / 128) < sms;
  return (int)(narrow ? dgrad16<64>(dz, w, dx, h, w_, ci, co, total, stream)
                      : dgrad16<128>(dz, w, dx, h, w_, ci, co, total, stream));
}

// ---------------------------------------------------------------------------
// The band form (--mesh_spatial; ops/convt_fused.py:convt_band_bwd_cuda):
// the backward over this rank's band, x's band xp (N, H + 1, W, Ci) with its
// halo row above, as the forward read it. Three launchers: the IN
// backward's partials; then, from every rank's partials (ranks, N * tiles,
// 2, Co; tiles the largest band's), the frame's means, dz and W's split;
// then, given dz with its halo row from below (dzp, N, 2H + 1, 2W, Co: the
// first row below the band, whichever rank holds it, zeros at the frame's
// bottom), dW's partials and sum (the band's share) and dx.
// The bf16 variant's (the *_bf16 launchers) takes xp, W, yhat, g and dzp in
// bf16 and writes dz, dW and dx in bf16, as the bf16 backward, W read as it
// lies (no split).
// ---------------------------------------------------------------------------
namespace {

// the IN backward's partials over the band's output rows, T the step's
// element type
template <class T>
int band_bwd_part(const T* g, const T* yhat, float* part, int n, int h, int w_, int co,
                  cudaStream_t stream) {
  const int pixels = 4 * h * w_;
  const int tiles = (pixels + IN_TILE - 1) / IN_TILE;
  if (tiles == 0) return 0;  // an empty band: the caller's partials are zeros
  in_bwd_partial_kernel<<<dim3((unsigned)(n * tiles), (unsigned)((co + 127) / 128)), 128, 0,
                          stream>>>(g, yhat, part, pixels, co, tiles);
  return (int)cudaGetLastError();
}

// the means over the frame's frame_pixels from every rank's partials
// (tiles, the largest band's, a rank), then dz; given w, W's split into
// wsplit in the same launch (the fp32 dgrad's B operand)
template <class T>
int band_bwd_dz(const float* parts, float* means, const T* g, const T* yhat, const float* stats,
                T* dz, const float* w, float* wsplit, int ranks, int tiles,
                long long frame_pixels, int n, int h, int w_, int ci, int co,
                cudaStream_t stream) {
  const int pixels = 4 * h * w_;
  in_bwd_merge_kernel<<<dim3((unsigned)((co + MG_LANES - 1) / MG_LANES), (unsigned)n),
                        MG_LANES * MG_WARPS, 0, stream>>>(parts, means, co, tiles, frame_pixels,
                                                          ranks, (long long)n * tiles * 2 * co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_sample = (long long)pixels * co;
  const long long total4 = n * per_sample / 4;
  const int apply_blocks = (int)((total4 + 255) / 256);
  const long long w4 = w ? (long long)9 * ci * co / 4 : 0;
  if (apply_blocks == 0 && w4 == 0) return 0;
  in_bwd_apply_kernel<<<(unsigned)(apply_blocks + (w4 + 255) / 256), 256, 0, stream>>>(
      g, yhat, stats, means, dz, total4, per_sample, co, apply_blocks,
      reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(wsplit), w4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nemar_convt_band_bwd_part(const float* g, const float* yhat, float* part, int n,
                                         int h, int w_, int co, cudaStream_t stream) {
  return band_bwd_part(g, yhat, part, n, h, w_, co, stream);
}

extern "C" int nemar_convt_band_bwd_dz(const float* parts, float* means, const float* g,
                                       const float* yhat, const float* stats, float* dz,
                                       const float* w, float* wsplit, int ranks, int tiles,
                                       long long frame_pixels, int n, int h, int w_, int ci,
                                       int co, cudaStream_t stream) {
  return band_bwd_dz(parts, means, g, yhat, stats, dz, w, wsplit, ranks, tiles, frame_pixels,
                     n, h, w_, ci, co, stream);
}

extern "C" int nemar_convt_band_bwd_dx(const float* xp, const float* dzp, const float* wsplit,
                                       float* part_w, float* dw, float* dx, int n, int h, int w_,
                                       int ci, int co, int splits, int pix_per_split,
                                       cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int total = n * h * w_;
  err = co <= 64
            ? wgrad<64, true>(xp, dzp, part_w, h, w_, ci, co, total, splits, pix_per_split, stream)
            : wgrad<128, true>(xp, dzp, part_w, h, w_, ci, co, total, splits, pix_per_split,
                               stream);
  if (err != cudaSuccess) return (int)err;
  const long long w4 = (long long)9 * ci * co / 4;
  split_sum_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw, w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool narrow = ci <= 64 || (long long)((total + BM - 1) / BM) * ((ci + 127) / 128) < sms;
  err = narrow ? dgrad<64, true>(dzp, wsplit, dx, h, w_, ci, co, total, stream)
               : dgrad<128, true>(dzp, wsplit, dx, h, w_, ci, co, total, stream);
  return (int)err;
}

extern "C" int nemar_convt_band_bwd_part_bf16(const bf16* g, const bf16* yhat, float* part, int n,
                                              int h, int w_, int co, cudaStream_t stream) {
  return band_bwd_part(g, yhat, part, n, h, w_, co, stream);
}

extern "C" int nemar_convt_band_bwd_dz_bf16(const float* parts, float* means, const bf16* g,
                                            const bf16* yhat, const float* stats, bf16* dz,
                                            int ranks, int tiles, long long frame_pixels, int n,
                                            int h, int w_, int co, cudaStream_t stream) {
  return band_bwd_dz(parts, means, g, yhat, stats, dz, nullptr, nullptr, ranks, tiles,
                     frame_pixels, n, h, w_, 0, co, stream);
}

extern "C" int nemar_convt_band_bwd_dx_bf16(const bf16* xp, const bf16* dzp, const bf16* w,
                                            float* part_w, bf16* dw, bf16* dx, int n, int h,
                                            int w_, int ci, int co, int splits, int pix_per_split,
                                            cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int total = n * h * w_;
  err = co <= 64 ? wgrad16<64, true>(xp, dzp, part_w, h, w_, ci, co, total, splits,
                                     pix_per_split, stream)
                 : wgrad16<128, true>(xp, dzp, part_w, h, w_, ci, co, total, splits,
                                      pix_per_split, stream);
  if (err != cudaSuccess) return (int)err;
  const long long w4 = (long long)9 * ci * co / 4;
  split_sum16_kernel<<<(unsigned)((w4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part_w), dw, w4, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool narrow = ci <= 64 || (long long)((total + BM - 1) / BM) * ((ci + 127) / 128) < sms;
  return (int)(narrow ? dgrad16<64, true>(dzp, w, dx, h, w_, ci, co, total, stream)
                      : dgrad16<128, true>(dzp, w, dx, h, w_, ci, co, total, stream));
}
