// K-warp-bwd: backward of K-warp (the bilinear grid sample from the
// normalised grid, warp_fwd.cu), from (img, grid, g = d out) to (d img,
// d grid).
//
// Replaces the TPU kernel nemar_tpu/ops/warp_pallas.py:_bwd_pallas
// (_bwd_kernel), reached through _warp_core's custom VJP, and its
// shift-gather variant _bwd_shift_pallas, together with the XLA VJP of the
// coordinate transform the JAX package runs around them. At every output
// pixel p, with the source coordinates (x, y) = (sx(gx), sy(gy)) of its grid
// entry (padding mode and align_corners applied, warp_coords.cuh), the
// four taps v.. (zero out of frame) and the fractional parts (wx, wy):
//
//   d x[p]   = sum_c g[p, c] * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)
//   d y[p]   = sum_c g[p, c] * ((v10 - v00) * (1 - wx) + (v11 - v01) * wx)
//   d grid[p] = (d x[p] * sx'(gx), d y[p] * sy'(gy))
//   d img[t, c] += g[p, c] * weight_k   for each in-frame tap k of p at t,
//                                        only for c < grad_channels
//
// as the JAX package differentiates its gather, with its conventions at
// the clip's ties (warp_coords.cuh: source_coord_slope). The channels from
// grad_channels on get exact zeros: the model warps (fake_B, real_A) in one
// call and real_A is data.
//
// What bounds it on the H100: bytes. d grid is a gather per output pixel,
// as K-warp. d img is a scatter (several output pixels may read one source
// pixel) that must be deterministic: float atomics would change the sum's
// order, and so its rounding, from run to run, while the JAX step is
// bit-deterministic. An earlier design summed with 64-bit integer atomics in
// global memory (12 a pixel at 3 channels), after a pass for max |g| and
// two memsets, then converted, with the coordinate chain in torch autograd
// around it: 22 launches at batch 8, several times the library's time
// (PERF.md).
// Here each block owns a tile of d img, so no sum crosses blocks and
// there are no global atomics, memsets or conversion pass. Two launches:
//
//   1. One thread per output pixel (blocks of 32 x 8): the coordinate
//      transform and its slope, the four taps (float4 reads for C % 4 ==
//      0), d x, d y in fp32 in channel order, d grid. For each 4 x 4 output
//      sub-tile it also writes the box (in source pixels) that its in-frame
//      taps cover and its max |g| over the first grad_channels channels,
//      and for the block the union of its 16 boxes.
//   2. One block per TS x TS source tile S (TS = 32 for up to 4 gradient
//      channels). It lists the launch-1 blocks whose boxes meet S, then
//      their sub-tiles that do, recomputes those pixels' taps and weights
//      (the same functions as launch 1), two pixels a thread in flight, and
//      adds g * weight for the taps in S to a fixed-point sum per (pixel,
//      channel) in shared memory; then it writes its tile of d img. Each
//      contribution is rounded once to an integer multiple of 2^(e - 30),
//      max |g| < 2^e over the sub-tiles the block reads (every pixel of S is
//      summed by this block alone, so the scale is the block's own), which
//      fits 32 bits; the sums are 64-bit, kept as two 32-bit halves that
//      take the card's native shared atomics (a 64-bit shared atomicAdd
//      compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64 on sm_90a).
//      Integer sums are exact, so their order does not matter; the rounding
//      is at most 2^-31 max|g| a contribution, far below fp32's. For the
//      model's fields of a few pixels a source tile reads its own 64
//      sub-tiles and the ring around them (~100, 1.6 x the pixels it owns,
//      from L2); a field that moves pixels far makes it read more, and
//      stays exact.
//
// A non-finite g is left out of max |g| and flagged with the sub-tile's
// max (its sign bit). A block that reads a flagged sub-tile scatters once
// more, marking the sums that take a non-finite g * weight, and writes
// +inf, -inf or NaN there, as fp32 adds would: d img then agrees with the
// plain version and the JAX package, not only d grid.
//
// Layouts: img, dimg (N, H, W, C) fp32; grid, dgrid (N, Ho, Wo, 2) fp32; g
// (N, Ho, Wo, C) fp32; the workspace holds per launch-1 block (N,
// ceil(Ho/8), ceil(Wo/32)) its box, then its 16 sub-tiles' boxes, then their
// max |g| (int4 x0, x1, y0, y1 inclusive, x0 > x1 when empty; float, its
// sign set for a non-finite g). All contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "warp_coords.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 4;               // output sub-tile side
constexpr int BW1 = 32, BH1 = 8;     // launch 1's block: 32 x 8 output pixels
constexpr int SUBS1 = (BW1 / SUB) * (BH1 / SUB);  // 16 sub-tiles a launch-1 block
constexpr int ACC_WORDS = 4096;      // launch 2's shared sums, 64 bits each
constexpr int BLIST = 256;           // launch 2: launch-1 blocks whose boxes meet its tile
constexpr int LIST = 1024;           // launch 2: sub-tiles whose boxes meet its tile
constexpr int ILP = 2;               // launch 2: pixels a thread has in flight

struct Pixel {
  warp::Taps t;
  float sx, sy;  // d source coordinate / d grid coordinate
};

__device__ __forceinline__ Pixel pixel_at(const float2* __restrict__ grid, long long p, int h,
                                          int w, int padding, bool align) {
  const float2 gxy = grid[p];
  Pixel px;
  const float x = warp::source_coord_slope(gxy.x, w, padding, align, px.sx);
  const float y = warp::source_coord_slope(gxy.y, h, padding, align, px.sy);
  px.t = warp::make_taps(x, y, h, w);
  return px;
}

template <int kWidth>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static T make(const float* v) { return v[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
  __device__ static T make(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
};

__device__ __forceinline__ int4 box_union(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), max(a.y, b.y), min(a.z, b.z), max(a.w, b.w));
}

__device__ __forceinline__ int4 shfl_box(int4 v, int off) {
  return make_int4(__shfl_xor_sync(0xffffffffu, v.x, off), __shfl_xor_sync(0xffffffffu, v.y, off),
                   __shfl_xor_sync(0xffffffffu, v.z, off), __shfl_xor_sync(0xffffffffu, v.w, off));
}

// launch 1
template <int kWidth>
__global__ void __launch_bounds__(THREADS)
warp_bwd_grid_kernel(const float* __restrict__ img, const float2* __restrict__ grid,
                     const float* __restrict__ g, float2* __restrict__ dgrid,
                     int4* __restrict__ bboxes, int4* __restrict__ sboxes,
                     float* __restrict__ sgmax, int h, int w, int c, int ho, int wo, int gc,
                     int padding, bool align) {
  using V = Vec<kWidth>;
  using T = typename V::T;
  const int tid = threadIdx.x, lane = tid & 31, warp_id = tid >> 5;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * BW1 + lane, oy = blockIdx.y * BH1 + warp_id;
  int4 box = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  float gm = 0.f;  // max |g| over the finite values
  int bad = 0;     // a non-finite g was seen
  if (ox < wo && oy < ho) {
    const long long p = ((long long)b * ho + oy) * wo + ox;
    const Pixel px = pixel_at(grid, p, h, w, padding, align);
    const warp::Taps& t = px.t;
    const T* base = reinterpret_cast<const T*>(img + (size_t)b * h * w * c);
    const T* gp = reinterpret_cast<const T*>(g + (size_t)p * c);
    const int cv = c / kWidth;
    float ddx = 0.f, ddy = 0.f;
    for (int q = 0; q < cv; ++q) {
      T v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = base[(size_t)t.off[k] * cv + q];
      const T gv4 = gp[q];
#pragma unroll
      for (int i = 0; i < kWidth; ++i) {
        float vv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) vv[k] = t.valid[k] ? V::get(v[k], i) : 0.f;
        const float gv = V::get(gv4, i);
        ddx += gv * ((vv[1] - vv[0]) * (1.f - t.wy) + (vv[3] - vv[2]) * t.wy);
        ddy += gv * ((vv[2] - vv[0]) * (1.f - t.wx) + (vv[3] - vv[1]) * t.wx);
        if (q * kWidth + i < gc) {
          if (isfinite(gv)) gm = fmaxf(gm, fabsf(gv));
          else bad = 1;
        }
      }
    }
    dgrid[p] = make_float2(ddx * px.sx, ddy * px.sy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.valid[k]) continue;
      const int ix = t.x0 + (k & 1), iy = t.y0 + (k >> 1);
      box = box_union(box, make_int4(ix, ix, iy, iy));
    }
  }
  if (gc == 0) return;
  // the box and max |g| of each 4 x 4 sub-tile: lanes 4s .. 4s + 3 of warps
  // (rows) 4r .. 4r + 3 are sub-tile (r, s), s < 8, r < 2, of this block.
  // The max is stored with its sign set where a non-finite g was seen.
#pragma unroll
  for (int off = 1; off < SUB; off <<= 1) {
    box = box_union(box, shfl_box(box, off));
    gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, off));
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  __shared__ int4 sbox[BH1][BW1 / SUB];
  __shared__ float sgm[BH1][BW1 / SUB];
  if ((lane & (SUB - 1)) == 0) {
    sbox[warp_id][lane / SUB] = box;
    sgm[warp_id][lane / SUB] = copysignf(gm, bad ? -1.f : 1.f);
  }
  __syncthreads();
  if (warp_id != 0) return;
  // warp 0: lane t < 16 takes sub-tile (t / 8, t % 8); the block's box is
  // their union
  box = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  gm = 0.f;
  bad = 0;
  if (lane < SUBS1) {
    const int r = lane / (BW1 / SUB), col = lane % (BW1 / SUB);
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      box = box_union(box, sbox[SUB * r + k][col]);
      gm = fmaxf(gm, fabsf(sgm[SUB * r + k][col]));
      bad |= signbit(sgm[SUB * r + k][col]);
    }
  }
  const int blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (lane < SUBS1) {
    sboxes[(size_t)blk * SUBS1 + lane] = box;
    sgmax[(size_t)blk * SUBS1 + lane] = copysignf(gm, bad ? -1.f : 1.f);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) box = box_union(box, shfl_box(box, off));
  if (lane == 0) bboxes[blk] = box;
}

__device__ __forceinline__ bool meets(int4 bb, int x0, int y0, int ts) {
  return bb.x <= bb.y && bb.x < x0 + ts && bb.y >= x0 && bb.z < y0 + ts && bb.w >= y0;
}

// the top-left output pixel of sub-tile s of launch-1 block blk (of a
// sample's nbx1 x nby1), packed as oy << 16 | ox
__device__ __forceinline__ int sub_origin(int blk, int s, int nbx1) {
  const int by = blk / nbx1, bx = blk - by * nbx1;
  return ((by * BH1 + (s / (BW1 / SUB)) * SUB) << 16) | (bx * BW1 + (s % (BW1 / SUB)) * SUB);
}

// word i of the tile's sums += v, exactly: the 64-bit sum is kept as 32-bit
// halves (lo unsigned, hi signed) with the card's native 32-bit shared
// atomics; hi takes v's sign extension plus lo's carry, when they do not
// cancel. Every add commutes, so the sum does not depend on the order.
__device__ __forceinline__ void add_fixed(unsigned* lo, int* hi, int i, int v) {
  const unsigned u = (unsigned)v;
  const unsigned old = atomicAdd(lo + i, u);
  const int dhi = (v < 0 ? -1 : 0) + (old + u < old ? 1 : 0);
  if (dhi != 0) atomicAdd(hi + i, dhi);
}

// Adds the taps of output pixels q0 + u * THREADS (u < ILP) that fall in
// the tile to the shared fixed-point sums. Pixel q is pixel q % 16 of the
// sub-tile whose packed origin is origin_of(q / 16) (none when that is -1).
// Both pixels' loads are issued before their uses. With kFlags it marks
// instead, in lo, the sums that take a non-finite g * weight: 1 +inf, 2
// -inf, 4 NaN.
template <int kWidth, bool kFlags, class OriginOf>
__device__ __forceinline__ void scatter_pixels(int q0, int nq, OriginOf origin_of,
                                               const float2* __restrict__ grid,
                                               const float* __restrict__ g, unsigned* lo, int* hi,
                                               int b, int h, int w, int c, int ho, int wo, int gc,
                                               int padding, bool align, int x0, int y0, int ts,
                                               float scale) {
  using V = Vec<kWidth>;
  using T = typename V::T;
  long long pix[ILP];
  float2 gxy[ILP];
#pragma unroll
  for (int u = 0; u < ILP; ++u) {
    const int q = q0 + u * THREADS;
    pix[u] = -1;
    if (q < nq) {
      const int org = origin_of(q / (SUB * SUB)), l = q % (SUB * SUB);
      const int ox = (org & 0xffff) + l % SUB, oy = (org >> 16) + l / SUB;
      if (org >= 0 && ox < wo && oy < ho) pix[u] = ((long long)b * ho + oy) * wo + ox;
    }
    if (pix[u] >= 0) gxy[u] = grid[pix[u]];
  }
  int slot[ILP][4];
  float wgt[ILP][4];
  T gq[ILP][(4 + kWidth - 1) / kWidth];
#pragma unroll
  for (int u = 0; u < ILP; ++u) {
    if (pix[u] < 0) continue;
    const warp::Taps t = warp::make_taps(warp::source_coord(gxy[u].x, w, padding, align),
                                         warp::source_coord(gxy[u].y, h, padding, align), h, w);
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lx = t.x0 + (k & 1) - x0, ly = t.y0 + (k >> 1) - y0;
      const bool in = t.valid[k] && (unsigned)lx < (unsigned)ts && (unsigned)ly < (unsigned)ts;
      slot[u][k] = in ? (ly * ts + lx) * gc : -1;
      wgt[u][k] = t.wgt[k];
      any |= in;
    }
    if (!any) {
      pix[u] = -1;
      continue;
    }
    // the first (up to) 4 gradient channels now; more are read below
    const T* gp = reinterpret_cast<const T*>(g + (size_t)pix[u] * c);
#pragma unroll
    for (int i = 0; i < (4 + kWidth - 1) / kWidth; ++i)
      if (i * kWidth < gc) gq[u][i] = gp[i];
  }
#pragma unroll
  for (int u = 0; u < ILP; ++u) {
    if (pix[u] < 0) continue;
    auto add = [&](int ch, float gv) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (slot[u][k] < 0) continue;
        if constexpr (kFlags) {
          const float p = gv * wgt[u][k];
          if (!isfinite(p)) atomicOr(lo + slot[u][k] + ch, isnan(p) ? 4u : (p > 0.f ? 1u : 2u));
        } else {
          const int v = __float2int_rn(gv * wgt[u][k] * scale);
          if (v != 0) add_fixed(lo, hi, slot[u][k] + ch, v);
        }
      }
    };
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (ch < gc) add(ch, V::get(gq[u][ch / kWidth], ch % kWidth));
    const float* gp = g + (size_t)pix[u] * c;
    for (int ch = 4; ch < gc; ++ch) add(ch, gp[ch]);
  }
}

// launch 2: one block per ts x ts source tile, ts = 1 << ts_log2
template <int kWidth>
__global__ void __launch_bounds__(THREADS)
warp_bwd_img_kernel(const float2* __restrict__ grid, const float* __restrict__ g,
                    const int4* __restrict__ bboxes, const int4* __restrict__ sboxes,
                    const float* __restrict__ sgmax, float* __restrict__ dimg, int h, int w, int c,
                    int ho, int wo, int gc, int padding, bool align, int ts_log2) {
  extern __shared__ unsigned sums[];  // ts * ts * gc low halves, then as many high halves
  __shared__ int blist[BLIST];
  __shared__ int list[LIST];
  __shared__ int nblk, count;
  __shared__ float warp_m[THREADS / 32];
  using V = Vec<kWidth>;
  using T = typename V::T;
  const int tid = threadIdx.x, lane = tid & 31, warp_id = tid >> 5;
  const int b = blockIdx.z, ts = 1 << ts_log2;
  const int x0 = blockIdx.x * ts, y0 = blockIdx.y * ts;
  const int words = ts * ts * gc;
  unsigned* lo = sums;
  int* hi = reinterpret_cast<int*>(sums + words);
  for (int i = tid; i < 2 * words; i += THREADS) sums[i] = 0u;
  if (tid == 0) nblk = count = 0;
  const int nbx1 = (wo + BW1 - 1) / BW1, nb1 = nbx1 * ((ho + BH1 - 1) / BH1);
  const int4* bb = bboxes + (size_t)b * nb1;
  const int4* sb = sboxes + (size_t)b * nb1 * SUBS1;
  const float* sg = sgmax + (size_t)b * nb1 * SUBS1;
  __syncthreads();

  // the launch-1 blocks whose boxes meet this tile, then their sub-tiles
  // that do: a list of those (in no particular order: the integer sums do
  // not depend on it) and their max |g|
  for (int i = tid; i < nb1; i += THREADS) {
    if (meets(bb[i], x0, y0, ts)) {
      const int at = atomicAdd(&nblk, 1);
      if (at < BLIST) blist[at] = i;
    }
  }
  __syncthreads();
  const int nl = nblk;
  float gm = 0.f;
  int bad = 0;
  auto visit = [&](int blk, int s) {
    const int sub = blk * SUBS1 + s;
    if (meets(sb[sub], x0, y0, ts)) {
      gm = fmaxf(gm, fabsf(sg[sub]));
      bad |= signbit(sg[sub]);
      const int at = atomicAdd(&count, 1);
      if (at < LIST) list[at] = sub_origin(blk, s, nbx1);
    }
  };
  if (nl <= BLIST) {
    for (int j = tid; j < nl * SUBS1; j += THREADS) visit(blist[j / SUBS1], j % SUBS1);
  } else {
    for (int j = tid; j < nb1 * SUBS1; j += THREADS) visit(j / SUBS1, j % SUBS1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, off));
  if (lane == 0) warp_m[warp_id] = gm;
  const bool any_bad = __syncthreads_or(bad);
  gm = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) gm = fmaxf(gm, warp_m[i]);
  const int total = count;
  // 2^(30 - e) with max |g| < 2^e: every contribution |g w| scale < 2^30
  int e = 0;
  if (gm > 0.f) frexpf(gm, &e);
  const float scale = gm > 0.f ? ldexpf(1.f, 30 - e) : 0.f;

  auto scatter = [&](auto flags) {
    constexpr bool kFlags = decltype(flags)::value;
    if (total <= LIST) {
      for (int q0 = tid; q0 < total * SUB * SUB; q0 += ILP * THREADS)
        scatter_pixels<kWidth, kFlags>(q0, total * SUB * SUB, [&](int j) { return list[j]; },
                                       grid, g, lo, hi, b, h, w, c, ho, wo, gc, padding, align,
                                       x0, y0, ts, scale);
    } else {
      // more sub-tiles than the list holds (a field that gathers from far):
      // every sub-tile in turn, those that meet the tile only
      for (int q0 = tid; q0 < nb1 * SUBS1 * SUB * SUB; q0 += ILP * THREADS)
        scatter_pixels<kWidth, kFlags>(
            q0, nb1 * SUBS1 * SUB * SUB,
            [&](int j) {
              return meets(sb[j], x0, y0, ts) ? sub_origin(j / SUBS1, j % SUBS1, nbx1) : -1;
            },
            grid, g, lo, hi, b, h, w, c, ho, wo, gc, padding, align, x0, y0, ts, scale);
    }
  };
  if (scale > 0.f) scatter(std::false_type{});
  __syncthreads();
  // this tile of d img: the sums times 2^(e - 30) (exact before the rounding
  // to fp32), zeros past grad_channels; a thread per pixel
  const double inv = scale > 0.f ? ldexp(1.0, e - 30) : 0.0;
  const int cv = c / kWidth;
  for (int lp = tid; lp < ts * ts; lp += THREADS) {
    const int ly = lp >> ts_log2, lx = lp & (ts - 1);
    if (y0 + ly >= h || x0 + lx >= w) continue;
    T* out = reinterpret_cast<T*>(dimg + (((size_t)b * h + y0 + ly) * w + x0 + lx) * c);
    for (int q = 0; q < cv; ++q) {
      float v[kWidth];
#pragma unroll
      for (int i = 0; i < kWidth; ++i) {
        const int ch = q * kWidth + i, k = lp * gc + ch;
        v[i] = ch < gc ? (float)((double)(long long)(((unsigned long long)(unsigned)hi[k] << 32) |
                                                     lo[k]) * inv)
                       : 0.f;
      }
      out[q] = V::make(v);
    }
  }
  if (!any_bad) return;
  // A non-finite g: the sums that took a non-finite g * weight get what
  // fp32 adds give, +-inf or NaN (the finite sum above holds elsewhere).
  // lo is reused for the marks.
  __syncthreads();
  for (int i = tid; i < words; i += THREADS) lo[i] = 0u;
  __syncthreads();
  scatter(std::true_type{});
  __syncthreads();
  for (int k = tid; k < words; k += THREADS) {
    const unsigned f = lo[k];
    const int lp = k / gc, ch = k - lp * gc;
    const int ly = lp >> ts_log2, lx = lp & (ts - 1);
    if (f == 0u || y0 + ly >= h || x0 + lx >= w) continue;
    const int bits = f == 1u ? 0x7f800000 : (f == 2u ? (int)0xff800000u : 0x7fc00000);
    dimg[(((size_t)b * h + y0 + ly) * w + x0 + lx) * c + ch] = __int_as_float(bits);
  }
}

template <int kWidth>
int launch(const float* img, const float* grid, const float* g, float* dimg, float* dgrid,
           int* work, int n, int h, int w, int c, int ho, int wo, int gc, int padding, bool align,
           cudaStream_t stream) {
  const dim3 g1((unsigned)((wo + BW1 - 1) / BW1), (unsigned)((ho + BH1 - 1) / BH1), (unsigned)n);
  const size_t nb1 = (size_t)n * g1.x * g1.y;
  int4* bboxes = reinterpret_cast<int4*>(work);
  int4* sboxes = bboxes + nb1;
  float* sgmax = reinterpret_cast<float*>(sboxes + nb1 * SUBS1);
  warp_bwd_grid_kernel<kWidth><<<g1, THREADS, 0, stream>>>(
      img, reinterpret_cast<const float2*>(grid), g, reinterpret_cast<float2*>(dgrid), bboxes,
      sboxes, sgmax, h, w, c, ho, wo, gc, padding, align);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || gc == 0 || (long long)h * w == 0) return (int)err;
  int ts_log2 = 5;
  while (ts_log2 > 2 && (gc << (2 * ts_log2)) > ACC_WORDS) --ts_log2;
  if ((gc << (2 * ts_log2)) > ACC_WORDS) return (int)cudaErrorInvalidValue;
  const int ts = 1 << ts_log2;
  const dim3 g2((unsigned)((w + ts - 1) / ts), (unsigned)((h + ts - 1) / ts), (unsigned)n);
  warp_bwd_img_kernel<kWidth><<<g2, THREADS, (size_t)ts * ts * gc * 8, stream>>>(
      reinterpret_cast<const float2*>(grid), g, bboxes, sboxes, sgmax, dimg, h, w, c, ho, wo, gc,
      padding, align, ts_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Int32 words of the workspace: per launch-1 block its box, and its 16
// sub-tiles' boxes and max |g|.
extern "C" long long nemar_warp_grid_bwd_work_words(int n, int ho, int wo) {
  const long long blocks = (long long)n * ((wo + BW1 - 1) / BW1) * ((ho + BH1 - 1) / BH1);
  return blocks * (4 + SUBS1 * 5);
}

// padding: 0 zeros, 1 border, 2 reflection; gc <= 256 (the shared sums'
// room at a 4 x 4 tile). dimg may be null when gc == 0. img and g 16-byte
// aligned for the float4 path, grid 8-byte aligned.
extern "C" int nemar_warp_grid_bwd(const float* img, const float* grid, const float* g,
                                   float* dimg, float* dgrid, int* work, int n, int h, int w,
                                   int c, int ho, int wo, int gc, int padding, int align_corners,
                                   cudaStream_t stream) {
  if ((long long)n * ho * wo == 0) return (int)cudaSuccess;
  const bool vec4 = c % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(dimg)) % 16 == 0;
  return vec4 ? launch<4>(img, grid, g, dimg, dgrid, work, n, h, w, c, ho, wo, gc, padding,
                          align_corners != 0, stream)
              : launch<1>(img, grid, g, dimg, dgrid, work, n, h, w, c, ho, wo, gc, padding,
                          align_corners != 0, stream);
}
