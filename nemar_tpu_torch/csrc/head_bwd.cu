// K-head-bwd: the backward of K-head (head_fwd.cu),
//
//   out[n, y, x, co] = sum_{dy, dx, ci} xpad[n, y + dy, x + dx, ci] * W[dy, dx, ci, co],
//   xpad = x reflect-padded by 3,
//
// given g = d out: dX and dW (the bias's gradient, g summed, is the
// caller's).
//
// Replaces the TPU kernels nemar_tpu/ops/conv_head_roll.py:_bwd_kernel
// (B4) and nemar_tpu/ops/attic/conv_head.py:_bwd_kernel (B6).
//
// What bounds it on the H100: arithmetic. dX and dW each cost the
// forward's 2 N H W 49 Ci Co operations (9.87 GFLOP at 8 x 256 x 256 x 64 ->
// 3), 0.06 ms each in 3xTF32 at the 495 TFLOP/s TF32 peak; the bytes (x read,
// dx written: 134 MB each at batch 8) take 0.08 ms at 3.35 TB/s.
//
// With q a position of the reflect-padded frame, (H + 6) x (W + 6), tap =
// (dy, dx) and g0 g zero-extended outside the image, both halves are GEMMs
// whose narrow dimension is (tap, co), of length 49 Co (147 on the model's
// path, where Co = 3):
//
//   dW:  Dw[ci, (tap, co)] = sum_q xpad[q, ci] g0[q - tap, co]
//   dX:  Dx[q, ci] = sum_{(tap, co)} g0[q - tap, co] W[tap, ci, co],
//        dx = the reflect pad's adjoint of Dx (the fold).
//
// Folding the 49 taps into the GEMM (as the TPU kernel folds its 7 dy-taps
// into M) keeps Co = 3 from being a dimension of its own: a wgmma is at
// least 8 wide and would waste 5/8 of it. Both GEMMs run on the tensor
// cores in 3xTF32 (gemm_tc.cuh's split, and its order of three MMAs in
// chains of one 32-deep K slice added to an fp32 total), with wgmma and A
// from registers. The padded frame is cut into tiles of tr x tc positions
// (ops/conv_head.py:head_bwd_plan; tr, tc and the grids come from there);
// a tile's g window, (tr + 6) x (tc + 6) x Co floats (at most GW_MAX), is
// what both GEMMs read g from. Three launches:
//
//   1. dW partials (head_wgrad_kernel): M = 64 input channels, N = 160
//      columns of (tap, co) (two warpgroups of m64n80k8), K = the tile's
//      positions in 32-deep slices. A is x, read through the reflect index
//      (a table per tile) into a 3-stage cp.async ring, ci contiguous per
//      position (M-major, as gemm_wgmma_mn_kernel's A). B, the im2col of
//      g0, is built per slice from the window into the swizzled K-major
//      layout, split into big and small as it is written, double-buffered
//      so that the next slice's B is built while the tensor cores run this
//      one's. A block walks the tiles blockIdx.x, + gridDim.x, ... (a
//      persistent grid of at most one block a SM) and writes its sums once:
//      part[block] (split-K over blocks, not tiles).
//   2. Dx (head_dgrad_kernel): M = 64 positions of a tile (a warpgroup's
//      wgmma rows), N = 64 input channels (32 when Co > 3, so that W fits),
//      K = 49 Co (152 at Co = 3: 19 steps of 8). B is W, split once a block
//      into shared memory; A, the same im2col of g0, is gathered from the
//      window straight into the fragment registers (no shared-memory
//      copy). Three warpgroups a block, each walking tiles of its own with
//      its window double-buffered (cp.async prefetch of the next). Rows in
//      the image are written to dx; rows in the frame around it (the
//      3-wide border of the padded frame) to a frame scratch.
//   3. finish (head_bwd_finish_kernel): dW = the blocks' partials summed in
//      block order in fp64, and the fold: each image pixel within 3 of an
//      edge adds the frame positions that reflect onto it, in the fixed
//      order of sources() (rows, then columns).
//
// No float atomics: every output is one thread's fixed sequence of MMAs
// and adds, so two identical calls are bit-identical.
//
// Layouts: x, dx (N, H, W, Ci); g (N, H, W, Co); W, dW (7, 7, Ci, Co) HWIO;
// part (dw_blocks, 49, Ci, Co); frame (N, 6 (W + 6) + 6 H, Ci), the frame's
// positions in frame_index order. All fp32. Requirements (checked by the
// wrapper and here): H, W >= 4, 1 <= Co <= 8, the plan's tile within
// TILE_MAX positions and its window within GW_MAX floats.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

using tc::BK;

constexpr int K7 = 7;
constexpr int PAD = 3;
constexpr int HALO = 2 * PAD;       // a position's taps reach 6 rows and columns back
constexpr int NTAP = K7 * K7;
constexpr int GW_MAX = 4096;        // floats of a tile's g window
constexpr int TILE_MAX = 1024;      // positions of a tile
constexpr int TAB = TILE_MAX + BK;  // a tile's position tables, whole slices

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The padded indices i in [-3, n + 2] (image coordinates) with
// reflect(i) == u, u itself first; returns how many (1 to 3). The fold
// (head_bwd_finish_kernel) sums them in this order.
inline int sources(int u, int n, int (&src)[3]) {
  int k = 0;
  src[k++] = u;
  if (u >= 1 && u <= PAD) src[k++] = -u;
  const int hi = 2 * n - 2 - u;
  if (hi >= n && hi <= n - 1 + PAD) src[k++] = hi;
  return k;
}

// 4 bytes from device to shared memory, asynchronously; zero when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// Sizes of one call, and its tiles: the padded frame of each sample cut
// into ty x cx tiles of tr x tc positions, numbered (sample, tile row,
// tile column) with the column fastest.
struct Geometry {
  int n, h, w, ci, co;
  int tr, tc, ty, cx, tiles;
  int hp, wp, ww;  // the padded frame (H + 6, W + 6); the window's row length tc + 6
  int fsz;         // frame positions of a sample: 6 (W + 6) + 6 H
  // the image rows and columns that padded ones fold onto, ascending (at
  // most 6 of each: 1..3 and H-4..H-2, or W-4..W-2; 0 too when H or W is 4)
  int frows[2 * PAD], nfrows, fcols[2 * PAD], nfcols;

  __device__ void tile(int t, int& img, int& i0, int& j0) const {
    img = t / (ty * cx);
    const int r = t - img * ty * cx;
    i0 = (r / cx) * tr;
    j0 = (r % cx) * tc;
  }
  // window offset of the tile's position k (row k / tc, column k % tc)
  __device__ int pos_off(int k) const {
    const int r = k / tc;
    return ((r + HALO) * ww + (k - r * tc) + HALO) * co;
  }
  // window offset, relative to a position's, of g0[q - tap, c] at column
  // n = tap Co + c of the im2col
  __device__ int tap_off(int n) const {
    const int tap = n / co, c = n - tap * co;
    const int dy = tap / K7, dx = tap - dy * K7;
    return -(dy * ww + dx) * co + c;
  }
  // the frame's position (i, j), padded coordinates, in the scratch: the 3
  // rows above, the 3 below, then the 3 columns left and right of each
  // image row
  __device__ int frame_index(int i, int j) const {
    if (i < PAD) return i * wp + j;
    if (i >= h + PAD) return (i - h) * wp + j;
    return 2 * PAD * wp + (i - PAD) * 2 * PAD + (j < PAD ? j : j - w);
  }
};

// The tile's g window: image rows i0 - 6 .. i0 + tr - 1 and columns
// j0 - 6 .. j0 + tc - 1, Co floats a position, zero outside the image;
// cp.async, 4 bytes a copy, over nthreads threads.
__device__ __forceinline__ void stage_window(float* gw, const float* __restrict__ g,
                                             const Geometry& geo, int img, int i0, int j0,
                                             int tid, int nthreads) {
  const int cols = geo.ww, total = (geo.tr + HALO) * cols * geo.co;
  const float* gb = g + (size_t)img * geo.h * geo.w * geo.co;
  for (int e = tid; e < total; e += nthreads) {
    const int pos = e / geo.co, c = e - pos * geo.co;
    const int row = pos / cols, col = pos - row * cols;
    const int y = i0 - HALO + row, xx = j0 - HALO + col;
    const bool valid = y >= 0 && y < geo.h && xx >= 0 && xx < geo.w;
    cp_async4(gw + e, valid ? gb + ((size_t)y * geo.w + xx) * geo.co + c : g, valid);
  }
}

// ---------------------------------------------------------------------------
// 1. dW partials
// ---------------------------------------------------------------------------
constexpr int W_THREADS = 256;     // two warpgroups
constexpr int W_NW = 80;           // columns (tap, co) of a warpgroup
constexpr int W_NB = 2 * W_NW;     // of a block
constexpr int W_MT = 64;           // input channels of a block
constexpr int W_XS = W_MT + 8;     // floats a position of the x ring
constexpr int W_STAGES = 3;
constexpr int W_BT = W_NB * BK;    // floats of one swizzled K-major B tile
constexpr int W_CHUNKS = W_BT / 4 / W_THREADS;  // 16-byte chunks of B a thread builds
static_assert(W_CHUNKS * 4 * W_THREADS == W_BT, "B chunks divide among the threads");
constexpr int W_SMEM = (4 * W_BT + W_STAGES * BK * W_XS + GW_MAX + 2 * TAB) * (int)sizeof(float);
constexpr int NO_COL = -(1 << 30);  // a B row past 49 Co

// x rows of slice s (positions s BK .. + 31 of the tile) into the ring:
// V floats a copy (4: 16-byte cp.async, Ci % 4 == 0; else 1)
template <int V>
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x, const int* xtab,
                                       int s, int ci0, int ci, int tid) {
  constexpr int PER_ROW = W_MT / V;
#pragma unroll
  for (int i = 0; i < BK * PER_ROW / W_THREADS; ++i) {
    const int q = tid + W_THREADS * i, k = q / PER_ROW, c = (q - k * PER_ROW) * V;
    const int pix = xtab[s * BK + k];
    const bool valid = pix >= 0 && ci0 + c < ci;
    const float* src = valid ? x + (size_t)pix * ci + ci0 + c : x;
    if constexpr (V == 4) tc::cp_async16(xs + k * W_XS + c, src, valid);
    else cp_async4(xs + k * W_XS + c, src, valid);
  }
}

// B of slice s into buffer b: B(k, n) = g0[q_k - tap_n, co_n], split into
// big and small as it is written; this thread's chunks (toff: the rows' tap
// offsets, NO_COL past 49 Co; boff: swizzled offsets; kofs: first k)
__device__ __forceinline__ void build_b(float* bt, const float* gw, const int* ptab, int s, int b,
                                        const int (&toff)[W_CHUNKS], const int (&boff)[W_CHUNKS],
                                        const int (&kofs)[W_CHUNKS]) {
  float* bb = bt + b * 2 * W_BT;
#pragma unroll
  for (int i = 0; i < W_CHUNKS; ++i) {
    uint32_t big[4] = {0u, 0u, 0u, 0u}, sm[4] = {0u, 0u, 0u, 0u};
    if (toff[i] != NO_COL) {
      const int4 p = *reinterpret_cast<const int4*>(ptab + s * BK + kofs[i]);
      tc::split_tf32(gw[p.x + toff[i]], big[0], sm[0]);
      tc::split_tf32(gw[p.y + toff[i]], big[1], sm[1]);
      tc::split_tf32(gw[p.z + toff[i]], big[2], sm[2]);
      tc::split_tf32(gw[p.w + toff[i]], big[3], sm[3]);
    }
    *reinterpret_cast<uint4*>(bb + boff[i]) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(bb + W_BT + boff[i]) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

template <int V>
__global__ void __launch_bounds__(W_THREADS, 1)
head_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, const Geometry geo) {
  extern __shared__ __align__(1024) float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);    // [buffer][big, small][W_BT], swizzled
  float* xr = bt + 4 * W_BT;                      // [W_STAGES][BK][W_XS]
  float* gw = xr + W_STAGES * BK * W_XS;          // the tile's g window
  int* ptab = reinterpret_cast<int*>(gw + GW_MAX);  // window offset of each position
  int* xtab = ptab + TAB;                         // its x pixel, or -1 off the frame

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int row0 = 16 * (warp & 3);  // this warp's fragment rows: row0 + 2 gq, + 1 (ci)
  const int ci0 = blockIdx.y * W_MT, n0 = blockIdx.z * W_NB;
  const int ncols = NTAP * geo.co, npos = geo.tr * geo.tc;
  const int slices = (npos + BK - 1) / BK;

  // this thread's chunks of B: row n = q % W_NB, k-group q / W_NB
  int toff[W_CHUNKS], boff[W_CHUNKS], kofs[W_CHUNKS];
#pragma unroll
  for (int i = 0; i < W_CHUNKS; ++i) {
    const int q = tid + W_THREADS * i, n = q % W_NB, kg = q / W_NB;
    toff[i] = n0 + n < ncols ? geo.tap_off(n0 + n) : NO_COL;
    boff[i] = tc::swizzled_off(n, kg);
    kofs[i] = 4 * kg;
  }

  float acc[W_NW / 2], part_acc[W_NW / 2];
#pragma unroll
  for (int i = 0; i < W_NW / 2; ++i) acc[i] = 0.f;

  for (int t = blockIdx.x; t < geo.tiles; t += gridDim.x) {
    int img, i0, j0;
    geo.tile(t, img, i0, j0);
    __syncthreads();  // the previous tile's window, tables and ring are consumed
    stage_window(gw, g, geo, img, i0, j0, tid, W_THREADS);
    tc::cp_async_commit();
    for (int k = tid; k < slices * BK; k += W_THREADS) {
      int pix = -1, off = geo.pos_off(0);
      if (k < npos) {
        const int r = k / geo.tc, i = i0 + r, j = j0 + k - r * geo.tc;
        off = geo.pos_off(k);
        if (i < geo.hp && j < geo.wp)
          pix = (img * geo.h + reflect(i - PAD, geo.h)) * geo.w + reflect(j - PAD, geo.w);
      }
      ptab[k] = off;
      xtab[k] = pix;
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // window and tables in place
#pragma unroll
    for (int s = 0; s < W_STAGES - 1; ++s) {
      if (s < slices) load_x<V>(xr + s * BK * W_XS, x, xtab, s, ci0, geo.ci, tid);
      tc::cp_async_commit();
    }
    build_b(bt, gw, ptab, 0, 0, toff, boff, kofs);

    for (int s = 0; s < slices; ++s) {
      tc::cp_async_wait<W_STAGES - 2>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // x of slice s and B(s) in place; the other B buffer and ring stage are free
      {
        const int nk = s + W_STAGES - 1;
        if (nk < slices) load_x<V>(xr + (nk % W_STAGES) * BK * W_XS, x, xtab, nk, ci0, geo.ci, tid);
        tc::cp_async_commit();
      }
      const float* xs = xr + (s % W_STAGES) * BK * W_XS;
      uint32_t abig[BK / 8][4], asmall[BK / 8][4];
#pragma unroll
      for (int s4 = 0; s4 < BK / 8; ++s4)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(xs + (8 * s4 + tq + 4 * r) * W_XS + row0 + 2 * gq);
          tc::split_tf32(v.x, abig[s4][2 * r], asmall[s4][2 * r]);
          tc::split_tf32(v.y, abig[s4][2 * r + 1], asmall[s4][2 * r + 1]);
        }
      const float* bb = bt + (s & 1) * 2 * W_BT + wg * W_NW * BK;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      tc::wgmma_fence_operand(part_acc);
#pragma unroll
      for (int s4 = 0; s4 < BK / 8; ++s4) {
        const uint64_t db = tc::kmajor_desc(bb + 8 * s4), ds = tc::kmajor_desc(bb + W_BT + 8 * s4);
        tc::wgmma_tf32(part_acc, asmall[s4], db, s4 > 0);
        tc::wgmma_tf32(part_acc, abig[s4], ds, 1);
        tc::wgmma_tf32(part_acc, abig[s4], db, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (s + 1 < slices)  // on the CUDA cores, beside the MMAs
        build_b(bt, gw, ptab, s + 1, (s + 1) & 1, toff, boff, kofs);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      tc::wgmma_fence_operand(part_acc);
#pragma unroll
      for (int i = 0; i < W_NW / 2; ++i) acc[i] += part_acc[i];
    }
    tc::cp_async_wait<0>();
  }

  // acc[4 j + v]: ci row0 + 2 gq + (v >> 1), column 8 j + 2 tq + (v & 1)
  float* pb = part + (size_t)blockIdx.x * NTAP * geo.ci * geo.co;
#pragma unroll
  for (int j = 0; j < W_NW / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ci = ci0 + row0 + 2 * gq + (v >> 1);
      const int col = n0 + wg * W_NW + 8 * j + 2 * tq + (v & 1);
      if (ci < geo.ci && col < ncols) {
        const int tap = col / geo.co, c = col - tap * geo.co;
        pb[((size_t)tap * geo.ci + ci) * geo.co + c] = acc[4 * j + v];
      }
    }
}

// ---------------------------------------------------------------------------
// 2. Dx
// ---------------------------------------------------------------------------
constexpr int X_WGS = 3;           // warpgroups a block, each on tiles of its own
constexpr int X_THREADS = 128 * X_WGS;

__host__ __device__ constexpr int dgrad_smem(int nt, int kslices) {
  return (2 * kslices * nt * BK + kslices * BK + X_WGS * 2 * GW_MAX) * (int)sizeof(float);
}

// tile t's window (if t is a tile) into dst by a warpgroup's cp.async, as
// one commit group
__device__ __forceinline__ void prefetch_window(float* dst, const float* __restrict__ g,
                                                const Geometry& geo, int t, int wtid) {
  if (t < geo.tiles) {
    int img, i0, j0;
    geo.tile(t, img, i0, j0);
    stage_window(dst, g, geo, img, i0, j0, wtid, 128);
  }
  tc::cp_async_commit();
}

// NT input channels a block: 64, or 32 when Co > 3 (W, split, must fit)
template <int NT>
__global__ void __launch_bounds__(X_THREADS, 1)
head_dgrad_kernel(const float* __restrict__ w, const float* __restrict__ g, float* __restrict__ dx,
                  float* __restrict__ frame, const Geometry geo, int kslices) {
  constexpr int TB = NT * BK;  // floats of one swizzled B slice
  extern __shared__ __align__(1024) float4 smem4[];
  float* wt = reinterpret_cast<float*>(smem4);  // [big, small][kslices][TB]
  int* ktab = reinterpret_cast<int*>(wt + 2 * kslices * TB);  // tap offset of each k
  float* gws = reinterpret_cast<float*>(ktab + kslices * BK);  // [X_WGS][2][GW_MAX]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wtid = tid & 127, gq = lane >> 2, tq = lane & 3;
  const int row0 = 16 * (warp & 3);  // this warp's fragment rows row0 + gq, + 8 (positions)
  const int cin0 = blockIdx.y * NT;
  const int kdim = NTAP * geo.co, ksteps = (kdim + 7) / 8, npos = geo.tr * geo.tc;

  // B(k = tap Co + co, n = ci) = W[tap, ci, co], split, swizzled K-major per slice
  for (int e = tid; e < kslices * NT * (BK / 4); e += X_THREADS) {
    const int n = e % NT, kg = (e / NT) % (BK / 4), ks = e / (NT * (BK / 4));
    const int ci = cin0 + n;
    uint32_t big[4], sm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = ks * BK + 4 * kg + j;
      float v = 0.f;
      if (k < kdim && ci < geo.ci) {
        const int tap = k / geo.co;
        v = w[((size_t)tap * geo.ci + ci) * geo.co + (k - tap * geo.co)];
      }
      tc::split_tf32(v, big[j], sm[j]);
    }
    const int off = ks * TB + tc::swizzled_off(n, kg);
    *reinterpret_cast<uint4*>(wt + off) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(wt + kslices * TB + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
  // past 49 Co, W is 0 and A reads the position itself (finite)
  for (int k = tid; k < kslices * BK; k += X_THREADS) ktab[k] = k < kdim ? geo.tap_off(k) : 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float* gwb = gws + wg * 2 * GW_MAX;
  const int nwg = gridDim.x * X_WGS;
  int t = blockIdx.x * X_WGS + wg;
  prefetch_window(gwb, g, geo, t, wtid);
  for (int it = 0; t < geo.tiles; t += nwg, ++it) {
    prefetch_window(gwb + ((it + 1) & 1) * GW_MAX, g, geo, t + nwg, wtid);
    tc::cp_async_wait<1>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this tile's window landed
    const float* gwin = gwb + (it & 1) * GW_MAX;
    int img, i0, j0;
    geo.tile(t, img, i0, j0);

    for (int m0 = 0; m0 < npos; m0 += 64) {
      int kr[2], pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kr[h] = m0 + row0 + gq + 8 * h;
        pr[h] = geo.pos_off(kr[h] < npos ? kr[h] : 0);
      }
      float acc[NT / 2], part_acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < kslices; ++ks) {
        // fragment register q: row gq + 8 (q & 1), k = 8 s4 + tq + 4 (q >> 1)
        uint32_t abig[BK / 8][4], asmall[BK / 8][4];
#pragma unroll
        for (int s4 = 0; s4 < BK / 8; ++s4) {
          const int o0 = ktab[ks * BK + 8 * s4 + tq], o1 = ktab[ks * BK + 8 * s4 + tq + 4];
          tc::split_tf32(gwin[pr[0] + o0], abig[s4][0], asmall[s4][0]);
          tc::split_tf32(gwin[pr[1] + o0], abig[s4][1], asmall[s4][1]);
          tc::split_tf32(gwin[pr[0] + o1], abig[s4][2], asmall[s4][2]);
          tc::split_tf32(gwin[pr[1] + o1], abig[s4][3], asmall[s4][3]);
        }
        const float* bb = wt + ks * TB;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        tc::wgmma_fence_operand(part_acc);
#pragma unroll
        for (int s4 = 0; s4 < BK / 8; ++s4) {
          if (ks * (BK / 8) + s4 < ksteps) {
            const uint64_t db = tc::kmajor_desc(bb + 8 * s4);
            const uint64_t ds = tc::kmajor_desc(bb + kslices * TB + 8 * s4);
            tc::wgmma_tf32(part_acc, asmall[s4], db, s4 > 0);
            tc::wgmma_tf32(part_acc, abig[s4], ds, 1);
            tc::wgmma_tf32(part_acc, abig[s4], db, 1);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        tc::wgmma_fence_operand(part_acc);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] += part_acc[i];
      }

      // acc[4 j + v]: position row0 + gq + 8 (v >> 1), channel 8 j + 2 tq + (v & 1);
      // in the image to dx, in the frame to the scratch
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kr[h] >= npos) continue;
        const int r = kr[h] / geo.tc, i = i0 + r, j = j0 + kr[h] - r * geo.tc;
        if (i >= geo.hp || j >= geo.wp) continue;
        float* dst;
        if (i >= PAD && i < geo.h + PAD && j >= PAD && j < geo.w + PAD)
          dst = dx + (((size_t)img * geo.h + i - PAD) * geo.w + j - PAD) * geo.ci;
        else
          dst = frame + ((size_t)img * geo.fsz + geo.frame_index(i, j)) * geo.ci;
#pragma unroll
        for (int jj = 0; jj < NT / 8; ++jj) {
          const int ci = cin0 + 8 * jj + 2 * tq;
          const float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
          if (ci + 1 < geo.ci && (geo.ci & 1) == 0) {
            *reinterpret_cast<float2*>(dst + ci) = make_float2(v0, v1);
          } else {
            if (ci < geo.ci) dst[ci] = v0;
            if (ci + 1 < geo.ci) dst[ci + 1] = v1;
          }
        }
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the window is free again
  }
  tc::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// 3. dW = the partials summed in block order (fp64); dx += the frame folded
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int F_GROUPS = F_THREADS / 32;  // partial sets a merge block splits among its warps

// Blocks [0, merge_blocks) merge: 32 outputs a block, warp w summing the
// partials w, w + 8, ... in fp64, then the 8 sums added in warp order. The
// rest fold, one (pixel, channel) a thread over the pixels that padded
// positions fold onto: every pixel of a fold row, and the fold columns of
// the other rows.
__global__ void __launch_bounds__(F_THREADS)
head_bwd_finish_kernel(const float* __restrict__ part, float* __restrict__ dw,
                       const float* __restrict__ frame, float* __restrict__ dx, const Geometry geo,
                       int dw_blocks, int merge_blocks) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < merge_blocks) {
    __shared__ double red[F_GROUPS][32];
    const int per = NTAP * geo.ci * geo.co, o = blockIdx.x * 32 + (tid & 31), grp = tid >> 5;
    double s = 0.0;
    if (o < per) {
#pragma unroll 4
      for (int b = grp; b < dw_blocks; b += F_GROUPS) s += (double)part[(size_t)b * per + o];
    }
    red[grp][tid & 31] = s;
    __syncthreads();
    if (grp == 0 && o < per) {
      double total = red[0][tid];
#pragma unroll
      for (int k = 1; k < F_GROUPS; ++k) total += red[k][tid];
      dw[o] = (float)total;
    }
    return;
  }
  // the fold lines, copied with constant indices (a dynamic index into the
  // parameter would copy it to local memory in every thread)
  __shared__ int frows[2 * PAD], fcols[2 * PAD];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 * PAD; ++i) {
      frows[i] = geo.frows[i];
      fcols[i] = geo.fcols[i];
    }
  }
  __syncthreads();
  const int per_img = geo.nfrows * geo.w + (geo.h - geo.nfrows) * geo.nfcols;
  const long long e = (long long)(blockIdx.x - merge_blocks) * F_THREADS + tid;
  if (e >= (long long)geo.n * per_img * geo.ci) return;
  const int ci = (int)(e % geo.ci);
  int p = (int)(e / geo.ci);
  const int img = p / per_img;
  p -= img * per_img;
  int u, v;
  if (p < geo.nfrows * geo.w) {
    u = frows[p / geo.w];
    v = p % geo.w;
  } else {
    const int q = p - geo.nfrows * geo.w;
    u = q / geo.nfcols;  // the u-th row that is not a fold row
    v = fcols[q % geo.nfcols];
    for (int i = 0; i < geo.nfrows; ++i) u += frows[i] <= u;
  }
  // sources() in fixed slots (u, -u, 2n - 2 - u), so that nothing is indexed dynamically
  const int srow[3] = {u, -u, 2 * geo.h - 2 - u}, scol[3] = {v, -v, 2 * geo.w - 2 - v};
  const bool vrow[3] = {true, u >= 1 && u <= PAD, srow[2] >= geo.h && srow[2] <= geo.h - 1 + PAD};
  const bool vcol[3] = {true, v >= 1 && v <= PAD, scol[2] >= geo.w && scol[2] <= geo.w - 1 + PAD};
  float* o = dx + (((size_t)img * geo.h + u) * geo.w + v) * geo.ci + ci;
  float s = *o;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if ((a | b) && vrow[a] && vcol[b])
        s += frame[((size_t)img * geo.fsz + geo.frame_index(srow[a] + PAD, scol[b] + PAD)) * geo.ci + ci];
  *o = s;
}

// the indices of [0, n) that others reflect onto (ascending); how many
int fold_lines(int n, int (&out)[2 * PAD]) {
  int k = 0;
  for (int u = 0; u < n && k < 2 * PAD; ++u) {
    int src[3];
    if (sources(u, n, src) > 1) out[k++] = u;
  }
  return k;
}

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// tr, tc: the tiles; dw_blocks, dx_blocks: the persistent grids of launches
// 1 and 2 (ops/conv_head.py:head_bwd_plan). part holds dw_blocks x 49 Ci Co
// floats, frame N (6 (W + 6) + 6 H) Ci.
extern "C" int nemar_conv_head_bwd(const float* x, const float* w, const float* g, float* part,
                                   float* frame, float* dx, float* dw, int n, int h, int wd,
                                   int ci, int co, int tr, int tc, int dw_blocks, int dx_blocks,
                                   cudaStream_t stream) {
  if (co < 1 || co > 8 || h <= PAD || wd <= PAD || n < 1 || ci < 1 || tr < 1 || tc < 1 ||
      tr * tc > TILE_MAX || (tr + HALO) * (tc + HALO) * co > GW_MAX || dw_blocks < 1 ||
      dx_blocks < 1)
    return (int)cudaErrorInvalidValue;
  Geometry geo;
  geo.n = n; geo.h = h; geo.w = wd; geo.ci = ci; geo.co = co;
  geo.tr = tr; geo.tc = tc;
  geo.hp = h + HALO; geo.wp = wd + HALO; geo.ww = tc + HALO;
  geo.ty = (geo.hp + tr - 1) / tr;
  geo.cx = (geo.wp + tc - 1) / tc;
  geo.tiles = n * geo.ty * geo.cx;
  geo.fsz = 2 * PAD * geo.wp + 2 * PAD * h;
  geo.nfrows = fold_lines(h, geo.frows);
  geo.nfcols = fold_lines(wd, geo.fcols);

  cudaError_t err;
  const dim3 wgrid((unsigned)dw_blocks, (unsigned)((ci + W_MT - 1) / W_MT),
                   (unsigned)((NTAP * co + W_NB - 1) / W_NB));
  if (ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    if ((err = set_smem(head_wgrad_kernel<4>, W_SMEM)) != cudaSuccess) return (int)err;
    head_wgrad_kernel<4><<<wgrid, W_THREADS, W_SMEM, stream>>>(x, g, part, geo);
  } else {
    if ((err = set_smem(head_wgrad_kernel<1>, W_SMEM)) != cudaSuccess) return (int)err;
    head_wgrad_kernel<1><<<wgrid, W_THREADS, W_SMEM, stream>>>(x, g, part, geo);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int kslices = (NTAP * co + BK - 1) / BK;
  if (co <= 3) {
    const int bytes = dgrad_smem(64, kslices);
    if ((err = set_smem(head_dgrad_kernel<64>, bytes)) != cudaSuccess) return (int)err;
    head_dgrad_kernel<64><<<dim3((unsigned)dx_blocks, (unsigned)((ci + 63) / 64)), X_THREADS, bytes,
                            stream>>>(w, g, dx, frame, geo, kslices);
  } else {
    const int bytes = dgrad_smem(32, kslices);
    if ((err = set_smem(head_dgrad_kernel<32>, bytes)) != cudaSuccess) return (int)err;
    head_dgrad_kernel<32><<<dim3((unsigned)dx_blocks, (unsigned)((ci + 31) / 32)), X_THREADS, bytes,
                            stream>>>(w, g, dx, frame, geo, kslices);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int merge_blocks = (NTAP * ci * co + 31) / 32;
  const long long fold_items =
      (long long)n * (geo.nfrows * wd + (h - geo.nfrows) * geo.nfcols) * ci;
  head_bwd_finish_kernel<<<(unsigned)(merge_blocks + (fold_items + F_THREADS - 1) / F_THREADS),
                           F_THREADS, 0, stream>>>(part, dw, frame, dx, geo, dw_blocks, merge_blocks);
  return (int)cudaGetLastError();
}
