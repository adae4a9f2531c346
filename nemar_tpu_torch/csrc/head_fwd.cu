// K-head: the ResNet generator's 7x7 output conv over a reflect-padded
// input, to few channels,
//
//   out[n, y, x, co] = sum_{dy, dx, ci} xpad[n, y + dy, x + dx, ci] * W[dy, dx, ci, co],
//   xpad = x reflect-padded by 3 (ReflectionPad2d(3)),
//
// with Co <= 8 and no bias (the caller adds it). Every column is computed
// here: the TPU kernels leave the 3 border columns on each side to an XLA
// conv, an artefact of their lane rolls.
//
// Replaces the TPU kernels nemar_tpu/ops/conv_head_roll.py:_fwd_kernel
// (B4, --c7_impl roll) and nemar_tpu/ops/attic/conv_head.py:_fwd_kernel
// (B6, --block_impl pallas_all): the same function in two TPU layouts.
//
// What bounds it on the H100: arithmetic. At the generator's head (N x 256
// x 256 x 64 -> 3) it is 2 * 49 * 64 * 3 = 18.8 kFLOP per pixel, 9.87 GFLOP
// at batch 8: 0.147 ms at the 67 TFLOP/s fp32 FMA peak, 0.060 ms in 3xTF32
// at the 495 TFLOP/s TF32 peak; its bytes (x read once) take 0.040 ms at
// 3.35 TB/s. Two routes, one launch a call each (ops/conv_head.py:
// head_fwd_plan picks the route and the tiling):
//
// 1. The wgmma route (head_fwd_wgmma_kernel; Co <= 3, Ci <= 64, Ci % 4 == 0:
//    the model's head). The 49 taps fold into the N dimension of a GEMM on
//    the tensor cores in 3xTF32 (gemm_tc.cuh's split and its order of three
//    MMAs in chains of one 32-deep K slice),
//
//      Y[q, (tap, co)] = sum_ci xpad[q, ci] W[tap, ci, co],
//
//    M = 64 positions q of a row of the padded frame, N = 49 Co rounded up
//    to 8 (one m64n152k8 at Co = 3), K = Ci (zero-filled to whole slices);
//    then a collapse,
//
//      out[y, c, co] = sum_dy sum_dx Y_{y + dy}[c + dx, (dy, dx, co)],
//
//    the GPU form of the TPU kernel's dy collapse (the TPU folds the dy taps
//    into M of one dot per dx). A block walks a strip of tc <= 58 output
//    columns (64 padded positions) down a run of padded rows: for each row
//    r it computes Y_r into shared memory, and each thread of the collapse
//    (an output column and channel) adds sum_dx Y_r[c + dx, (dy, dx, co)]
//    into its ring of the 7 output rows r - 6 .. r, and writes row r - 6,
//    now complete. Every output thus gets its 49 taps in one fixed order
//    (dy outer, dx inner) with no atomics: two calls are bit-identical.
//      * Warpgroup 0 issues the MMAs and writes Y; warpgroup 1 copies x's
//        rows in and collapses Y, while the tensor cores run the next row.
//        One warpgroup takes all N: with N split over the two warpgroups
//        (m64n80k8 each), or with the two taking whole rows in turn, the
//        kernel ran slower on the H100 (PERF.md, section 6).
//      * A is x read through the reflect index: a row of 64 positions x Ci
//        is copied by cp.async into a double buffer (the next row's copy
//        overlaps this row's work), then each thread loads its fragments
//        with 16-byte reads and splits them in registers. The K order inside
//        a slice is permuted (k = 8 s + t + 4 r <-> ci = 8 t + 2 s + r, t =
//        the lane's k column) so that a fragment's 8 values per position
//        are 8 consecutive channels; B's rows take the same order.
//      * B is W as (tap, co) x ci, split into big and small once a block,
//        K-major swizzled, resident in shared memory (76 KB at Ci = 64).
//      * Y is stored column by column (64 positions + 4 a column), so that
//        both its stores from the fragments and the collapse's reads are
//        free of bank conflicts.
//      * The slices' chains are interleaved MMA by MMA (each in its own
//        order), so that consecutive MMAs do not wait on each other.
//      * The grid is persistent, at most one block a SM (W's split copy and
//        the buffers take 149 KB of shared memory): the strips' output rows,
//        (sample, strip, row) with the row fastest, are cut into one even
//        run a block. A run is one or two strips' segments, each costing its
//        rows + 6 halo rows; columns cost 64 / tc.
// 2. The direct route (head_fwd_direct_kernel; any other shape: Co of 4-8,
//    Ci > 64 or not a multiple of 4): a direct convolution on the CUDA
//    cores. A block computes an 8 x 64 output tile; it stages 8 input
//    channels of the (8+6) x (64+6) input window at a time in shared
//    memory, reflect indexing in the load, with that chunk's 49 x 8 x Co
//    weights; a thread owns 8 consecutive output pixels of one row and all
//    Co channels in registers.
//
// Layouts: x (N, H, W, Ci) fp32; W (7, 7, Ci, Co) HWIO fp32; out (N, H, W,
// Co). Requirements (checked by the wrapper and here): H, W >= 4,
// 1 <= Co <= 8; for the wgmma route also x 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

using tc::BK;

constexpr int K7 = 7;
constexpr int PAD = 3;
constexpr int HALO = 2 * PAD;  // an output reaches 6 positions past itself
constexpr int NTAP = K7 * K7;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// ---------------------------------------------------------------------------
// 1. The wgmma route
// ---------------------------------------------------------------------------
constexpr int G_THREADS = 256;        // the MMA warpgroup, then the copy-and-collapse one
constexpr int G_M = 64;               // positions of a strip's row: the wgmma's rows
constexpr int G_TC_MAX = G_M - HALO;  // 58 output columns of a strip
constexpr int G_CO_MAX = 3;           // 49 Co <= 152 columns, m64n152k8
constexpr int G_KS_MAX = 2;           // K slices: Ci <= 64

template <int CO>
__host__ __device__ constexpr int n_tile() {  // the GEMM's N: 49 Co rounded up to 8
  return (NTAP * CO + 7) / 8 * 8;
}
template <int KS>
__host__ __device__ constexpr int x_stride() {  // floats a position of the x rows; 16-byte reads conflict-free
  return KS * BK + 4;
}
// floats a column of Y, stored column by column: the MMA warpgroup's
// stores (bank 8 tq + gq) and the collapse's reads (consecutive positions)
// are both conflict-free
constexpr int Y_STRIDE = G_M + 4;
template <int KS, int CO>
__host__ __device__ constexpr int wgmma_smem() {
  return (2 * KS * n_tile<CO>() * BK + 2 * G_M * x_stride<KS>() + NTAP * CO * Y_STRIDE) *
         (int)sizeof(float);
}

struct FwdGeo {
  int n, h, w, ci;
  int tc, cx;       // a strip's output columns; strips a row
  long long units;  // output rows of all strips, n cx h
};

// A block's walk over its run [u0, u1) of output rows, one step a padded
// row: each segment (a strip's rows y0 .. y0 + rows - 1 of one sample)
// takes rows + 6 steps, padded rows r = y0 .. y0 + rows + 5, of which the
// last rows complete an output row each (r - 6 >= y0).
struct Cursor {
  int col;   // the strip: sample * cx + strip
  int y0;    // the segment's first output row
  int rows;  // its output rows
  int k;     // the step within it: padded row y0 + k
  int rem;   // output rows of the run after this segment

  __device__ void init(long long u0, long long u1, int h) {
    col = (int)(u0 / h);
    y0 = (int)(u0 - (long long)col * h);
    const int len = (int)(u1 - u0);
    rows = min(h - y0, len);
    rem = len - rows;
    k = 0;
  }
  __device__ void next(int h) {
    if (++k == rows + HALO) {
      ++col;
      y0 = 0;
      rows = min(h, rem);
      rem -= rows;
      k = 0;
    }
  }
};

// the run's steps: its output rows, and 6 more a segment (strip)
__device__ __forceinline__ int run_steps(long long u0, long long u1, int h) {
  if (u1 <= u0) return 0;
  return (int)(u1 - u0) + HALO * (int)((u1 - 1) / h - u0 / h + 1);
}

// x's padded row of the cursor's step into an x buffer: positions j0 + q,
// q < the strip's columns + 6 (zeros past them and past Ci), by cp.async
// over the 128 threads of a warpgroup
template <int KS>
__device__ __forceinline__ void load_row(float* xs, const float* __restrict__ x, const FwdGeo& g,
                                         const Cursor& cur, int wtid) {
  constexpr int XS = x_stride<KS>();
  constexpr int CHUNKS = KS * BK / 4;  // 16-byte chunks a position
  const int img = cur.col / g.cx, j0 = (cur.col - img * g.cx) * g.tc;
  const int npos = min(g.tc, g.w - j0) + HALO;
  const float* xr = x + ((size_t)img * g.h + reflect(cur.y0 + cur.k - PAD, g.h)) * g.w * g.ci;
#pragma unroll
  for (int i = 0; i < G_M * CHUNKS / 128; ++i) {
    const int e = wtid + 128 * i, q = e / CHUNKS, c = (e - q * CHUNKS) * 4;
    const bool valid = q < npos && c < g.ci;
    const float* src = valid ? xr + (size_t)reflect(j0 + q - PAD, g.w) * g.ci + c : x;
    tc::cp_async16(xs + q * XS + c, src, valid);
  }
}

// This thread's A fragments of every K slice from an x buffer, split:
// register q of step s4 is row gq + 8 (q & 1), k = 8 s4 + tq + 4 (q >> 1),
// which is channel 8 tq + 2 s4 + (q >> 1) of the slice (the permuted K
// order).
template <int KS>
__device__ __forceinline__ void load_a(const float* xs, int row0, int gq, int tq,
                                       uint32_t (&abig)[KS][BK / 8][4],
                                       uint32_t (&asmall)[KS][BK / 8][4]) {
  constexpr int XS = x_stride<KS>();
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = xs + (row0 + gq + 8 * h) * XS + s * BK + 8 * tq;
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int s4 = 0; s4 < BK / 8; ++s4)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          tc::split_tf32(v[2 * s4 + r], abig[s][s4][h + 2 * r], asmall[s][s4][h + 2 * r]);
    }
}

// A row's GEMM: every K slice's chain of 3 x 4 MMAs (gemm_tc.cuh's order),
// the slices' chains interleaved MMA by MMA so that consecutive MMAs are
// independent, committed as one group. bt: the B tiles, [KS][big, small][NT BK].
template <int KS, int NT>
__device__ __forceinline__ void issue_row(float (&part)[KS][NT / 2],
                                          const uint32_t (&abig)[KS][BK / 8][4],
                                          const uint32_t (&asmall)[KS][BK / 8][4], const float* bt) {
  constexpr int BT = NT * BK;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < KS; ++s) tc::wgmma_fence_operand(part[s]);
#pragma unroll
  for (int s4 = 0; s4 < BK / 8; ++s4) {
#pragma unroll
    for (int s = 0; s < KS; ++s)
      tc::wgmma_tf32(part[s], asmall[s][s4], tc::kmajor_desc(bt + s * 2 * BT + 8 * s4), s4 > 0);
#pragma unroll
    for (int s = 0; s < KS; ++s)
      tc::wgmma_tf32(part[s], abig[s][s4], tc::kmajor_desc(bt + s * 2 * BT + BT + 8 * s4), 1);
#pragma unroll
    for (int s = 0; s < KS; ++s)
      tc::wgmma_tf32(part[s], abig[s][s4], tc::kmajor_desc(bt + s * 2 * BT + 8 * s4), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Warpgroup 0 issues the MMAs and writes Y; warpgroup 1 copies x's rows in
// and collapses Y. Both meet at two block barriers a step (X: x of the
// next step in place and the last Y collapsed; Y: this step's Y written),
// in loops of their own, so each keeps only its own registers.
template <int KS, int CO>
__global__ void __launch_bounds__(G_THREADS, 1)
head_fwd_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, const FwdGeo g) {
  constexpr int XS = x_stride<KS>(), S = Y_STRIDE, NCOLS = NTAP * CO;
  constexpr int NT = n_tile<CO>(), BT = NT * BK, XBUF = G_M * XS;
  extern __shared__ __align__(1024) float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // [KS][big, small][BT], swizzled
  float* xs = bt + 2 * KS * BT;                 // [2][G_M][XS]
  float* ys = xs + 2 * XBUF;                    // [NCOLS][S]: Y of the current row

  const int tid = threadIdx.x, wtid = tid & 127;
  // the warpgroup, warp-uniform to the compiler (a branch on tid / 128
  // itself is divergent to it, and it then serializes the wgmma's)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const long long u0 = g.units * blockIdx.x / gridDim.x;
  const long long u1 = g.units * (blockIdx.x + 1) / gridDim.x;
  const int nsteps = run_steps(u0, u1, g.h);
  if (nsteps == 0) return;

  // x of the first two steps in flight while W is split
  Cursor ld;
  if (wg == 1) {
    ld.init(u0, u1, g.h);
    load_row<KS>(xs, x, g, ld, wtid);
    tc::cp_async_commit();
    ld.next(g.h);
    if (nsteps > 1) load_row<KS>(xs + XBUF, x, g, ld, wtid);
    tc::cp_async_commit();
    ld.next(g.h);
  }

  // B(k, n = tap Co + co) = W[tap, ci(k), co], ci(k) the permuted K order;
  // zero past 49 Co and past Ci
  for (int e = tid; e < KS * NT * (BK / 4); e += G_THREADS) {
    const int n = e % NT, kg = (e / NT) % (BK / 4), ks = e / (NT * (BK / 4));
    uint32_t big[4], sm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kg + j;
      const int ci = ks * BK + 8 * (k & 3) + 2 * (k >> 3) + ((k >> 2) & 1);
      float v = 0.f;
      if (n < NCOLS && ci < g.ci) {
        const int tap = n / CO;
        v = w[((size_t)tap * g.ci + ci) * CO + (n - tap * CO)];
      }
      tc::split_tf32(v, big[j], sm[j]);
    }
    const int off = ks * 2 * BT + tc::swizzled_off(n, kg);
    *reinterpret_cast<uint4*>(bt + off) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(bt + off + BT) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (wg == 1) tc::cp_async_wait<1>();
  __syncthreads();  // W split, x of step 0 in place

  if (wg == 0) {
    // the MMAs: Y(t) = the slices' chains summed in order, written as soon
    // as they land, then the next row's chains issued
    const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
    const int row0 = 16 * (tid >> 5);  // this warp's fragment rows row0 + gq, + 8 (positions)
    uint32_t abig[KS][BK / 8][4], asmall[KS][BK / 8][4];
    float part[KS][NT / 2];
    load_a<KS>(xs, row0, gq, tq, abig, asmall);
    issue_row<KS, NT>(part, abig, asmall, bt);
    for (int t = 0; t < nsteps; ++t) {
      __syncthreads();  // X: x of step t + 1 in place; Y(t - 1) collapsed
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < KS; ++s) tc::wgmma_fence_operand(part[s]);
      // part[s][4 j + v]: position row0 + gq + 8 (v >> 1), column 8 j + 2 tq + (v & 1)
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int col = 8 * j + 2 * tq + (v & 1);
          float y = part[0][4 * j + v];
#pragma unroll
          for (int s = 1; s < KS; ++s) y += part[s][4 * j + v];
          if (col < NCOLS) ys[col * S + row0 + gq + 8 * (v >> 1)] = y;
        }
      if (t + 1 < nsteps) {
        load_a<KS>(xs + ((t + 1) & 1) * XBUF, row0, gq, tq, abig, asmall);
        issue_row<KS, NT>(part, abig, asmall, bt);
      }
      __syncthreads();  // Y: Y(t) in place
    }
  } else {
    // the copies and the collapse: pair p = wtid + 128 i is output column p % 64
    // of the strip and channel p / 64 (lanes on consecutive columns)
    constexpr int PAIRS = (G_M * CO + 127) / 128;
    const float* yc[PAIRS];
    bool on[PAIRS];
    float ring[PAIRS][K7];  // output rows r - 6 .. r
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = wtid + 128 * i, c = p % G_M, co = p / G_M;
      on[i] = co < CO && c < G_TC_MAX;
      yc[i] = ys + (on[i] ? co : 0) * S + c;
    }
    Cursor cl;
    cl.init(u0, u1, g.h);
    for (int t = 0; t < nsteps; ++t) {
      tc::cp_async_wait<0>();
      __syncthreads();  // X
      if (t + 2 < nsteps) {  // into the buffer step t's A was loaded from
        load_row<KS>(xs + (t & 1) * XBUF, x, g, ld, wtid);
        ld.next(g.h);
      }
      tc::cp_async_commit();
      __syncthreads();  // Y
      const int img = cl.col / g.cx, j0 = (cl.col - img * g.cx) * g.tc;
      const int tcw = min(g.tc, g.w - j0);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        if (!on[i]) continue;
        if (cl.k == 0) {
#pragma unroll
          for (int d = 0; d < K7; ++d) ring[i][d] = 0.f;
        }
#pragma unroll
        for (int dy = 0; dy < K7; ++dy) {
          float s = yc[i][dy * K7 * CO * S];
#pragma unroll
          for (int dx = 1; dx < K7; ++dx) s += yc[i][(dy * K7 + dx) * CO * S + dx];
          ring[i][K7 - 1 - dy] += s;
        }
        const int p = wtid + 128 * i, c = p % G_M;
        if (cl.k >= HALO && c < tcw)  // output row y0 + k - 6 is complete
          out[(((size_t)img * g.h + cl.y0 + cl.k - HALO) * g.w + j0 + c) * CO + p / G_M] = ring[i][0];
#pragma unroll
        for (int d = 0; d < K7 - 1; ++d) ring[i][d] = ring[i][d + 1];
        ring[i][K7 - 1] = 0.f;
      }
      cl.next(g.h);
    }
    tc::cp_async_wait<0>();
  }
}

template <int KS, int CO>
cudaError_t launch_wgmma(const float* x, const float* w, float* out, const FwdGeo& g, int blocks,
                         cudaStream_t stream) {
  constexpr int bytes = wgmma_smem<KS, CO>();
  const cudaError_t err = cudaFuncSetAttribute(head_fwd_wgmma_kernel<KS, CO>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  head_fwd_wgmma_kernel<KS, CO><<<blocks, G_THREADS, bytes, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_wgmma_co(const float* x, const float* w, float* out, const FwdGeo& g, int co,
                            int blocks, cudaStream_t stream) {
  switch (co) {
    case 1: return launch_wgmma<KS, 1>(x, w, out, g, blocks, stream);
    case 2: return launch_wgmma<KS, 2>(x, w, out, g, blocks, stream);
    default: return launch_wgmma<KS, 3>(x, w, out, g, blocks, stream);
  }
}

// ---------------------------------------------------------------------------
// 2. The direct route
// ---------------------------------------------------------------------------
constexpr int TH = 8;                      // output rows per block
constexpr int TW = 64;                     // output columns per block
constexpr int PX = 8;                      // consecutive output columns per thread
constexpr int THREADS = TH * TW / PX;      // 64
constexpr int CC = 8;                      // input channels per staged chunk
constexpr int SH = TH + 2 * PAD;           // 14 staged rows
constexpr int SW = TW + 2 * PAD;           // 70 staged columns
constexpr int SWP = 72;                    // their row pitch

// The reflect-padded index of i, for i in the window of a tile that may
// overhang the image: clamped to [-PAD, n - 1 + PAD] first (what lies past
// that feeds no output).
__device__ __forceinline__ int window_index(int i, int n) {
  return reflect(min(max(i, -PAD), n - 1 + PAD), n);
}

template <int CO>
__global__ void __launch_bounds__(THREADS)
head_fwd_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int h, int wd, int ci) {
  __shared__ float xs[CC][SH][SWP];
  __shared__ float ws[K7 * K7][CC][CO];

  const int tid = threadIdx.x;
  const int r = tid / (TW / PX);           // output row of the tile
  const int c0 = (tid % (TW / PX)) * PX;   // first output column of the thread
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, n = blockIdx.z;
  const float* xb = x + (size_t)n * h * wd * ci;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[j][co] = 0.f;

  for (int cb = 0; cb < ci; cb += CC) {
    __syncthreads();  // the previous chunk is consumed
    // channel-fastest: a warp reads 32-byte runs of 4 pixels
    for (int e = tid; e < SH * SW * CC; e += THREADS) {
      const int c = e % CC;
      const int pos = e / CC;
      const int sx = pos % SW, sy = pos / SW;
      const int iy = window_index(y0 + sy - PAD, h), ix = window_index(x0 + sx - PAD, wd);
      xs[c][sy][sx] = cb + c < ci ? xb[((size_t)iy * wd + ix) * ci + cb + c] : 0.f;
    }
    for (int e = tid; e < K7 * K7 * CC * CO; e += THREADS) {
      const int co = e % CO;
      const int c = (e / CO) % CC;
      const int tap = e / (CO * CC);
      ws[tap][c][co] = cb + c < ci ? w[((size_t)tap * ci + cb + c) * CO + co] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < CC; ++c) {
      for (int dy = 0; dy < K7; ++dy) {
        float row[PX + K7 - 1];
#pragma unroll
        for (int k = 0; k < PX + K7 - 1; ++k) row[k] = xs[c][r + dy][c0 + k];
#pragma unroll
        for (int dx = 0; dx < K7; ++dx) {
          float wv[CO];
#pragma unroll
          for (int co = 0; co < CO; ++co) wv[co] = ws[dy * K7 + dx][c][co];
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int co = 0; co < CO; ++co) acc[j][co] = fmaf(row[j + dx], wv[co], acc[j][co]);
        }
      }
    }
  }

  const int oy = y0 + r;
  if (oy >= h) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = x0 + c0 + j;
    if (ox < wd) {
      float* o = out + (((size_t)n * h + oy) * wd + ox) * CO;
#pragma unroll
      for (int co = 0; co < CO; ++co) o[co] = acc[j][co];
    }
  }
}

template <int CO>
cudaError_t launch_direct(const float* x, const float* w, float* out, int n, int h, int wd, int ci,
                          cudaStream_t stream) {
  const dim3 grid((unsigned)((wd + TW - 1) / TW), (unsigned)((h + TH - 1) / TH), (unsigned)n);
  head_fwd_direct_kernel<CO><<<grid, THREADS, 0, stream>>>(x, w, out, h, wd, ci);
  return cudaGetLastError();
}

}  // namespace

// tc, blocks: the wgmma route's strip width and persistent grid
// (ops/conv_head.py:head_fwd_plan); blocks == 0 takes the direct route.
extern "C" int nemar_conv_head_fwd(const float* x, const float* w, float* out, int n, int h,
                                   int wd, int ci, int co, int tc, int blocks,
                                   cudaStream_t stream) {
  if (co < 1 || co > 8 || h <= PAD || wd <= PAD || n < 1 || ci < 1 || blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    if (co > G_CO_MAX || ci > G_KS_MAX * BK || ci % 4 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || tc < 1 || tc > G_TC_MAX)
      return (int)cudaErrorInvalidValue;
    FwdGeo g;
    g.n = n; g.h = h; g.w = wd; g.ci = ci; g.tc = tc;
    g.cx = (wd + tc - 1) / tc;
    g.units = (long long)n * g.cx * h;
    if (blocks > g.units) return (int)cudaErrorInvalidValue;
    return (int)(ci <= BK ? launch_wgmma_co<1>(x, w, out, g, co, blocks, stream)
                          : launch_wgmma_co<2>(x, w, out, g, co, blocks, stream));
  }
  switch (co) {
    case 1: return (int)launch_direct<1>(x, w, out, n, h, wd, ci, stream);
    case 2: return (int)launch_direct<2>(x, w, out, n, h, wd, ci, stream);
    case 3: return (int)launch_direct<3>(x, w, out, n, h, wd, ci, stream);
    case 4: return (int)launch_direct<4>(x, w, out, n, h, wd, ci, stream);
    case 5: return (int)launch_direct<5>(x, w, out, n, h, wd, ci, stream);
    case 6: return (int)launch_direct<6>(x, w, out, n, h, wd, ci, stream);
    case 7: return (int)launch_direct<7>(x, w, out, n, h, wd, ci, stream);
    default: return (int)launch_direct<8>(x, w, out, n, h, wd, ci, stream);
  }
}
