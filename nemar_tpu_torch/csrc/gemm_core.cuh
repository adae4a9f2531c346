// The templated fp32 FMA GEMM core of the kernel library, shared by
// K-convt (convt_fwd.cu) and K-convt-bwd (convt_bwd.cu). K-block-bwd runs on
// the tensor-core cores of gemm_tc.cuh.
//
// One block computes a BM x BN tile of C = A^T B over K, in BK-deep slices
// staged in shared memory (double-buffered, the next slice loaded into
// registers before the current slice's FMAs and stored after them), 8x8
// outputs per thread. An Op supplies everything that depends on the
// operands' layout: the loads (global -> registers, masking what lies
// outside the operands), the stores (registers -> shared memory) and the
// epilogue's writes. With Op::kTileStats the core also reduces the tile's
// valid rows, per column, to (mean, sum of squared deviations from it) and
// hands them to op.write_stats: the per-tile instance-norm partials, merged
// across tiles in a fixed order by the caller's next launch.
#pragma once

#include <cuda_runtime.h>

// Everything is internal to each translation unit that includes this.
namespace gemm {
namespace {

constexpr int BM = 64;   // output rows per block tile
constexpr int BN = 128;  // output columns per block tile
constexpr int BK = 8;    // reduction depth per stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
static_assert(THREADS == BN, "the stats epilogue gives each thread one column of the tile");
static_assert(BM * BK == 4 * THREADS && BN * BK == 8 * THREADS, "loader shapes");

// Thread (tx, ty) owns rows {ty*4 + i, 32 + ty*4 + i} and columns
// {tx*4 + j, 64 + tx*4 + j} (i, j < 4): each quarter-warp then reads 128
// contiguous bytes of shared memory per float4 load, without bank conflicts.
__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 32) + ty * 4 + (i & 3); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

template <class Op>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Op params) {
  Op op = params;
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  op.setup(tid);
  const int ktiles = op.ktiles();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  typename Op::Stage st;
  op.load(0, st);
  op.store(As[0], Bs[0], st);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) op.load(kt + 1, st);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) op.store(As[cur ^ 1], Bs[cur ^ 1], st);
    __syncthreads();
  }

  // epilogue: row r of the tile, columns tx*4.. and 64 + tx*4..
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    op.write(row_of(ty, i), tx * 4, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    op.write(row_of(ty, i), 64 + tx * 4, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }

  if constexpr (Op::kTileStats) {
    // per column: the mean of the tile's valid rows, then the sum of
    // squared deviations from it (rows past op.rows_in_tile() are padding)
    __shared__ float red[BM / TM][BN];
    __shared__ float tile_mean[BN];
    const int cnt = op.rows_in_tile();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) s += row_of(ty, i) < cnt ? acc[i][j] : 0.f;
      red[ty][col_of(tx, j)] = s;
    }
    __syncthreads();
    {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < BM / TM; ++t) s += red[t][tid];
      tile_mean[tid] = s / (float)cnt;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float m = tile_mean[col_of(tx, j)];
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float d = acc[i][j] - m;
        q = row_of(ty, i) < cnt ? fmaf(d, d, q) : q;
      }
      red[ty][col_of(tx, j)] = q;
    }
    __syncthreads();
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < BM / TM; ++t) q += red[t][tid];
    op.write_stats(tid, tile_mean[tid], q);
  }
}

// Which part of a K slice of the B operand a thread loads: rows b_r and
// b_r + 4, four columns from b_c.
struct BLoader {
  int b_r, b_c;
  __device__ void init(int tid) {
    b_r = tid >> 5;
    b_c = (tid & 31) * 4;
  }
};

// out = sum over the splits of part, in split order; float4-wide. The
// deterministic second half of a split-K GEMM.
__global__ void split_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                 long long total4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) s = add4(s, part[(size_t)k * total4 + i]);
  out[i] = s;
}

}  // namespace
}  // namespace gemm
