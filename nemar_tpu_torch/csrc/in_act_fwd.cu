// K-in: instance norm + activation, forward, in one cooperative launch.
//
// Replaces the TPU kernel nemar_tpu/ops/norm.py:_instance_norm_act_pallas
// (_in_act_kernel): per (sample, channel) the mean and rstd over H * W
// (biased variance, eps), then y = act((x - mean) * rstd) with act none,
// relu or leaky_relu (slope); it also returns stats (N, 2, C) = (mean,
// rstd), which K-in-bwd reuses. The TPU kernel walks a sample's row chunks
// in order on a (N, 2, K) grid, phase 0 summing into VMEM scratch that
// persists across the chunks and phase 1 normalising. Hopper blocks run in
// no order, so the sums are split over blocks and made visible to all of
// them by a grid barrier instead:
//
//   1. Each block takes items (in_act.cuh: sample, channel block, row
//      chunk) and sums (x - p) and (x - p)^2 over the item's rows in fp32,
//      p being the sample's first pixel (the pivot keeps E[x^2] - E[x]^2
//      from cancelling when |mean| >> std), reduces them over the block in
//      a fixed order, and writes one pair per channel, in fp64, to `part`.
//      Where the block's items fit in shared memory (Plan::cached), their
//      rows are kept there.
//   2. cooperative_groups' grid barrier. Then one warp per (sample,
//      channel) merges that channel's chunks in a fixed order in fp64 and
//      writes mean = p + E[x - p] and rstd = 1 / sqrt(var + eps), both
//      formed in fp64, as fp32 stats. Another grid barrier.
//   3. Each block normalises its items' rows from shared memory (cached)
//      or from x again, last rows first: the rows phase 1 read last are
//      the likeliest to be in L2.
//
// One launch per call, no float atomics: two identical calls give the same
// bits. The launch holds every block at once (cudaLaunchCooperativeKernel,
// at most the device's co-resident blocks: 2 a SM, 264 on the H100); a
// launch that does not fit fails and is not retried.
//
// What bounds it on the H100: bytes. It reads x once (twice where the rows
// do not fit in shared memory) and writes y once, with a few operations
// per element; the grid barriers cost microseconds, the host's operator
// call more. The blocks hold ~24 MB of rows at once: every shape of
// chip_smoke.IN_SHAPES (batch 1) keeps its rows in shared memory (at most
// 64 KB a block); of the b8 step's (chip_smoke.IN_BWD_SHAPES) the nine of
// at most 4.2M elements do, and the six larger (64 and 32 x 256^2, 128 x
// 128^2, 256 x 64^2, 128 x 64^2 and 512 x 31^2 at 16) read x twice.
//
// Layouts: x, y (N, H, W, C) fp32 contiguous (bf16 in the --bf16 variant,
// nemar_in_act_fwd_bf16, which is the same kernel instantiated for bf16:
// in_act.cuh); stats (N, 2, C) fp32; work the doubles nemar_in_act_fwd_work
// (nemar_in_act_fwd_bf16_work) asks for. Any N, C >= 1, H * W >= 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "in_act.cuh"

namespace {

using namespace in_act;
namespace cg = cooperative_groups;

// rows a thread loads before it sums them, for memory-level parallelism
constexpr int kUnroll = 4;

template <int VEC, class T>
__global__ void __launch_bounds__(kThreads, 2)
    in_act_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, float* stats,
                      double* part, Plan p, int hw, int c, int act, float eps, float slope) {
  extern __shared__ float4 cache_raw[];
  float* cache = reinterpret_cast<float*>(cache_raw);
  __shared__ float red[2][kRed];
  const int lanes = p.cb / VEC, pass = kThreads / lanes;
  const int lane = threadIdx.x % lanes, rg = threadIdx.x / lanes;
  const int iters = p.rows / pass;

  // 1. partial sums of every item, rows kept in shared memory if cached
  for (int slot = 0, i = blockIdx.x; i < p.items; ++slot, i += gridDim.x) {
    const Item it = item_of(p, i);
    const int ch = it.cblk * p.cb + lane * VEC;
    const bool ok = ch < c;
    const T* xs = x + static_cast<size_t>(it.n) * hw * c;
    const Pack<VEC> piv = ok ? load<VEC>(xs + ch) : zeros<VEC>();
    float* tile = p.cached ? cache + static_cast<size_t>(slot) * p.rows * p.cb : nullptr;
    const int r0 = it.chunk * p.rows + rg;
    float a1[VEC], a2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a1[v] = 0.f, a2[v] = 0.f;
    for (int j0 = 0; j0 < iters; j0 += kUnroll) {
      Pack<VEC> vals[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + (j0 + u) * pass;
        vals[u] = ok && j0 + u < iters && r < hw ? load<VEC>(xs + static_cast<size_t>(r) * c + ch)
                                                 : zeros<VEC>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j >= iters) break;
        if (tile) store<VEC>(tile + (rg + j * pass) * p.cb + lane * VEC, vals[u]);
        if (!ok || r0 + j * pass >= hw) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float d = vals[u].v[v] - piv.v[v];
          a1[v] += d;
          a2[v] += d * d;
        }
      }
    }
    double s1, s2;
    block_sum<VEC>(a1, a2, lanes, p.cb, red, s1, s2);
    const int cw = it.cblk * p.cb + static_cast<int>(threadIdx.x);
    if (static_cast<int>(threadIdx.x) < p.cb && cw < c) {
      double* q = part + (static_cast<size_t>(it.n) * p.chunks + it.chunk) * 2 * c + cw;
      q[0] = s1;
      q[c] = s2;
    }
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // 2. merge the chunks: one warp per (sample, channel)
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       w < static_cast<long long>(p.n) * c; w += warps) {
    const int n = static_cast<int>(w / c), ch = static_cast<int>(w % c);
    double s1, s2;
    merge_chunks(part, p.chunks, c, n, ch, s1, s2);
    if ((threadIdx.x & 31) == 0) {
      const double m1 = s1 / hw;
      const double var = fmax(s2 / hw - m1 * m1, 0.0);
      const double pivot = to_float(x[static_cast<size_t>(n) * hw * c + ch]);
      stats[static_cast<size_t>(n) * 2 * c + ch] = static_cast<float>(pivot + m1);
      stats[static_cast<size_t>(n) * 2 * c + c + ch] =
          static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
    }
  }
  grid.sync();

  // 3. normalise, last item and last rows first
  for (int slot = p.per_block - 1; slot >= 0; --slot) {
    const int i = blockIdx.x + slot * gridDim.x;
    if (i >= p.items) continue;
    const Item it = item_of(p, i);
    const int ch = it.cblk * p.cb + lane * VEC;
    if (ch >= c) continue;
    const float* st = stats + static_cast<size_t>(it.n) * 2 * c;
    const Pack<VEC> mean = load<VEC>(st + ch), rstd = load<VEC>(st + c + ch);
    const size_t base = static_cast<size_t>(it.n) * hw * c + ch;
    const float* tile = p.cached ? cache + static_cast<size_t>(slot) * p.rows * p.cb : nullptr;
    const int r0 = it.chunk * p.rows + rg;
    for (int j0 = iters - 1; j0 >= 0; j0 -= kUnroll) {
      Pack<VEC> vals[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 - u, r = r0 + j * pass;
        vals[u] = j < 0 || r >= hw ? zeros<VEC>()
                  : tile           ? load<VEC>(tile + (rg + j * pass) * p.cb + lane * VEC)
                                   : load<VEC>(x + base + static_cast<size_t>(r) * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 - u, r = r0 + j * pass;
        if (j < 0 || r >= hw) continue;
        Pack<VEC> out;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float t = (vals[u].v[v] - mean.v[v]) * rstd.v[v];
          out.v[v] = act == 1 ? fmaxf(t, 0.f) : act == 2 ? (t >= 0.f ? t : t * slope) : t;
        }
        store<VEC>(y + base + static_cast<size_t>(r) * c, out);
      }
    }
  }
}

// the co-resident blocks of each element type's two instantiations, per device
template <class T>
struct Blocks {
  static std::atomic<int> b4[kMaxDevices], b1[kMaxDevices];
};
template <class T>
std::atomic<int> Blocks<T>::b4[kMaxDevices];
template <class T>
std::atomic<int> Blocks<T>::b1[kMaxDevices];

template <class T>
cudaError_t plan_for(int n, int hw, int c, Plan* p) {
  const void* k4 = reinterpret_cast<const void*>(&in_act_fwd_kernel<4, T>);
  const void* k1 = reinterpret_cast<const void*>(&in_act_fwd_kernel<1, T>);
  return in_act::plan_for(k4, Blocks<T>::b4, k1, Blocks<T>::b1, n, hw, c, 1, p);
}

template <class T>
long long work(int n, int hw, int c) {
  if (static_cast<long long>(n) * hw * c == 0) return 0;
  Plan p;
  const cudaError_t e = plan_for<T>(n, hw, c, &p);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(n) * p.chunks * 2 * c;
}

template <class T>
int launch(const T* x, T* y, float* stats, double* work, long long work_doubles, int n, int h,
           int w, int c, int act, float eps, float slope, cudaStream_t stream) {
  const int hw = h * w;
  if (static_cast<long long>(n) * hw * c == 0) return static_cast<int>(cudaSuccess);
  Plan p;
  const cudaError_t e = plan_for<T>(n, hw, c, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (work_doubles < static_cast<long long>(n) * p.chunks * 2 * c)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
                                          (4 * sizeof(T)) == 0;
  void* args[] = {&x, &y, &stats, &work, &p, const_cast<int*>(&hw), &c, &act, &eps, &slope};
  const void* kernel = vec4 ? reinterpret_cast<const void*>(&in_act_fwd_kernel<4, T>)
                            : reinterpret_cast<const void*>(&in_act_fwd_kernel<1, T>);
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kernel, p.grid, kThreads, args, kCacheBytes, stream));
}

}  // namespace

// The doubles of workspace a call at this shape needs on the current
// device, or minus a CUDA error code.
extern "C" long long nemar_in_act_fwd_work(int n, int hw, int c) { return work<float>(n, hw, c); }

// act: 0 none, 1 relu, 2 leaky_relu. Returns the launch's CUDA error code.
extern "C" int nemar_in_act_fwd(const float* x, float* y, float* stats, double* work,
                                long long work_doubles, int n, int h, int w, int c, int act,
                                float eps, float slope, cudaStream_t stream) {
  return launch<float>(x, y, stats, work, work_doubles, n, h, w, c, act, eps, slope, stream);
}

// The bf16 variant: x, y bf16; stats fp32.
extern "C" long long nemar_in_act_fwd_bf16_work(int n, int hw, int c) {
  return work<__nv_bfloat16>(n, hw, c);
}

extern "C" int nemar_in_act_fwd_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, float* stats,
                                     double* work, long long work_doubles, int n, int h, int w,
                                     int c, int act, float eps, float slope, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, y, stats, work, work_doubles, n, h, w, c, act, eps, slope,
                               stream);
}
