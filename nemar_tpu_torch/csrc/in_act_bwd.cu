// K-in-bwd: the VJP of instance norm + activation, in one cooperative launch.
//
// Computes the JAX package's analytic backward
// (nemar_tpu/ops/norm.py:_in_act_vjp_bwd, plain XLA there: the TPU package
// has no Pallas kernel for it) from x, g = d y and K-in's stats (mean,
// rstd):
//
//   dx = rstd * (ĝ - mean(ĝ) - ŷ * mean(ĝ * ŷ)),   ŷ = (x - mean) * rstd,
//   ĝ = g * act'(ŷ)   (relu: ŷ > 0; leaky_relu: 1 where ŷ >= 0, else slope)
//
// with K-in's split and barriers (in_act_fwd.cu, in_act.cuh):
//
//   1. Each block sums ĝ and ĝ * ŷ over its items' rows in fp32, reduces
//      them over the block in a fixed order and writes one pair per
//      channel, in fp64, to `part`; where the block's items fit in shared
//      memory (Plan::cached), their rows of x and g are kept there.
//   2. A grid barrier; one warp per (sample, channel) merges the chunks in
//      a fixed order in fp64 into mean(ĝ) and mean(ĝ * ŷ); a grid barrier.
//   3. Each block forms dx for its items' rows from shared memory or from x
//      and g again, last rows first (the likeliest to be in L2).
//
// One launch per call, no float atomics: two identical calls give the same
// bits.
//
// What bounds it on the H100: bytes. It reads x and g once (twice where the
// rows do not fit in shared memory) and writes dx once. With x and g both
// kept, the blocks hold half the rows K-in's do: of the b8 step's shapes
// (chip_smoke.IN_BWD_SHAPES) the five of at most 2.1M elements keep them
// and the ten larger read x and g twice; at batch 1 (chip_smoke.IN_SHAPES)
// every shape but 64 x 256^2 keeps them.
//
// Layouts: x, g, dx (N, H, W, C) fp32 contiguous (bf16 in the --bf16
// variant, nemar_in_act_bwd_bf16: the same kernel instantiated for bf16,
// its sums and arithmetic fp32, d x rounded once); stats (N, 2, C) fp32;
// work the doubles nemar_in_act_bwd_work (nemar_in_act_bwd_bf16_work) asks
// for. Any N, C >= 1, H * W >= 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "in_act.cuh"

namespace {

using namespace in_act;
namespace cg = cooperative_groups;

// rows a thread loads (of x and of g) before it sums them; two of each keep
// the thread within the 64 registers of two 512-thread blocks a SM
constexpr int kUnroll = 2;

// ĝ of one element, given ŷ
__device__ __forceinline__ float act_grad(float yh, float g, int act, float slope) {
  return act == 1 ? (yh > 0.f ? g : 0.f) : act == 2 ? (yh >= 0.f ? g : g * slope) : g;
}

template <int VEC, class T>
__global__ void __launch_bounds__(kThreads, 2)
    in_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ stats, T* __restrict__ dx, double* part,
                      double* means, Plan p, int hw, int c, int act, float slope) {
  extern __shared__ float4 cache_raw[];
  float* cache = reinterpret_cast<float*>(cache_raw);
  __shared__ float red[2][kRed];
  const int lanes = p.cb / VEC, pass = kThreads / lanes;
  const int lane = threadIdx.x % lanes, rg = threadIdx.x / lanes;
  const int iters = p.rows / pass;
  const size_t tile_floats = static_cast<size_t>(p.rows) * p.cb;

  // 1. partial sums of ĝ and ĝ * ŷ, rows of x and g kept if cached
  for (int slot = 0, i = blockIdx.x; i < p.items; ++slot, i += gridDim.x) {
    const Item it = item_of(p, i);
    const int ch = it.cblk * p.cb + lane * VEC;
    const bool ok = ch < c;
    const float* st = stats + static_cast<size_t>(it.n) * 2 * c;
    const Pack<VEC> mean = ok ? load<VEC>(st + ch) : zeros<VEC>();
    const Pack<VEC> rstd = ok ? load<VEC>(st + c + ch) : zeros<VEC>();
    const size_t base = static_cast<size_t>(it.n) * hw * c + ch;
    float* tile = p.cached ? cache + 2 * slot * tile_floats : nullptr;
    const int r0 = it.chunk * p.rows + rg;
    float a1[VEC], a2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a1[v] = 0.f, a2[v] = 0.f;
    for (int j0 = 0; j0 < iters; j0 += kUnroll) {
      Pack<VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + (j0 + u) * pass;
        const bool in = ok && j0 + u < iters && r < hw;
        xv[u] = in ? load<VEC>(x + base + static_cast<size_t>(r) * c) : zeros<VEC>();
        gv[u] = in ? load<VEC>(g + base + static_cast<size_t>(r) * c) : zeros<VEC>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j >= iters) break;
        if (tile) {
          const int at = (rg + j * pass) * p.cb + lane * VEC;
          store<VEC>(tile + at, xv[u]);
          store<VEC>(tile + tile_floats + at, gv[u]);
        }
        if (!ok || r0 + j * pass >= hw) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float yh = (xv[u].v[v] - mean.v[v]) * rstd.v[v];
          const float gh = act_grad(yh, gv[u].v[v], act, slope);
          a1[v] += gh;
          a2[v] += gh * yh;
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

  // 2. merge the chunks into (mean(ĝ), mean(ĝ * ŷ)): one warp per (sample, channel)
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       w < static_cast<long long>(p.n) * c; w += warps) {
    const int n = static_cast<int>(w / c), ch = static_cast<int>(w % c);
    double s1, s2;
    merge_chunks(part, p.chunks, c, n, ch, s1, s2);
    if ((threadIdx.x & 31) == 0) {
      means[static_cast<size_t>(n) * 2 * c + ch] = s1 / hw;
      means[static_cast<size_t>(n) * 2 * c + c + ch] = s2 / hw;
    }
  }
  grid.sync();

  // 3. dx, last item and last rows first
  for (int slot = p.per_block - 1; slot >= 0; --slot) {
    const int i = blockIdx.x + slot * gridDim.x;
    if (i >= p.items) continue;
    const Item it = item_of(p, i);
    const int ch = it.cblk * p.cb + lane * VEC;
    if (ch >= c) continue;
    const float* st = stats + static_cast<size_t>(it.n) * 2 * c;
    const Pack<VEC> mean = load<VEC>(st + ch), rstd = load<VEC>(st + c + ch);
    const double* mm = means + static_cast<size_t>(it.n) * 2 * c + ch;
    float m1[VEC], m2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      m1[v] = static_cast<float>(mm[v]);
      m2[v] = static_cast<float>(mm[c + v]);
    }
    const size_t base = static_cast<size_t>(it.n) * hw * c + ch;
    const float* tile = p.cached ? cache + 2 * slot * tile_floats : nullptr;
    const int r0 = it.chunk * p.rows + rg;
    for (int j0 = iters - 1; j0 >= 0; j0 -= kUnroll) {
      Pack<VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 - u, r = r0 + j * pass;
        const int at = (rg + j * pass) * p.cb + lane * VEC;
        const size_t off = base + static_cast<size_t>(r) * c;
        const bool in = j >= 0 && r < hw;
        xv[u] = !in ? zeros<VEC>() : tile ? load<VEC>(tile + at) : load<VEC>(x + off);
        gv[u] = !in ? zeros<VEC>() : tile ? load<VEC>(tile + tile_floats + at) : load<VEC>(g + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 - u, r = r0 + j * pass;
        if (j < 0 || r >= hw) continue;
        Pack<VEC> out;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float yh = (xv[u].v[v] - mean.v[v]) * rstd.v[v];
          const float gh = act_grad(yh, gv[u].v[v], act, slope);
          out.v[v] = rstd.v[v] * (gh - m1[v] - yh * m2[v]);
        }
        store<VEC>(dx + base + static_cast<size_t>(r) * c, out);
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
  const void* k4 = reinterpret_cast<const void*>(&in_act_bwd_kernel<4, T>);
  const void* k1 = reinterpret_cast<const void*>(&in_act_bwd_kernel<1, T>);
  return in_act::plan_for(k4, Blocks<T>::b4, k1, Blocks<T>::b1, n, hw, c, 2, p);
}

long long work_doubles_of(const Plan& p, int n, int c) {
  return static_cast<long long>(n) * (p.chunks + 1) * 2 * c;  // part, then means
}

template <class T>
long long work(int n, int hw, int c) {
  if (static_cast<long long>(n) * hw * c == 0) return 0;
  Plan p;
  const cudaError_t e = plan_for<T>(n, hw, c, &p);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return work_doubles_of(p, n, c);
}

template <class T>
int launch(const T* x, const T* g, const float* stats, T* dx, double* work, long long work_doubles,
           int n, int h, int w, int c, int act, float slope, cudaStream_t stream) {
  const int hw = h * w;
  if (static_cast<long long>(n) * hw * c == 0) return static_cast<int>(cudaSuccess);
  Plan p;
  const cudaError_t e = plan_for<T>(n, hw, c, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (work_doubles < work_doubles_of(p, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  double* means = work + static_cast<size_t>(n) * p.chunks * 2 * c;
  const bool vec4 = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                                    reinterpret_cast<uintptr_t>(dx)) % (4 * sizeof(T)) == 0;
  void* args[] = {&x, &g, &stats, &dx, &work, &means, &p, const_cast<int*>(&hw), &c, &act, &slope};
  const void* kernel = vec4 ? reinterpret_cast<const void*>(&in_act_bwd_kernel<4, T>)
                            : reinterpret_cast<const void*>(&in_act_bwd_kernel<1, T>);
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kernel, p.grid, kThreads, args, kCacheBytes, stream));
}

}  // namespace

// The doubles of workspace a call at this shape needs on the current
// device, or minus a CUDA error code.
extern "C" long long nemar_in_act_bwd_work(int n, int hw, int c) { return work<float>(n, hw, c); }

// act: 0 none, 1 relu, 2 leaky_relu. Returns the launch's CUDA error code.
extern "C" int nemar_in_act_bwd(const float* x, const float* g, const float* stats, float* dx,
                                double* work, long long work_doubles, int n, int h, int w, int c,
                                int act, float slope, cudaStream_t stream) {
  return launch<float>(x, g, stats, dx, work, work_doubles, n, h, w, c, act, slope, stream);
}

// The bf16 variant: x, g, dx bf16; stats fp32.
extern "C" long long nemar_in_act_bwd_bf16_work(int n, int hw, int c) {
  return work<__nv_bfloat16>(n, hw, c);
}

extern "C" int nemar_in_act_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                     const float* stats, __nv_bfloat16* dx, double* work,
                                     long long work_doubles, int n, int h, int w, int c, int act,
                                     float slope, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, g, stats, dx, work, work_doubles, n, h, w, c, act, slope,
                               stream);
}
