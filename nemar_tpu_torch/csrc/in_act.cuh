// What K-in (in_act_fwd.cu) and K-in-bwd (in_act_bwd.cu) share: the work
// split of one cooperative launch, the block reduction of per-channel sums,
// and the per-device count of co-resident blocks.
//
// Both kernels view their (N, H, W, C) operands as N samples of HW = H * W
// rows of C contiguous channels. The work is cut into items: (sample n,
// channel block of `cb` channels, chunk of `rows` rows). A block of
// kThreads threads covers one item in passes: `lanes` threads across the
// channel block (each VEC channels wide: 4 with 16-byte loads where C % 4
// == 0 and the pointers allow it, else 1) times `pass` rows. The split
// depends only on (N, HW, C) and the device's count of co-resident blocks,
// never on VEC or on which block takes which item, so two identical calls
// sum in the same order and give the same bits.
//
// Each kernel is a template on its tensors' element type: float, or bf16
// for the --bf16 variants, whose loads widen to fp32 (exact) and whose
// stores round to bf16 once; the arithmetic, the sums, the statistics and
// the rows kept in shared memory are fp32 either way, so a bf16 call has
// the split and the order of its fp32 counterpart. Its 4-wide loads are 8
// bytes (where C % 4 == 0 and the pointers are 8-byte aligned).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace in_act {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// channels of one channel block, at most
constexpr int kMaxCB = 64;
// dynamic shared memory of every launch: the rows of a block's items, kept
// across the grid barrier where they fit (Plan::cached). Two blocks a SM:
// 2 x (96 + 8 KB static + 1 KB reserved) of the SM's 228 KB.
constexpr int kCacheBytes = 96 * 1024;
// per-warp (or per-row-group) partial sums of one channel block, in the
// block reduction: 16 warps x 64 channels
constexpr int kRed = kWarps * kMaxCB;
constexpr int kMaxDevices = 64;

struct Plan {
  int n;          // samples
  int cb;         // channels of a channel block: a power of two, at most kMaxCB
  int ncb;        // channel blocks per sample
  int rows;       // rows of an item, a multiple of the 4-wide layout's pass
  int chunks;     // items per (sample, channel block)
  int items;      // n * ncb * chunks
  int grid;       // blocks launched: at most the co-resident blocks
  int per_block;  // items of one block, at most
  int cached;     // 1: every item's rows stay in shared memory across the barrier
};

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// `arrays`: the (rows x cb) tiles an item keeps in shared memory (x; or x
// and g). `max_grid`: the device's co-resident blocks. Chunks are as many as
// fill max_grid with items, at most one item a block where the (sample,
// channel block) pairs allow it.
inline Plan make_plan(int n, int hw, int c, int arrays, int max_grid) {
  Plan p;
  p.n = n;
  p.cb = next_pow2(c) < kMaxCB ? next_pow2(c) : kMaxCB;
  p.ncb = cdiv(c, p.cb);
  const long long pairs = static_cast<long long>(n) * p.ncb;
  const int want = pairs >= max_grid ? 1 : static_cast<int>(max_grid / pairs);
  // rows a pass of the 4-wide layout covers; the 1-wide layout's pass divides it
  const int unit = kThreads / (p.cb / 4 > 1 ? p.cb / 4 : 1);
  p.rows = cdiv(cdiv(hw, want), unit) * unit;
  p.chunks = cdiv(hw, p.rows);
  p.items = static_cast<int>(pairs * p.chunks);
  p.grid = p.items < max_grid ? p.items : max_grid;
  p.per_block = cdiv(p.items, p.grid);
  p.cached = static_cast<long long>(p.per_block) * p.rows * p.cb * arrays * 4 <= kCacheBytes;
  return p;
}

struct Item {
  int n, cblk, chunk;
};

__device__ __forceinline__ Item item_of(const Plan& p, int i) {
  Item it;
  it.chunk = i % p.chunks;
  it.cblk = (i / p.chunks) % p.ncb;
  it.n = i / (p.chunks * p.ncb);
  return it;
}

template <int VEC>
struct Pack {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const float* p) {
  Pack<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const __nv_bfloat16* p) {
  Pack<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = b.x, r.v[3] = b.y;
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const Pack<VEC>& r) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16(r.v[0]);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int VEC>
__device__ __forceinline__ void store(float* p, const Pack<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int VEC>
__device__ __forceinline__ Pack<VEC> zeros() {
  Pack<VEC> r;
#pragma unroll
  for (int v = 0; v < VEC; ++v) r.v[v] = 0.f;
  return r;
}

// Sums a1 and a2 of every thread over the block's row groups, per channel
// of the channel block, in a fixed order: a butterfly over the row groups
// of a warp, then the warps' (or, 64 lanes wide, the row groups') sums one
// after another in fp64. Thread t < cb returns channel t's sums in s1, s2.
template <int VEC>
__device__ __forceinline__ void block_sum(const float (&a1)[VEC], const float (&a2)[VEC],
                                          int lanes, int cb, float (*red)[kRed], double& s1,
                                          double& s2) {
  const int tid = threadIdx.x, lane = tid % lanes, wl = tid & 31;
  float b1[VEC], b2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) b1[v] = a1[v], b2[v] = a2[v];
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      b1[v] += __shfl_xor_sync(0xffffffffu, b1[v], off);
      b2[v] += __shfl_xor_sync(0xffffffffu, b2[v], off);
    }
  }
  const int group = lanes <= 32 ? tid / 32 : tid / lanes;
  const int groups = lanes <= 32 ? kWarps : kThreads / lanes;
  __syncthreads();  // the previous item's sums have been read
  if (lanes > 32 || wl < lanes) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      red[0][group * cb + lane * VEC + v] = b1[v];
      red[1][group * cb + lane * VEC + v] = b2[v];
    }
  }
  __syncthreads();
  s1 = 0.0, s2 = 0.0;
  if (tid < cb) {
    for (int g = 0; g < groups; ++g) {
      s1 += static_cast<double>(red[0][g * cb + tid]);
      s2 += static_cast<double>(red[1][g * cb + tid]);
    }
  }
}

// Sums over the chunks of sample n, channel ch: part holds (N, chunks, 2, C)
// doubles. One warp per (n, ch): lane l takes chunks l, l + 32, ... in
// order, then a butterfly; every lane returns the same sums.
__device__ __forceinline__ void merge_chunks(const double* part, int chunks, int c, int n, int ch,
                                             double& s1, double& s2) {
  s1 = 0.0, s2 = 0.0;
  for (int k = threadIdx.x & 31; k < chunks; k += 32) {
    const double* q = part + (static_cast<size_t>(n) * chunks + k) * 2 * c + ch;
    s1 += q[0];
    s2 += q[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
}

// Blocks of `kernel` (kThreads threads, kCacheBytes of dynamic shared
// memory) that the current device holds at once, queried at the first call
// on each device and kept in `cache`.
inline cudaError_t co_resident(const void* kernel, std::atomic<int>* cache, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = cache[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCacheBytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kCacheBytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = sms * per_sm;
    cache[dev].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return cudaSuccess;
}

// The split of a call on the current device. `k4` and `k1`, the kernel's
// 4-wide and 1-wide instantiations, share it: it takes the smaller of their
// co-resident blocks, so it does not depend on which of them runs.
inline cudaError_t plan_for(const void* k4, std::atomic<int>* cache4, const void* k1,
                            std::atomic<int>* cache1, int n, int hw, int c, int arrays,
                            Plan* p) {
  int b4 = 0, b1 = 0;
  cudaError_t e = co_resident(k4, cache4, &b4);
  if (e == cudaSuccess) e = co_resident(k1, cache1, &b1);
  if (e != cudaSuccess) return e;
  *p = make_plan(n, hw, c, arrays, b4 < b1 ? b4 : b1);
  return cudaSuccess;
}

}  // namespace in_act
