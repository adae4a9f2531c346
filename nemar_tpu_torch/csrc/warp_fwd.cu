// K-warp: forward of the bilinear grid sample, from the normalised grid.
//
// Replaces the TPU kernel nemar_tpu/ops/warp_pallas.py:_fwd_pallas
// (_fwd_kernel), reached through _warp_core / grid_sample_pallas, and with
// it the coordinate transform the JAX package runs in XLA before that
// kernel: this kernel takes the normalised grid (N, Ho, Wo, 2), (x, y) in
// [-1, 1], and computes each source pixel coordinate itself, with
// padding_mode (zeros / border / reflection) and align_corners, in the
// order of operations of nemar_tpu_torch/ops/warp.py:_compute_source_coords
// (warp_coords.cuh, shared with K-warp-bwd).
// The taps are then zeros-padded, as in the TPU kernel: 'border' and
// 'reflection' arrive at in-frame coordinates.
//
// What bounds it on the H100: bytes. Per output pixel it reads one float2
// of grid and four taps of C channels and writes C channels. A TPU gather
// is a serial loop, so the TPU kernel builds one-hot tap matrices and
// contracts them on the MXU; here a gather is a plain load, so the design
// is the direct one: one thread per output pixel, the coordinate transform
// in registers, floor + four validity tests, then a loop over the channels
// (contiguous in NHWC, float4-wide when C % 4 == 0). Neighbouring threads
// read neighbouring grid entries (coalesced) and mostly overlapping taps
// (L1/L2 hits). At the slice's sizes (N x 256 x 256 x 4) the launch and the
// host path cost more than the bytes: one launch from grid to output
// replaces the ~10 torch launches of the coordinate transform before it.
//
// Layouts: img (N, H, W, C) fp32, grid (N, Ho, Wo, 2) fp32, out
// (N, Ho, Wo, C) fp32, all contiguous. No shape restriction.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_coords.cuh"

namespace {

using warp::Taps;

__device__ __forceinline__ Taps grid_taps(const float2* grid, long long p, int h, int w,
                                          int padding, bool align) {
  const float2 gxy = grid[p];
  return warp::make_taps(warp::source_coord(gxy.x, w, padding, align),
                         warp::source_coord(gxy.y, h, padding, align), h, w);
}

__global__ void warp_grid_kernel(const float* __restrict__ img, const float2* __restrict__ grid,
                                 float* __restrict__ out, int n, int h, int w, int c,
                                 int p_out, int padding, bool align) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n * p_out) return;
  const int b = (int)(p / p_out);
  const Taps t = grid_taps(grid, p, h, w, padding, align);
  const float* base = img + (size_t)b * h * w * c;
  float* o = out + (size_t)p * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += base[(size_t)t.off[k] * c + ch] * t.wgt[k];
    o[ch] = acc;
  }
}

__global__ void warp_grid_vec4_kernel(const float* __restrict__ img,
                                      const float2* __restrict__ grid,
                                      float* __restrict__ out, int n, int h, int w, int c,
                                      int p_out, int padding, bool align) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n * p_out) return;
  const int b = (int)(p / p_out);
  const Taps t = grid_taps(grid, p, h, w, padding, align);
  const int c4 = c >> 2;
  const float4* base = reinterpret_cast<const float4*>(img) + (size_t)b * h * w * c4;
  float4* o = reinterpret_cast<float4*>(out) + (size_t)p * c4;
  for (int q = 0; q < c4; ++q) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = base[(size_t)t.off[k] * c4 + q];
      const float g = t.wgt[k];
      acc.x += v.x * g;
      acc.y += v.y * g;
      acc.z += v.z * g;
      acc.w += v.w * g;
    }
    o[q] = acc;
  }
}

}  // namespace

// padding: 0 zeros, 1 border, 2 reflection. grid must be 8-byte aligned.
extern "C" int nemar_warp_grid_fwd(const float* img, const float* grid, float* out, int n, int h,
                                   int w, int c, int ho, int wo, int padding, int align_corners,
                                   cudaStream_t stream) {
  const long long total = (long long)n * ho * wo;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const float2* g2 = reinterpret_cast<const float2*>(grid);
  const bool vec4 = (c % 4 == 0) &&
                    ((reinterpret_cast<uintptr_t>(img) |
                      reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (vec4) {
    warp_grid_vec4_kernel<<<blocks, threads, 0, stream>>>(img, g2, out, n, h, w, c, ho * wo,
                                                          padding, align_corners != 0);
  } else {
    warp_grid_kernel<<<blocks, threads, 0, stream>>>(img, g2, out, n, h, w, c, ho * wo, padding,
                                                     align_corners != 0);
  }
  return (int)cudaGetLastError();
}
