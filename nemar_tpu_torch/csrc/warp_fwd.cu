// K-warp: forward of the bilinear grid sample with zeros padding.
//
// Replaces the TPU kernel nemar_tpu/ops/warp_pallas.py:_fwd_pallas
// (_fwd_kernel), reached through _warp_core / grid_sample_pallas. Like it,
// this kernel takes PIXEL coordinates: the unnormalisation, the padding-mode
// transform and align_corners stay outside, in torch
// (nemar_tpu_torch/ops/warp.py:_compute_source_coords), so 'border' and
// 'reflection' arrive here as in-frame coordinates and the kernel only has
// to zero out-of-frame taps.
//
// What bounds it on the H100: bytes. Per output pixel it reads two
// coordinates and four taps of C channels and writes C channels; there is
// no arithmetic to speak of. The TPU kernel had to build one-hot tap
// matrices and contract them on the MXU because a TPU gather is a serial
// loop; here a gather is a plain load, so the design is the direct one: one
// thread per output pixel, floor + four validity tests, then a loop over
// the channels, which are contiguous in NHWC. Neighbouring threads read
// neighbouring coordinates (coalesced) and mostly overlapping taps (L1/L2
// hits). When C % 4 == 0 the channel loop moves float4s.
//
// Layouts: img (N, H, W, C) fp32, xs/ys (N, Ho, Wo) fp32, out (N, Ho, Wo, C)
// fp32, all contiguous. No shape restriction (the TPU slab bound, its
// lax.cond fallbacks and the one-hot/shift split have no counterpart).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int off[4];     // pixel offsets (iy * W + ix) of the four taps
  float wgt[4];   // bilinear weights, zero for out-of-frame taps
};

// Tap order and weights as in nemar_tpu/ops/warp.py:_grid_sample_xla:
// (dy, dx) = (0,0), (0,1), (1,0), (1,1).
__device__ __forceinline__ Taps make_taps(float x, float y, int h, int w) {
  Taps t;
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx = x - x0, wy = y - y0;
  const float wts[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy),
                        (1.f - wx) * wy, wx * wy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cx = x0 + (k & 1), cy = y0 + (k >> 1);
    const bool valid = cx >= 0.f && cx < (float)w && cy >= 0.f && cy < (float)h;
    // clamp before the cast: a float outside int range must not reach it
    const int ix = (int)fminf(fmaxf(cx, 0.f), (float)(w - 1));
    const int iy = (int)fminf(fmaxf(cy, 0.f), (float)(h - 1));
    t.off[k] = iy * w + ix;
    t.wgt[k] = valid ? wts[k] : 0.f;
  }
  return t;
}

__global__ void warp_bilinear_kernel(const float* __restrict__ img,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ys,
                                     float* __restrict__ out, int n, int h,
                                     int w, int c, int p_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n * p_out) return;
  const int b = (int)(p / p_out);
  const Taps t = make_taps(xs[p], ys[p], h, w);
  const float* base = img + (size_t)b * h * w * c;
  float* o = out + (size_t)p * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += base[(size_t)t.off[k] * c + ch] * t.wgt[k];
    o[ch] = acc;
  }
}

__global__ void warp_bilinear_vec4_kernel(const float* __restrict__ img,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ ys,
                                          float* __restrict__ out, int n,
                                          int h, int w, int c, int p_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n * p_out) return;
  const int b = (int)(p / p_out);
  const Taps t = make_taps(xs[p], ys[p], h, w);
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

extern "C" int nemar_warp_bilinear_fwd(const float* img, const float* xs,
                                       const float* ys, float* out, int n,
                                       int h, int w, int c, int ho, int wo,
                                       cudaStream_t stream) {
  const long long total = (long long)n * ho * wo;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const bool vec4 = (c % 4 == 0) &&
                    ((reinterpret_cast<uintptr_t>(img) |
                      reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (vec4) {
    warp_bilinear_vec4_kernel<<<blocks, threads, 0, stream>>>(img, xs, ys, out, n, h, w, c, ho * wo);
  } else {
    warp_bilinear_kernel<<<blocks, threads, 0, stream>>>(img, xs, ys, out, n, h, w, c, ho * wo);
  }
  return (int)cudaGetLastError();
}
