// K-warp: forward of the bilinear grid sample, from the normalised grid.
//
// Replaces the TPU kernel nemar_tpu/ops/warp_pallas.py:_fwd_pallas
// (_fwd_kernel), reached through _warp_core / grid_sample_pallas, and with
// it the coordinate transform the JAX package runs in XLA before that
// kernel: this kernel takes the normalised grid (N, Ho, Wo, 2), (x, y) in
// [-1, 1], and computes each source pixel coordinate itself, with
// padding_mode (zeros / border / reflection) and align_corners, in the
// order of operations of nemar_tpu_torch/ops/warp.py:_compute_source_coords
// (each step rounded to fp32 as torch rounds it: the adds and multiplies
// are __fadd_rn / __fmul_rn, so no FMA contraction changes a coordinate).
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

namespace {

enum Padding { kZeros = 0, kBorder = 1, kReflection = 2 };

// _unnormalize: align_corners ? (g + 1) * 0.5 * (size - 1)
//                             : ((g + 1) * size - 1) * 0.5
__device__ __forceinline__ float unnormalize(float g, int size, bool align) {
  const float s1 = __fadd_rn(g, 1.f);
  if (align) return __fmul_rn(__fmul_rn(s1, 0.5f), (float)(size - 1));
  return __fmul_rn(__fadd_rn(__fmul_rn(s1, (float)size), -1.f), 0.5f);
}

// _reflect(coord, twice_low, twice_high): min = twice_low / 2, span =
// (twice_high - twice_low) / 2, x = |coord - min|, extra = x mod 2 span
// (torch.remainder of a non-negative x: fmod), then min + (extra > span ?
// 2 span - extra : extra).
__device__ __forceinline__ float reflect(float coord, float mn, float span) {
  const float x = fabsf(__fadd_rn(coord, -mn));
  const float span2 = 2.f * span;  // exact: a power-of-two scale
  const float extra = fmodf(x, span2);
  return __fadd_rn(mn, extra > span ? __fadd_rn(span2, -extra) : extra);
}

__device__ __forceinline__ float clip(float v, int size) {
  return fminf(fmaxf(v, 0.f), (float)(size - 1));
}

// _compute_source_coords for one axis
__device__ __forceinline__ float source_coord(float g, int size, int padding, bool align) {
  float pix = unnormalize(g, size, align);
  if (padding == kBorder) {
    pix = clip(pix, size);
  } else if (padding == kReflection) {
    if (size == 1) {
      pix = 0.f;  // _reflect's zeros (align_corners), or the clip to [0, 0]
    } else if (align) {
      pix = reflect(pix, 0.f, (float)(size - 1));
    } else {
      pix = reflect(pix, -0.5f, (float)size);
    }
    pix = clip(pix, size);
  }
  return pix;
}

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

__device__ __forceinline__ Taps grid_taps(const float2* grid, long long p, int h, int w,
                                          int padding, bool align) {
  const float2 gxy = grid[p];
  return make_taps(source_coord(gxy.x, w, padding, align),
                   source_coord(gxy.y, h, padding, align), h, w);
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
