// The bilinear grid sample's coordinate transform and taps, shared by K-warp
// (warp_fwd.cu) and K-warp-bwd (warp_bwd.cu), so both sample at the same
// fp32 coordinates.
//
// The order of operations is that of
// nemar_tpu_torch/ops/warp.py:_compute_source_coords, each step rounded to
// fp32 as torch rounds it: the adds and multiplies are __fadd_rn /
// __fmul_rn, so no FMA contraction changes a coordinate. The derivative
// (source_coord_slope) is ops/warp.py:_source_coords_and_slope: the clip
// passes half the gradient where a coordinate equals a limit (a quarter where
// both limits are 0), the reflection's |.| has slope +1 at 0, as jax.grad
// gives for jnp.clip and jnp.abs in the JAX package.
#pragma once

#include <cuda_runtime.h>

namespace warp {
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
// (twice_high - twice_low) / 2, d = coord - min, x = |d|, extra = x mod
// 2 span (torch.remainder of a non-negative x: fmod), then min + (extra >
// span ? 2 span - extra : extra). slope *= d(result) / d(coord).
__device__ __forceinline__ float reflect(float coord, float mn, float span, float& slope) {
  const float d = __fadd_rn(coord, -mn);
  const float span2 = 2.f * span;  // exact: a power-of-two scale
  const float extra = fmodf(fabsf(d), span2);
  const bool flip = extra > span;
  slope = (d >= 0.f) != flip ? slope : -slope;
  return __fadd_rn(mn, flip ? __fadd_rn(span2, -extra) : extra);
}

__device__ __forceinline__ float clip(float v, int size) {
  return fminf(fmaxf(v, 0.f), (float)(size - 1));
}

// d clip(v) / d v as jnp.clip = min(max(v, 0), size - 1) under jax.grad:
// max's factor (1 above 0, 1/2 at 0, 0 below) times min's on max's result
// (1 below size - 1, 1/2 at it, 0 above)
__device__ __forceinline__ float clip_slope(float v, int size) {
  const float hi = (float)(size - 1);
  const float up = v > 0.f ? 1.f : (v == 0.f ? 0.5f : 0.f);
  const float m = fmaxf(v, 0.f);
  return up * (m < hi ? 1.f : (m == hi ? 0.5f : 0.f));
}

// _compute_source_coords for one axis; slope = its derivative in g
__device__ __forceinline__ float source_coord_slope(float g, int size, int padding, bool align,
                                                    float& slope) {
  float pix = unnormalize(g, size, align);
  slope = align ? 0.5f * (float)(size - 1) : 0.5f * (float)size;
  if (padding == kReflection) {
    if (align && size == 1) {  // _reflect's zeros
      slope = 0.f;
      return 0.f;
    }
    pix = align ? reflect(pix, 0.f, (float)(size - 1), slope) : reflect(pix, -0.5f, (float)size, slope);
  }
  if (padding != kZeros) {
    slope *= clip_slope(pix, size);
    pix = clip(pix, size);
  }
  return pix;
}

__device__ __forceinline__ float source_coord(float g, int size, int padding, bool align) {
  float slope;
  return source_coord_slope(g, size, padding, align, slope);
}

// The four taps of pixel coordinates (x, y), in the order of
// nemar_tpu/ops/warp.py:_grid_sample_xla: (dy, dx) = (0,0), (0,1), (1,0),
// (1,1). Out-of-frame taps get weight 0 and a clamped (in-frame) offset.
struct Taps {
  int x0, y0;     // the top-left tap (floor of the coordinates)
  float wx, wy;   // fractional parts
  int off[4];     // pixel offsets (iy * W + ix) of the four taps
  bool valid[4];  // in frame
  float wgt[4];   // bilinear weights, zero for out-of-frame taps
};

__device__ __forceinline__ Taps make_taps(float x, float y, int h, int w) {
  Taps t;
  const float fx = floorf(x), fy = floorf(y);
  t.wx = x - fx;
  t.wy = y - fy;
  const float wts[4] = {(1.f - t.wx) * (1.f - t.wy), t.wx * (1.f - t.wy),
                        (1.f - t.wx) * t.wy, t.wx * t.wy};
  // clamp before the casts: a float outside int range must not reach them
  t.x0 = (int)fminf(fmaxf(fx, -2.f), (float)w);
  t.y0 = (int)fminf(fmaxf(fy, -2.f), (float)h);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cx = fx + (k & 1), cy = fy + (k >> 1);
    t.valid[k] = cx >= 0.f && cx < (float)w && cy >= 0.f && cy < (float)h;
    const int ix = (int)fminf(fmaxf(cx, 0.f), (float)(w - 1));
    const int iy = (int)fminf(fmaxf(cy, 0.f), (float)(h - 1));
    t.off[k] = iy * w + ix;
    t.wgt[k] = t.valid[k] ? wts[k] : 0.f;
  }
  return t;
}

}  // namespace
}  // namespace warp
