// K-in and K-in-bwd in band form: instance norm + activation over a frame
// whose rows are split in bands over the ranks of a spatial group
// (--mesh_spatial; nemar_tpu_torch/parallel/spatial.py). The statistics
// are the whole frame's, so the single cooperative launch of in_act_fwd.cu
// is cut where its grid barrier was, and the barrier becomes a collective:
//
//   forward   1. nemar_in_band_fwd_part: per (sample, chunk of `rows`
//               pixels of the band, channel) the chunk's (count, mean, M2)
//               in fp64, to part (N, chunks, 3, C);
//             the caller all-gathers part over the spatial group into
//             parts (ranks, N, chunks, 3, C);
//             2. nemar_in_band_fwd_apply: each block merges its channels'
//               partials of every rank in one fixed order (rank, then
//               chunk; mean = sum c_t m_t / P, M2 = sum M2_t + c_t (m_t -
//               mean)^2, Chan's formula, fp64) into (mean, rstd), writes
//               them to stats (N, 2, C) from its first pixel range, and
//               applies y = act((x - mean) * rstd) to its pixels.
//   backward  1. nemar_in_band_bwd_part: per chunk the fp64 sums of
//               gh = g * act'(yhat) and gh * yhat, to part (N, chunks, 2, C);
//             the caller all-gathers them;
//             2. nemar_in_band_bwd_apply: m1 = sum gh / P, m2 = sum gh yhat
//               / P in the same fixed order (P the frame's pixels), then
//               dx = rstd * (gh - m1 - yhat * m2).
//
// Every rank merges the same partials in the same order, so every rank
// holds the same bits of the frame's statistics; two identical calls give
// the same bits (no atomics). The chunks of a band past its pixels have
// count 0 (a band of fewer pixels than another: D's odd heights, uneven
// and one-row bands, an empty band, whose partials are all 0), so the
// gathered partials have one shape on every rank.
//
// Replaces, with K-in (in_act_fwd.cu) and K-in-bwd (in_act_bwd.cu), the TPU
// kernel nemar_tpu/ops/norm.py:_instance_norm_act_pallas, whose sharded
// form under GSPMD's spatial axis all-reduces the same sums.
//
// What bounds it on the H100: bytes. Each stage reads the band once (the
// part stage twice, from L2: the chunk's mean, then its squared deviations)
// and the apply writes it once; the partials are N * chunks * 3 * C
// doubles, a few hundred KB. One thread per channel walks a chunk's pixels,
// the block's threads on neighbouring channels (NHWC: coalesced).
//
// Layouts: x, y, g, dx (N, H_band, W, C) fp32 contiguous, hw = H_band * W
// (0 for an empty band); stats (N, 2, C) fp32. Any N, C >= 1.
//
// The bf16 variant (--bf16; the *_bf16 launchers) is the same four stages
// with x, y, g and dx in bf16, as in_act_fwd.cu's and in_act_bwd.cu's bf16
// variants take them: each element widened to fp32 on the load (exact),
// the partials and merges fp64, the arithmetic fp32 and the statistics
// fp32, y and dx rounded to bf16 once, where they are stored. The
// partials' fp64 merge is not the whole-frame variant's fp32 one, so a
// value within an fp32 roundoff of a bf16 rounding boundary can round the
// other way than in one process.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// an element of x, g (T = float or bf16) in fp32, and an fp32 value stored
// as T (rounded to nearest for bf16)
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

constexpr int kThreads = 128;  // channels of a block
constexpr int kApplyPixels = 256;  // pixels of an apply block

__device__ __forceinline__ float act_fwd(float t, int act, float slope) {
  return act == 1 ? fmaxf(t, 0.f) : act == 2 ? (t >= 0.f ? t : t * slope) : t;
}

__device__ __forceinline__ float act_grad(float yh, float g, int act, float slope) {
  return act == 1 ? (yh > 0.f ? g : 0.f) : act == 2 ? (yh >= 0.f ? g : g * slope) : g;
}

// grid (chunks, N, ceil(C / kThreads))
template <class T>
__global__ void in_band_fwd_part_kernel(const T* __restrict__ x, double* __restrict__ part,
                                        int hw, int c, int rows, int chunks) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= c) return;
  const int p0 = min(chunk * rows, hw), p1 = min(p0 + rows, hw);
  const T* xs = x + (size_t)b * hw * c + ch;
  double s = 0.0;
  for (int p = p0; p < p1; ++p) s += (double)wide(xs[(size_t)p * c]);
  const int count = p1 - p0;
  const double mean = count > 0 ? s / count : 0.0;
  double m2 = 0.0;
  for (int p = p0; p < p1; ++p) {
    const double d = (double)wide(xs[(size_t)p * c]) - mean;
    m2 += d * d;
  }
  double* q = part + ((size_t)b * chunks + chunk) * 3 * c + ch;
  q[0] = (double)count;
  q[c] = mean;
  q[2 * c] = m2;
}

// (mean, rstd) of channel ch of sample b from every rank's partials, in
// rank then chunk order
__device__ void merge_fwd(const double* __restrict__ parts, int ranks, int n, int chunks, int c,
                          int b, int ch, float eps, float& mean_out, float& rstd_out) {
  double count = 0.0, s = 0.0;
  for (int r = 0; r < ranks; ++r)
    for (int t = 0; t < chunks; ++t) {
      const double* q = parts + (((size_t)r * n + b) * chunks + t) * 3 * c + ch;
      count += q[0];
      s += q[0] * q[c];
    }
  const double mean = s / count;
  double m2 = 0.0;
  for (int r = 0; r < ranks; ++r)
    for (int t = 0; t < chunks; ++t) {
      const double* q = parts + (((size_t)r * n + b) * chunks + t) * 3 * c + ch;
      const double d = q[c] - mean;
      m2 += q[2 * c] + q[0] * d * d;
    }
  mean_out = (float)mean;
  rstd_out = (float)(1.0 / sqrt(m2 / count + (double)eps));
}

// grid (ceil(hw / kApplyPixels), N, ceil(C / kThreads))
template <class T>
__global__ void in_band_fwd_apply_kernel(const T* __restrict__ x,
                                         const double* __restrict__ parts, T* __restrict__ y,
                                         float* __restrict__ stats, int ranks, int n, int hw,
                                         int c, int chunks, int act, float eps, float slope) {
  const int b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= c) return;
  float mean, rstd;
  merge_fwd(parts, ranks, n, chunks, c, b, ch, eps, mean, rstd);
  if (blockIdx.x == 0) {
    stats[(size_t)b * 2 * c + ch] = mean;
    stats[(size_t)b * 2 * c + c + ch] = rstd;
  }
  const int p0 = blockIdx.x * kApplyPixels, p1 = min(p0 + kApplyPixels, hw);
  const size_t base = (size_t)b * hw * c + ch;
  for (int p = p0; p < p1; ++p)
    y[base + (size_t)p * c] =
        narrow<T>(act_fwd((wide(x[base + (size_t)p * c]) - mean) * rstd, act, slope));
}

// grid (chunks, N, ceil(C / kThreads))
template <class T>
__global__ void in_band_bwd_part_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                        const float* __restrict__ stats,
                                        double* __restrict__ part, int hw, int c, int rows,
                                        int chunks, int act, float slope) {
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= c) return;
  const float mean = stats[(size_t)b * 2 * c + ch], rstd = stats[(size_t)b * 2 * c + c + ch];
  const int p0 = min(chunk * rows, hw), p1 = min(p0 + rows, hw);
  const size_t base = (size_t)b * hw * c + ch;
  double s1 = 0.0, s2 = 0.0;
  for (int p = p0; p < p1; ++p) {
    const float yh = (wide(x[base + (size_t)p * c]) - mean) * rstd;
    const float gh = act_grad(yh, wide(g[base + (size_t)p * c]), act, slope);
    s1 += (double)gh;
    s2 += (double)gh * (double)yh;
  }
  double* q = part + ((size_t)b * chunks + chunk) * 2 * c + ch;
  q[0] = s1;
  q[c] = s2;
}

// grid (ceil(hw / kApplyPixels), N, ceil(C / kThreads))
template <class T>
__global__ void in_band_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                         const float* __restrict__ stats,
                                         const double* __restrict__ parts, T* __restrict__ dx,
                                         int ranks, int n, int hw, int c, int chunks,
                                         double frame_pixels, int act, float slope) {
  const int b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= c) return;
  double s1 = 0.0, s2 = 0.0;
  for (int r = 0; r < ranks; ++r)
    for (int t = 0; t < chunks; ++t) {
      const double* q = parts + (((size_t)r * n + b) * chunks + t) * 2 * c + ch;
      s1 += q[0];
      s2 += q[c];
    }
  const float m1 = (float)(s1 / frame_pixels), m2 = (float)(s2 / frame_pixels);
  const float mean = stats[(size_t)b * 2 * c + ch], rstd = stats[(size_t)b * 2 * c + c + ch];
  const int p0 = blockIdx.x * kApplyPixels, p1 = min(p0 + kApplyPixels, hw);
  const size_t base = (size_t)b * hw * c + ch;
  for (int p = p0; p < p1; ++p) {
    const float yh = (wide(x[base + (size_t)p * c]) - mean) * rstd;
    const float gh = act_grad(yh, wide(g[base + (size_t)p * c]), act, slope);
    dx[base + (size_t)p * c] = narrow<T>(rstd * (gh - m1 - yh * m2));
  }
}

dim3 part_grid(int chunks, int n, int c) {
  return dim3((unsigned)chunks, (unsigned)n, (unsigned)((c + kThreads - 1) / kThreads));
}

// at least one block a (sample, channel block), which writes the
// statistics: an empty band (--mesh_spatial, a level thinner than the
// group) still gives its saved statistics, and CUDA takes no empty grid
dim3 apply_grid(int hw, int n, int c) {
  return dim3((unsigned)max(1, (hw + kApplyPixels - 1) / kApplyPixels), (unsigned)n,
              (unsigned)((c + kThreads - 1) / kThreads));
}

template <class T>
int fwd_part(const T* x, double* part, int n, int hw, int c, int rows, int chunks,
             cudaStream_t stream) {
  in_band_fwd_part_kernel<T><<<part_grid(chunks, n, c), kThreads, 0, stream>>>(x, part, hw, c,
                                                                               rows, chunks);
  return (int)cudaGetLastError();
}

template <class T>
int fwd_apply(const T* x, const double* parts, T* y, float* stats, int ranks, int n, int hw,
              int c, int chunks, int act, float eps, float slope, cudaStream_t stream) {
  in_band_fwd_apply_kernel<T><<<apply_grid(hw, n, c), kThreads, 0, stream>>>(
      x, parts, y, stats, ranks, n, hw, c, chunks, act, eps, slope);
  return (int)cudaGetLastError();
}

template <class T>
int bwd_part(const T* x, const T* g, const float* stats, double* part, int n, int hw, int c,
             int rows, int chunks, int act, float slope, cudaStream_t stream) {
  in_band_bwd_part_kernel<T><<<part_grid(chunks, n, c), kThreads, 0, stream>>>(
      x, g, stats, part, hw, c, rows, chunks, act, slope);
  return (int)cudaGetLastError();
}

template <class T>
int bwd_apply(const T* x, const T* g, const float* stats, const double* parts, T* dx, int ranks,
              int n, int hw, int c, int chunks, long long frame_pixels, int act, float slope,
              cudaStream_t stream) {
  in_band_bwd_apply_kernel<T><<<apply_grid(hw, n, c), kThreads, 0, stream>>>(
      x, g, stats, parts, dx, ranks, n, hw, c, chunks, (double)frame_pixels, act, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's CUDA error code. act: 0 none, 1 relu, 2 leaky_relu.
// The *_bf16 launchers take x, y, g and dx in bf16; stats and the partials
// are fp32 and fp64 in both.
extern "C" int nemar_in_band_fwd_part(const float* x, double* part, int n, int hw, int c, int rows,
                                      int chunks, cudaStream_t stream) {
  return fwd_part(x, part, n, hw, c, rows, chunks, stream);
}

extern "C" int nemar_in_band_fwd_apply(const float* x, const double* parts, float* y,
                                       float* stats, int ranks, int n, int hw, int c, int chunks,
                                       int act, float eps, float slope, cudaStream_t stream) {
  return fwd_apply(x, parts, y, stats, ranks, n, hw, c, chunks, act, eps, slope, stream);
}

extern "C" int nemar_in_band_bwd_part(const float* x, const float* g, const float* stats,
                                      double* part, int n, int hw, int c, int rows, int chunks,
                                      int act, float slope, cudaStream_t stream) {
  return bwd_part(x, g, stats, part, n, hw, c, rows, chunks, act, slope, stream);
}

extern "C" int nemar_in_band_bwd_apply(const float* x, const float* g, const float* stats,
                                       const double* parts, float* dx, int ranks, int n, int hw,
                                       int c, int chunks, long long frame_pixels, int act,
                                       float slope, cudaStream_t stream) {
  return bwd_apply(x, g, stats, parts, dx, ranks, n, hw, c, chunks, frame_pixels, act, slope,
                   stream);
}

extern "C" int nemar_in_band_fwd_part_bf16(const bf16* x, double* part, int n, int hw, int c,
                                           int rows, int chunks, cudaStream_t stream) {
  return fwd_part(x, part, n, hw, c, rows, chunks, stream);
}

extern "C" int nemar_in_band_fwd_apply_bf16(const bf16* x, const double* parts, bf16* y,
                                            float* stats, int ranks, int n, int hw, int c,
                                            int chunks, int act, float eps, float slope,
                                            cudaStream_t stream) {
  return fwd_apply(x, parts, y, stats, ranks, n, hw, c, chunks, act, eps, slope, stream);
}

extern "C" int nemar_in_band_bwd_part_bf16(const bf16* x, const bf16* g, const float* stats,
                                           double* part, int n, int hw, int c, int rows,
                                           int chunks, int act, float slope, cudaStream_t stream) {
  return bwd_part(x, g, stats, part, n, hw, c, rows, chunks, act, slope, stream);
}

extern "C" int nemar_in_band_bwd_apply_bf16(const bf16* x, const bf16* g, const float* stats,
                                            const double* parts, bf16* dx, int ranks, int n,
                                            int hw, int c, int chunks, long long frame_pixels,
                                            int act, float slope, cudaStream_t stream) {
  return bwd_apply(x, g, stats, parts, dx, ranks, n, hw, c, chunks, frame_pixels, act, slope,
                   stream);
}
