// K-head: the ResNet generator's 7x7 output conv over a reflect-padded
// input, to few channels,
//
//   out[n, y, x, co] = sum_{dy, dx, ci} x[n, r(y + dy - 3), r(x + dx - 3), ci] * W[dy, dx, ci, co]
//
// with r() the reflection of ReflectionPad2d(3), Co <= 8 and no bias (the
// caller adds it). Every column is computed here: the TPU kernels leave the
// 3 border columns on each side to an XLA conv, an artefact of their lane
// rolls.
//
// Replaces the TPU kernels nemar_tpu/ops/conv_head_roll.py:_fwd_kernel
// (B4, --c7_impl roll) and nemar_tpu/ops/attic/conv_head.py:_fwd_kernel
// (B6, --block_impl pallas_all): the same function in two TPU layouts.
//
// What bounds it on the H100: arithmetic. At the generator's head (N x 256
// x 256 x 64 -> 3) it is 2 * 49 * 64 * 3 = 18.8 kFLOP per pixel, 1.23 GFLOP
// per image, against 16.8 MB of input: 18 us at the 67 TFLOP/s fp32 FMA
// peak, 5 us of memory. A GEMM tile would waste most of its columns on
// Co = 3, so this is a direct convolution:
//
//   * a block computes an 8 x 64 output tile; it stages 8 input channels of
//     the (8+6) x (64+6) input window at a time in shared memory, reflect
//     indexing in the load (no padded copy is made), with that chunk's
//     49 x 8 x Co weights;
//   * a thread owns 8 consecutive output pixels of one row and all Co
//     channels in registers. For each (channel, dy) it reads the 14 input
//     values its pixels' 7 column taps touch once, then for each dx the Co
//     weights (a broadcast) and does 8 * Co FMAs: 8 * 7 * Co FMAs per
//     14 + 7 * Co shared-memory reads.
//
// Layouts: x (N, H, W, Ci) fp32; W (7, 7, Ci, Co) HWIO fp32; out (N, H, W,
// Co). Requirements (checked by the wrapper): H, W >= 4, 1 <= Co <= 8.
#include <cuda_runtime.h>

namespace {

constexpr int K7 = 7;
constexpr int PAD = 3;
constexpr int TH = 8;                      // output rows per block
constexpr int TW = 64;                     // output columns per block
constexpr int PX = 8;                      // consecutive output columns per thread
constexpr int THREADS = TH * TW / PX;      // 64
constexpr int CC = 8;                      // input channels per staged chunk
constexpr int SH = TH + 2 * PAD;           // 14 staged rows
constexpr int SW = TW + 2 * PAD;           // 70 staged columns
constexpr int SWP = 72;                    // their row pitch

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The reflect-padded index of i, for i in the window of a tile that may
// overhang the image: clamped to [-PAD, n - 1 + PAD] first (what lies past
// that feeds no output).
__device__ __forceinline__ int window_index(int i, int n) {
  return reflect(min(max(i, -PAD), n - 1 + PAD), n);
}

template <int CO>
__global__ void __launch_bounds__(THREADS)
conv_head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
cudaError_t launch(const float* x, const float* w, float* out, int n, int h, int wd, int ci,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((wd + TW - 1) / TW), (unsigned)((h + TH - 1) / TH), (unsigned)n);
  conv_head_fwd_kernel<CO><<<grid, THREADS, 0, stream>>>(x, w, out, h, wd, ci);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nemar_conv_head_fwd(const float* x, const float* w, float* out, int n, int h,
                                   int wd, int ci, int co, cudaStream_t stream) {
  switch (co) {
    case 1: return (int)launch<1>(x, w, out, n, h, wd, ci, stream);
    case 2: return (int)launch<2>(x, w, out, n, h, wd, ci, stream);
    case 3: return (int)launch<3>(x, w, out, n, h, wd, ci, stream);
    case 4: return (int)launch<4>(x, w, out, n, h, wd, ci, stream);
    case 5: return (int)launch<5>(x, w, out, n, h, wd, ci, stream);
    case 6: return (int)launch<6>(x, w, out, n, h, wd, ci, stream);
    case 7: return (int)launch<7>(x, w, out, n, h, wd, ci, stream);
    case 8: return (int)launch<8>(x, w, out, n, h, wd, ci, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
