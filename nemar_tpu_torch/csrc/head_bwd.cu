// K-head-bwd: the backward of K-head (head_fwd.cu),
//
//   out[n, y, x, co] = sum_{dy, dx, ci} x[n, r(y + dy - 3), r(x + dx - 3), ci] * W[dy, dx, ci, co],
//
// given g = d out: dX and dW (the bias's gradient, g summed, is the
// caller's).
//
// Replaces the TPU kernels nemar_tpu/ops/conv_head_roll.py:_bwd_kernel
// (B4) and nemar_tpu/ops/attic/conv_head.py:_bwd_kernel (B6).
//
// What bounds it on the H100: arithmetic. dX and dW each cost the
// forward's 1.23 GFLOP per 256 x 256 x 64 -> 3 image (19.7 GFLOP at batch 8,
// 0.29 ms at the 67 TFLOP/s fp32 FMA peak). Three launches:
//
//   1. dX: a block owns an 8 x 32 tile of input pixels and 16 input
//      channels; a thread 4 consecutive pixels of a row and 8 channels. The
//      g window the tile's taps read, (8+6) x (32+6) x Co, zero outside the
//      image, and the chunk's 49 x Co x 16 weights are staged in shared
//      memory; a thread reads 10 g values per (co, dy) and slides its 4
//      pixels' 7 column taps over them. The reflect-pad adjoint is folded
//      into the index map (as in K-block-bwd): input row u is read through
//      tap dy by output row y = i + 3 - dy for every padded row i that
//      reflects to u, i in {u, -u, 2H - 2 - u} within [-3, H + 2], and
//      likewise for columns. Interior pixels have one such (i, j); an edge
//      pixel adds up to 8 more, each a 49-tap correlation over the same
//      staged window (every image row they read lies within 3 rows of u,
//      so inside the window).
//   2. dW partials: a block owns a 32 x 32 pixel tile and 16 input
//      channels, a thread one (dy, ci) and all 7 dx x Co sums. The input
//      window (8+6 rows at a time, reflect-indexed) and the g tile are
//      staged; a thread slides its 7 taps over 14 input values per 8
//      pixels, g read as a broadcast. Each block writes its tile's 49 x 16
//      x Co partial sums.
//   3. dW = the sum of the tiles' partials in tile order, in fp64: no float
//      atomics, so the result does not depend on the blocks' order and two
//      identical runs are bit-identical.
//
// Layouts: x, dx (N, H, W, Ci); g (N, H, W, Co); W, dW (7, 7, Ci, Co) HWIO;
// part (tiles, 49, Ci, Co), tiles = N * ceil(H/32) * ceil(W/32). All fp32.
// Requirements (checked by the wrapper): H, W >= 4, 1 <= Co <= 8.
#include <cuda_runtime.h>

namespace {

constexpr int K7 = 7;
constexpr int PAD = 3;
constexpr int NTAP = K7 * K7;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ int window_index(int i, int n) {
  return reflect(min(max(i, -PAD), n - 1 + PAD), n);
}

// The padded indices i in [-3, n + 2] with reflect(i) == u, u itself first;
// returns how many (1 to 3).
__device__ __forceinline__ int sources(int u, int n, int (&src)[3]) {
  int k = 0;
  src[k++] = u;
  if (u >= 1 && u <= PAD) src[k++] = -u;
  const int hi = 2 * n - 2 - u;
  if (hi >= n && hi <= n - 1 + PAD) src[k++] = hi;
  return k;
}

// ---------------------------------------------------------------------------
// 1. dX
// ---------------------------------------------------------------------------
constexpr int DG_TH = 8, DG_TW = 32;        // input-pixel tile
constexpr int DG_PX = 4;                    // consecutive pixels per thread
constexpr int DG_CIB = 16;                  // input channels per block
constexpr int DG_CT = 8;                    // of which per thread
constexpr int DG_THREADS = DG_TH * DG_TW / DG_PX * (DG_CIB / DG_CT);  // 128
constexpr int DG_SH = DG_TH + 2 * PAD;      // 14 window rows
constexpr int DG_SW = DG_TW + 2 * PAD;      // 38 window columns
constexpr int DG_SWP = 40;

template <int CO>
__global__ void __launch_bounds__(DG_THREADS)
conv_head_dgrad_kernel(const float* __restrict__ g, const float* __restrict__ w,
                       float* __restrict__ dx, int h, int wd, int ci) {
  __shared__ float gs[CO][DG_SH][DG_SWP];
  __shared__ __align__(16) float ws[NTAP][CO][DG_CIB];

  const int tid = threadIdx.x;
  const int cg = tid % (DG_CIB / DG_CT);
  const int pg = tid / (DG_CIB / DG_CT);
  const int r = pg / (DG_TW / DG_PX);
  const int c0 = (pg % (DG_TW / DG_PX)) * DG_PX;
  const int chunks = (ci + DG_CIB - 1) / DG_CIB;
  const int n = blockIdx.z / chunks;
  const int cb = (blockIdx.z - n * chunks) * DG_CIB;
  const int u0 = blockIdx.y * DG_TH, v0 = blockIdx.x * DG_TW;

  // the g window: image rows u0 - 3 .. u0 + TH + 2, zero outside the image
  const float* gb = g + (size_t)n * h * wd * CO;
  for (int e = tid; e < DG_SH * DG_SW * CO; e += DG_THREADS) {
    const int co = e % CO;
    const int pos = e / CO;
    const int sx = pos % DG_SW, sy = pos / DG_SW;
    const int yy = u0 + sy - PAD, xx = v0 + sx - PAD;
    gs[co][sy][sx] = (yy >= 0 && yy < h && xx >= 0 && xx < wd)
                         ? gb[((size_t)yy * wd + xx) * CO + co] : 0.f;
  }
  for (int e = tid; e < NTAP * CO * DG_CIB; e += DG_THREADS) {
    const int c = e % DG_CIB;
    const int co = (e / DG_CIB) % CO;
    const int tap = e / (DG_CIB * CO);
    ws[tap][co][c] = cb + c < ci ? w[((size_t)tap * ci + cb + c) * CO + co] : 0.f;
  }
  __syncthreads();

  float acc[DG_PX][DG_CT];
#pragma unroll
  for (int j = 0; j < DG_PX; ++j)
#pragma unroll
    for (int k = 0; k < DG_CT; ++k) acc[j][k] = 0.f;

  // main term: padded position (u + 3, v + 3) reads g[u + 3 - dy, v + 3 - dx],
  // window row r + 6 - dy, window column c0 + j + 6 - dx
  for (int co = 0; co < CO; ++co) {
    for (int dy = 0; dy < K7; ++dy) {
      float gv[DG_PX + K7 - 1];
#pragma unroll
      for (int k = 0; k < DG_PX + K7 - 1; ++k) gv[k] = gs[co][r + 2 * PAD - dy][c0 + k];
#pragma unroll
      for (int dxx = 0; dxx < K7; ++dxx) {
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[dy * K7 + dxx][co][cg * DG_CT]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[dy * K7 + dxx][co][cg * DG_CT + 4]);
        const float wv[DG_CT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < DG_PX; ++j)
#pragma unroll
          for (int k = 0; k < DG_CT; ++k)
            acc[j][k] = fmaf(gv[j + 2 * PAD - dxx], wv[k], acc[j][k]);
      }
    }
  }

  // the reflect-pad adjoint: the other padded positions that reflect to
  // (u, v), at the image's edges only
  const int u = u0 + r;
  int srow[3];
  const int nrow = sources(u, h, srow);
#pragma unroll
  for (int j = 0; j < DG_PX; ++j) {
    const int v = v0 + c0 + j;
    int scol[3];
    const int ncol = sources(v, wd, scol);
    if (nrow * ncol == 1) continue;
    for (int a = 0; a < nrow; ++a) {
      for (int b = 0; b < ncol; ++b) {
        if (a == 0 && b == 0) continue;
        // window coordinates of g[i + 3 - dy, jj + 3 - dx]
        const int wr = srow[a] + PAD - (u0 - PAD);
        const int wc = scol[b] + PAD - (v0 - PAD);
        for (int dy = 0; dy < K7; ++dy) {
          const int sy = wr - dy;
          if (sy < 0 || sy >= DG_SH) continue;
          for (int dxx = 0; dxx < K7; ++dxx) {
            const int sx = wc - dxx;
            if (sx < 0 || sx >= DG_SW) continue;
            for (int co = 0; co < CO; ++co) {
              const float gval = gs[co][sy][sx];
#pragma unroll
              for (int k = 0; k < DG_CT; ++k)
                acc[j][k] = fmaf(gval, ws[dy * K7 + dxx][co][cg * DG_CT + k], acc[j][k]);
            }
          }
        }
      }
    }
  }

  if (u >= h) return;
#pragma unroll
  for (int j = 0; j < DG_PX; ++j) {
    const int v = v0 + c0 + j;
    if (v >= wd) continue;
    float* o = dx + (((size_t)n * h + u) * wd + v) * ci + cb + cg * DG_CT;
#pragma unroll
    for (int k = 0; k < DG_CT; ++k)
      if (cb + cg * DG_CT + k < ci) o[k] = acc[j][k];
  }
}

// ---------------------------------------------------------------------------
// 2. dW partials, one per (32 x 32 pixel tile, 16 input channels)
// ---------------------------------------------------------------------------
constexpr int WG_TILE = 32;                 // pixel tile: WG_TILE x WG_TILE
constexpr int WG_SUB = 8;                   // rows staged at a time
constexpr int WG_CIB = 16;                  // input channels per block
constexpr int WG_THREADS = K7 * WG_CIB;     // 112: one (dy, ci) each
constexpr int WG_SH = WG_SUB + 2 * PAD;     // 14
constexpr int WG_SW = WG_TILE + 2 * PAD;    // 38
constexpr int WG_SWP = 39;                  // odd pitch: a warp's (dy, ci) reads hit 32 banks
constexpr int WG_PX = 8;                    // pixels per register window

template <int CO>
__global__ void __launch_bounds__(WG_THREADS)
conv_head_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ part, int h, int wd, int ci) {
  __shared__ float xs[WG_SH][WG_CIB][WG_SWP];
  __shared__ float gs[WG_SUB][WG_TILE][CO];

  const int tid = threadIdx.x;
  const int dy = tid / WG_CIB;
  const int cl = tid % WG_CIB;
  const int tiles_x = (wd + WG_TILE - 1) / WG_TILE;
  const int tiles_y = (h + WG_TILE - 1) / WG_TILE;
  const int tile = blockIdx.x;  // over N * tiles_y * tiles_x
  const int n = tile / (tiles_y * tiles_x);
  const int t_in = tile - n * tiles_y * tiles_x;
  const int y0 = (t_in / tiles_x) * WG_TILE, x0 = (t_in % tiles_x) * WG_TILE;
  const int cb = blockIdx.y * WG_CIB;
  const float* xb = x + (size_t)n * h * wd * ci;
  const float* gb = g + (size_t)n * h * wd * CO;

  float acc[K7][CO];
#pragma unroll
  for (int d = 0; d < K7; ++d)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[d][co] = 0.f;

  for (int s0 = 0; s0 < WG_TILE && y0 + s0 < h; s0 += WG_SUB) {
    __syncthreads();  // the previous rows are consumed
    // input window rows y0 + s0 - 3 .. + WG_SUB + 2, reflect-indexed
    for (int e = tid; e < WG_SH * WG_SW * WG_CIB; e += WG_THREADS) {
      const int c = e % WG_CIB;
      const int pos = e / WG_CIB;
      const int sx = pos % WG_SW, sy = pos / WG_SW;
      const int iy = window_index(y0 + s0 + sy - PAD, h), ix = window_index(x0 + sx - PAD, wd);
      xs[sy][c][sx] = cb + c < ci ? xb[((size_t)iy * wd + ix) * ci + cb + c] : 0.f;
    }
    // g rows y0 + s0 .., zero past the image (those pixels add nothing)
    for (int e = tid; e < WG_SUB * WG_TILE * CO; e += WG_THREADS) {
      const int co = e % CO;
      const int pos = e / CO;
      const int px = pos % WG_TILE, py = pos / WG_TILE;
      const int yy = y0 + s0 + py, xx = x0 + px;
      gs[py][px][co] = (yy < h && xx < wd) ? gb[((size_t)yy * wd + xx) * CO + co] : 0.f;
    }
    __syncthreads();

    for (int py = 0; py < WG_SUB; ++py) {
      for (int p0 = 0; p0 < WG_TILE; p0 += WG_PX) {
        float xv[WG_PX + K7 - 1];
#pragma unroll
        for (int k = 0; k < WG_PX + K7 - 1; ++k) xv[k] = xs[py + dy][cl][p0 + k];
#pragma unroll
        for (int j = 0; j < WG_PX; ++j) {
          float gv[CO];
#pragma unroll
          for (int co = 0; co < CO; ++co) gv[co] = gs[py][p0 + j][co];
#pragma unroll
          for (int d = 0; d < K7; ++d)
#pragma unroll
            for (int co = 0; co < CO; ++co) acc[d][co] = fmaf(xv[j + d], gv[co], acc[d][co]);
        }
      }
    }
  }

  if (cb + cl >= ci) return;
#pragma unroll
  for (int d = 0; d < K7; ++d) {
    float* p = part + (((size_t)tile * NTAP + dy * K7 + d) * ci + cb + cl) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co) p[co] = acc[d][co];
  }
}

// ---------------------------------------------------------------------------
// 3. dW = sum of the tiles' partials, in tile order, fp64
// ---------------------------------------------------------------------------
__global__ void head_wgrad_merge_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                        int tiles, int per_tile) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_tile) return;
  double s = 0.0;
  for (int t = 0; t < tiles; ++t) s += (double)part[(size_t)t * per_tile + i];
  dw[i] = (float)s;
}

template <int CO>
cudaError_t launch(const float* x, const float* w, const float* g, float* part, float* dx,
                   float* dw, int n, int h, int wd, int ci, cudaStream_t stream) {
  const dim3 dg_grid((unsigned)((wd + DG_TW - 1) / DG_TW), (unsigned)((h + DG_TH - 1) / DG_TH),
                     (unsigned)(n * ((ci + DG_CIB - 1) / DG_CIB)));
  conv_head_dgrad_kernel<CO><<<dg_grid, DG_THREADS, 0, stream>>>(g, w, dx, h, wd, ci);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = n * ((h + WG_TILE - 1) / WG_TILE) * ((wd + WG_TILE - 1) / WG_TILE);
  const dim3 wg_grid((unsigned)tiles, (unsigned)((ci + WG_CIB - 1) / WG_CIB));
  conv_head_wgrad_kernel<CO><<<wg_grid, WG_THREADS, 0, stream>>>(x, g, part, h, wd, ci);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int per_tile = NTAP * ci * CO;
  head_wgrad_merge_kernel<<<(unsigned)((per_tile + 255) / 256), 256, 0, stream>>>(
      part, dw, tiles, per_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nemar_conv_head_bwd(const float* x, const float* w, const float* g, float* part,
                                   float* dx, float* dw, int n, int h, int wd, int ci, int co,
                                   cudaStream_t stream) {
  switch (co) {
    case 1: return (int)launch<1>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 2: return (int)launch<2>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 3: return (int)launch<3>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 4: return (int)launch<4>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 5: return (int)launch<5>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 6: return (int)launch<6>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 7: return (int)launch<7>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    case 8: return (int)launch<8>(x, w, g, part, dx, dw, n, h, wd, ci, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
