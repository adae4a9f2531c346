// Each rank's pixels of a sample's band under --mesh_spatial
// (nemar_tpu_torch/parallel/spatial.py), for the band stages that merge
// every rank's tile partials of a mean and M2 (K-block's and K-convt's
// statistics): a tile's count is its rank's pixels past the tile's start,
// clipped to [0, tile], so the ranks' bands may be uneven, one row or
// empty. The caller pads every rank's partials to the largest band's tile
// count (zeros past its own), so they all-gather in one shape; the counts
// come from the host (an int a rank) and reach the kernel by value.
#pragma once

constexpr int kMaxBandRanks = 32;

struct BandPixels {
  int ranks;
  int px[kMaxBandRanks];
};

// band_hw: the host's array of each rank's pixels; false past kMaxBandRanks
inline bool band_pixels(const int* band_hw, int ranks, BandPixels& bp) {
  if (ranks < 1 || ranks > kMaxBandRanks) return false;
  bp.ranks = ranks;
  for (int r = 0; r < ranks; ++r) bp.px[r] = band_hw[r];
  for (int r = ranks; r < kMaxBandRanks; ++r) bp.px[r] = 0;
  return true;
}

// one process: the whole frame's hw pixels
inline BandPixels one_band(int hw) {
  BandPixels bp;
  bp.ranks = 1;
  bp.px[0] = hw;
  for (int r = 1; r < kMaxBandRanks; ++r) bp.px[r] = 0;
  return bp;
}

__host__ __device__ inline double band_total(const BandPixels& bp) {
  double s = 0.0;
  for (int r = 0; r < bp.ranks; ++r) s += (double)bp.px[r];
  return s;
}

// the pixels of tile t (tile pixels each) of rank r's band
__host__ __device__ inline int tile_count(const BandPixels& bp, int r, int t, int tile) {
  const long long left = (long long)bp.px[r] - (long long)t * tile;
  return left <= 0 ? 0 : (left < tile ? (int)left : tile);
}
