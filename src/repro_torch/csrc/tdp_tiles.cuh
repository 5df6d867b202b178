// Shared pieces of the TDP kernels (tdp_matmul.cu, tdp_matmul_bwd.cu): the
// kept-tile index map and the operand loaders over it.
//
// A TDP pattern keeps weight tile (i, j) of a [K, N] weight iff
// (i + j - bias) % dp == 0.  Along any tile-row or tile-column the kept
// tiles are one residue class mod dp: in tile-column j the kept row-tiles
// are base + s*dp with base = (bias - j) mod dp, and in tile-row i the kept
// column-tiles are (bias - i) mod dp + s*dp.  A kept tile is a whole
// tile x tile block at tile-aligned rows and columns, so a compact index c
// (slot s = c / tile, offset c % tile) maps to source index
// (base + s*dp) * tile + c % tile with shifts, no per-element division.
//
// The tile is 64 or 128 (a multiple of the tiled product's 64-column output
// tile, so one CTA's output columns never straddle two tile-columns, and a
// power of two).  The kernels take dp, bias and the tile's log2 as runtime
// ints: one build serves every bucket.
#pragma once

#include "tile_gemm.cuh"

namespace tdp {

using rdp::BK;
using rdp::BN;
using rdp::kThreads;
using rdp::to_f32;

// Kept residue class of the tiles crossing tile t of the fixed dimension.
__device__ __forceinline__ int kept_base(int bias, int t, int dp) {
  const int r = (bias - t) % dp;
  return r < 0 ? r + dp : r;
}

// Source index of compact index c along the pattern's contracted dimension.
__device__ __forceinline__ int64_t kept_src(int c, int base, int dp,
                                            int tshift) {
  const int s = c >> tshift;
  return ((int64_t)(base + s * dp) << tshift) + (c & ((1 << tshift) - 1));
}

// Row-major [rows, ld] matrix read at kept columns, contraction-fast:
// element (r, c) = p[r][src(c)] for compact column c < kc.
template <typename T> struct KeptCols {
  const T* p;
  int rows, ld, kc, base, dp, tshift;
  __device__ float operator()(int r, int c) const {
    if (r >= rows || c >= kc) return 0.f;
    return to_f32(p[(int64_t)r * ld + kept_src(c, base, dp, tshift)]);
  }
};

// The same matrix read transposed (its kept columns become rows): element
// (c, r) = p[r][src(c)] for compact column c < kc and row r < rows.
template <typename T> struct KeptColsT {
  KeptCols<T> m;
  __device__ float operator()(int c, int r) const { return m(r, c); }
};

// Row-major [K, N] weight read at kept rows: element (c, n) = W[src(c)][n].
template <typename T> struct KeptRows {
  const T* p;
  int N, kc, base, dp, tshift;
  __device__ float operator()(int c, int n) const {
    if (c >= kc || n >= N) return 0.f;
    return to_f32(p[kept_src(c, base, dp, tshift) * N + n]);
  }
};

// Row-major [rows, cols] matrix as the B operand: element (k, n) = p[k][n].
template <typename T> struct Dense {
  const T* p;
  int rows, cols;
  __device__ float operator()(int k, int n) const {
    return (k < rows && n < cols) ? to_f32(p[(int64_t)k * cols + n]) : 0.f;
  }
};

// log2 of a supported tile, or -1.
inline int tile_shift(int tile) {
  return tile == 64 ? 6 : tile == 128 ? 7 : -1;
}

}  // namespace tdp
