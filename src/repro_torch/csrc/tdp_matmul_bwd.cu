// Backward products of the TDP masked matmul for Hopper (sm_90a): the
// activation gradient (dgrad) and the compact weight gradient (wgrad) of
// C = (A @ (W o mask)) * scale, mask keeping tile (i, j) iff
// (i + j - bias) % dp == 0.
//
// Replace the TPU kernels tdp_dgrad and tdp_wgrad
// (src/repro/kernels/tdp_matmul_bwd.py:38 and :100).  With M the tokens of a
// training step:
//
//   dgrad  dA[M, K] = dC[M, N] @ (W o mask)^T * scale.  Output tile-column i
//          (a tile-row of W) sums the kept output tiles
//          j = (bias - i) mod dp + s*dp, s < tc/dp: needs dp | N/tile.
//   wgrad  dWc[K/dp, N]: slot s of tile-column j holds
//          A[:, tile i]^T @ dC[:, tile j] * scale for the kept row-tile
//          i = (bias - j) mod dp + s*dp, the forward's enumeration.  The
//          caller places it into a zeroed dW, so dropped tiles get exactly
//          zero gradient.
//
// At training sizes (M ~ 2048) both do 2 * M * K * N / dp operations on a
// few MB of operands: bound by operations.  Neither reads a dropped tile of
// W, nor the matching slices of dC (dgrad) or A (wgrad).  The Pallas
// kernels carry an f32 scratch across a sequential grid axis; here one CTA
// loops over its compact contraction in shared-memory stages
// (rdp::tile_product, FMA on CUDA cores, f32 accumulation) and a short
// output splits the contraction across CTAs into f32 partials summed in a
// fixed order by a second pass.  dgrad reads W's kept tiles transposed, and
// wgrad A's kept columns transposed: both are fetched along their contiguous
// index and transposed into shared memory with tile_product's XOR-swizzled
// stores.
#include "tdp_tiles.cuh"

namespace tdp {

struct Args {
  const void* x;   // dC (dgrad) or the forward activation A (wgrad)
  const void* y;   // W (dgrad) or dC (wgrad)
  void* out;
  void* ws;
  int M, K, N, dp, bias, tshift, splits, k_split;
  float scale;
  cudaStream_t stream;
};

enum Which { DGRAD = 0, WGRAD = 1 };
constexpr int BM = 64;

// Output [rows, cols] and compact contraction length of each product; K x N
// is the forward weight's shape, M the tokens.
__host__ __device__ inline void dims(int which, int M, int K, int N, int dp,
                                     int* rows, int* cols, int* kc) {
  if (which == DGRAD) {
    *rows = M; *cols = K; *kc = N / dp;
  } else {
    *rows = K / dp; *cols = N; *kc = M;
  }
}

template <typename T, int WHICH>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* x, const T* y, T* out, float* ws, int M, int K, int N,
           int dp, int bias, int tshift, int k_split, float scale) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  int rows, cols, kc;
  dims(WHICH, M, K, N, dp, &rows, &cols, &kc);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k0 = s * k_split, k1 = min(kc, k0 + k_split);
  // the CTA's output columns lie in one tile: a tile-row of W (dgrad) or a
  // tile-column (wgrad); either way its kept class is (bias - t) mod dp
  const int base = kept_base(bias, n0 >> tshift, dp);
  float acc[BM / 16][4] = {};
  if constexpr (WHICH == DGRAD) {
    // x = dC [M, N] at kept columns; y = W [K, N], kept columns transposed
    rdp::tile_product<BM, true, true>(
        KeptCols<T>{x, M, N, kc, base, dp, tshift},
        KeptColsT<T>{{y, K, N, kc, base, dp, tshift}}, m0, n0, k0, k1, As,
        Bs, acc);
  } else {
    // x = A [M, K], kept columns transposed; y = dC [M, N]
    rdp::tile_product<BM, false, false>(
        KeptColsT<T>{{x, M, K, rows, base, dp, tshift}}, Dense<T>{y, M, N},
        m0, n0, k0, k1, As, Bs, acc);
  }
  rdp::store_tile<T, BM>(acc, out, ws, s, gridDim.z, rows, cols, m0, n0,
                         scale);
}

template <typename T, int WHICH>
cudaError_t launch(const Args& g) {
  int rows, cols, kc;
  dims(WHICH, g.M, g.K, g.N, g.dp, &rows, &cols, &kc);
  dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM, g.splits);
  bwd_kernel<T, WHICH><<<grid, kThreads, 0, g.stream>>>(
      (const T*)g.x, (const T*)g.y, (T*)g.out, (float*)g.ws, g.M, g.K, g.N,
      g.dp, g.bias, g.tshift, g.k_split, g.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return rdp::launch_reduce<T>((const float*)g.ws, (T*)g.out,
                               (int64_t)rows * cols, g.splits, g.scale,
                               g.stream);
}

template <int WHICH>
int entry(const Args& g, int dtype, int tile) {
  // the pattern dimension whose tile count dp must divide: N for the
  // dgrad's kept output tiles, K for the wgrad's kept row-tiles
  const int pdim = WHICH == DGRAD ? g.N : g.K;
  if (g.tshift < 0 || g.M < 1 || g.K < 1 || g.N < 1 || g.dp < 1 ||
      g.K % tile || g.N % tile || (pdim / tile) % g.dp || g.bias < 0 ||
      g.bias >= g.dp)
    return (int)cudaErrorInvalidValue;
  int rows, cols, kc;
  dims(WHICH, g.M, g.K, g.N, g.dp, &rows, &cols, &kc);
  if (g.splits < 1 || g.k_split < 1 || g.k_split % BK ||
      (int64_t)(g.splits - 1) * g.k_split >= kc ||
      (int64_t)g.splits * g.k_split < kc || (g.splits > 1 && g.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float, WHICH>(g);
  if (dtype == 1) return (int)launch<__nv_bfloat16, WHICH>(g);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tdp

// Both entry points: x, y, out, ws (f32 partials, splits x rows x cols, or
// null when splits == 1), dtype (0 f32, 1 bf16), M tokens, K x N the forward
// weight's shape, dp, bias in [0, dp), tile (64 or 128), splits, k_split (a
// multiple of 32), scale, stream.  Returns cudaGetLastError() of the
// launches.
#define TDP_BWD_ENTRY(name, which)                                          \
  extern "C" int name(const void* x, const void* y, void* out, void* ws,     \
                      int dtype, int M, int K, int N, int dp, int bias,     \
                      int tile, int splits, int k_split, float scale,       \
                      void* stream) {                                       \
    const tdp::Args g{x, y, out, ws, M, K, N, dp, bias,                     \
                      tdp::tile_shift(tile), splits, k_split, scale,        \
                      (cudaStream_t)stream};                                \
    return tdp::entry<which>(g, dtype, tile);                               \
  }

TDP_BWD_ENTRY(tdp_dgrad, tdp::DGRAD)
TDP_BWD_ENTRY(tdp_wgrad, tdp::WGRAD)
