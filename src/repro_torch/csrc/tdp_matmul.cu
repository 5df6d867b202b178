// TDP masked matmul for Hopper (sm_90a): C[M, N] = (A @ (W o mask)) * scale,
// where the mask keeps weight tile (i, j) iff (i + j - bias) % dp == 0.
//
// Replaces the TPU kernel tdp_matmul (src/repro/kernels/tdp_matmul.py:28).
// In the model W is the FFN up projection [d_model, d_ff].  For output
// tile-column j only the tr/dp row-tiles (bias - j) mod dp + s*dp are kept,
// so each CTA contracts over a compact K/dp: the dropped tiles of W and the
// matching columns of A are never read (the paper's Fig. 3(b)).  On the
// serving path M is a decode width or a prefill chunk, and the product is
// bound by the kept weight bytes, K * N / dp elements; at a training step
// (M ~ 2048) it is bound by operations, 2 * M * K * N / dp.
//
// The Pallas kernel carries an f32 VMEM scratch across a sequential grid
// axis over the kept tiles; here one CTA loops over its compact contraction
// in shared-memory stages (rdp::tile_product, FMA on CUDA cores, f32
// accumulation), and when the output tiles alone would not fill the card the
// contraction is split across CTAs into f32 partials that a second pass sums
// in a fixed order.  The scale is applied in f32 before the one cast, as the
// Pallas kernel does.  A CTA's 64 output columns lie in one tile-column (the
// tile is 64 or 128), so the CTA computes its kept residue class once.
#include "tdp_tiles.cuh"

namespace tdp {

struct Args {
  const void* a;
  const void* w;
  void* out;
  void* ws;
  int M, K, N, dp, bias, tshift, bm, splits, k_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* a, const T* w, T* out, float* ws, int M, int K, int N,
           int dp, int bias, int tshift, int k_split, float scale) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int kc = K / dp;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k0 = s * k_split, k1 = min(kc, k0 + k_split);
  const int base = kept_base(bias, n0 >> tshift, dp);
  float acc[BM / 16][4] = {};
  rdp::tile_product<BM>(KeptCols<T>{a, M, K, kc, base, dp, tshift},
                        KeptRows<T>{w, N, kc, base, dp, tshift}, m0, n0, k0,
                        k1, As, Bs, acc);
  rdp::store_tile<T, BM>(acc, out, ws, s, gridDim.z, M, N, m0, n0, scale);
}

template <typename T, int BM>
cudaError_t launch(const Args& g) {
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  fwd_kernel<T, BM><<<grid, kThreads, 0, g.stream>>>(
      (const T*)g.a, (const T*)g.w, (T*)g.out, (float*)g.ws, g.M, g.K, g.N,
      g.dp, g.bias, g.tshift, g.k_split, g.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return rdp::launch_reduce<T>((const float*)g.ws, (T*)g.out,
                               (int64_t)g.M * g.N, g.splits, g.scale,
                               g.stream);
}

template <typename T>
cudaError_t dispatch_bm(const Args& g) {
  if (g.bm == 16) return launch<T, 16>(g);
  if (g.bm == 64) return launch<T, 64>(g);
  return cudaErrorInvalidValue;
}

}  // namespace tdp

// a [M, K], w [K, N], out [M, N], ws (f32 partials, splits x M x N, or null
// when splits == 1), dtype (0 f32, 1 bf16), M, K, N, dp, bias in [0, dp),
// tile (64 or 128), bm (16 or 64 output rows per CTA), splits, k_split (a
// multiple of 32), scale, stream.  Returns cudaGetLastError() of the
// launches.
extern "C" int tdp_matmul(const void* a, const void* w, void* out, void* ws,
                          int dtype, int M, int K, int N, int dp, int bias,
                          int tile, int bm, int splits, int k_split,
                          float scale, void* stream) {
  const int tshift = tdp::tile_shift(tile);
  if (tshift < 0 || M < 1 || K < 1 || N < 1 || dp < 1 || K % tile ||
      N % tile || (K / tile) % dp || bias < 0 || bias >= dp)
    return (int)cudaErrorInvalidValue;
  const int kc = K / dp;
  if (splits < 1 || k_split < 1 || k_split % tdp::BK ||
      (int64_t)(splits - 1) * k_split >= kc ||
      (int64_t)splits * k_split < kc || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const tdp::Args g{a, w, out, ws, M, K, N, dp, bias, tshift, bm, splits,
                    k_split, scale, (cudaStream_t)stream};
  if (dtype == 0) return (int)tdp::dispatch_bm<float>(g);
  if (dtype == 1) return (int)tdp::dispatch_bm<__nv_bfloat16>(g);
  return (int)cudaErrorInvalidValue;
}
