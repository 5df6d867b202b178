// Compact RDP matmuls for Hopper (sm_90a): the up/gate projection over kept
// weight columns and the down projection over kept weight rows.
//
// Replace the TPU kernels rdp_matmul_cols and rdp_matmul_rows
// (src/repro/kernels/rdp_matmul.py).  On the serving path M is a decode
// bucket width (1..16) or a prefill chunk, so both products read far more
// weight bytes than they do arithmetic: they are bound by the kept weight
// bytes, K * N / dp elements, over the card's memory rate.  Both read only
// kept blocks (the paper's Fig. 3 "never fetch dropped blocks") and map
// compact indices to source indices themselves (block widths such as 70 are
// neither aligned nor powers of two).  Two shapes of kernel:
//
//  * bm == 0, M <= 16 (decode): skinny_kernel (skinny.cuh) streams weight
//    rows with V-element loads per lane and reduces 8 warps in shared
//    memory;
//  * bm == 64, M > 16 (prefill): a shared-memory tiled product
//    (tile_gemm.cuh).
//
// Either may split the contraction across CTAs (f32 partials, then a
// deterministic second pass), so a small output still fills the card.
#include "skinny.cuh"
#include "tile_gemm.cuh"

namespace rdp {

struct Args {
  const void* a;
  const void* w;
  void* out;
  void* ws;
  int M, K, N, dp, bias, block, splits, k_split;
  float scale;
  cudaStream_t stream;
};

// C[M, N/dp] = A[M, K] @ W[:, kept columns] (* scale)
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
cols_kernel(const T* a, const T* w, T* out, float* ws, int M, int K, int N,
            int dp, int bias, int block, int k_split, float scale) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int nb = N / block, Nc = N / dp;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k0 = s * k_split, k1 = min(K, k0 + k_split);
  float acc[BM / 16][4] = {};
  tile_product<BM>(DenseA<T>{a, M, K},
                   KeptColsB<T>{w, K, N, Nc, block, dp, bias, nb}, m0, n0,
                   k0, k1, As, Bs, acc);
  store_tile<T, BM>(acc, out, ws, s, gridDim.z, M, Nc, m0, n0, scale);
}

// C[M, N] = Ac[M, K/dp] @ W[kept rows, :] (* scale)
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* ac, const T* w, T* out, float* ws, int M, int K, int N,
            int dp, int bias, int block, int k_split, float scale) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int nb = K / block, Kc = K / dp;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k0 = s * k_split, k1 = min(Kc, k0 + k_split);
  float acc[BM / 16][4] = {};
  tile_product<BM>(DenseA<T>{ac, M, Kc},
                   KeptRowsB<T>{w, Kc, N, block, dp, bias, nb}, m0, n0, k0,
                   k1, As, Bs, acc);
  store_tile<T, BM>(acc, out, ws, s, gridDim.z, M, N, m0, n0, scale);
}

template <typename T>
cudaError_t finish(const Args& g, int n_out) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_reduce<T>((const float*)g.ws, (T*)g.out,
                          (int64_t)g.M * n_out, g.splits, g.scale, g.stream);
}

template <typename T, int BM, bool COLS>
cudaError_t launch_tiled(const Args& g) {
  const int n_out = COLS ? g.N / g.dp : g.N;
  dim3 grid((n_out + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  auto kern = COLS ? cols_kernel<T, BM> : rows_kernel<T, BM>;
  kern<<<grid, kThreads, 0, g.stream>>>(
      (const T*)g.a, (const T*)g.w, (T*)g.out, (float*)g.ws, g.M, g.K, g.N,
      g.dp, g.bias, g.block, g.k_split, g.scale);
  return finish<T>(g, n_out);
}

template <typename T, int V, int MT, bool COLS>
cudaError_t launch_skinny(const Args& g) {
  const int n_out = COLS ? g.N / g.dp : g.N;
  dim3 grid((n_out + 32 * V - 1) / (32 * V), g.splits);
  skinny_kernel<T, V, MT, COLS>
      <<<grid, kThreads, skinny_smem(MT, V, g.k_split), g.stream>>>(
          (const T*)g.a, (const T*)g.w, (T*)g.out, (float*)g.ws, g.M, g.K,
          g.N, g.dp, g.bias, g.block, g.k_split, g.scale);
  return finish<T>(g, n_out);
}

template <typename T, int V, bool COLS>
cudaError_t skinny_rows_dispatch(const Args& g) {
  switch (skinny_rows(g.M)) {
    case 1: return launch_skinny<T, V, 1, COLS>(g);
    case 2: return launch_skinny<T, V, 2, COLS>(g);
    case 4: return launch_skinny<T, V, 4, COLS>(g);
    case 8: return launch_skinny<T, V, 8, COLS>(g);
    default: return launch_skinny<T, V, 16, COLS>(g);
  }
}

template <typename T, bool COLS>
cudaError_t dispatch_t(const Args& g, int bm, int vec) {
  if (bm == 64) return launch_tiled<T, 64, COLS>(g);
  if (vec == 2) return skinny_rows_dispatch<T, 2, COLS>(g);
  return skinny_rows_dispatch<T, 1, COLS>(g);
}

template <bool COLS>
cudaError_t dispatch(const Args& g, int dtype, int bm, int vec) {
  const int dim = COLS ? g.N : g.K;        // the dimension the pattern drops
  const int kc = COLS ? g.K : g.K / g.dp;  // contraction length
  const int n_out = COLS ? g.N / g.dp : g.N;
  if (g.M < 1 || g.dp < 1 || g.block < 1 || dim % g.block != 0 ||
      (dim / g.block) % g.dp != 0 || g.bias < 0 || g.bias >= dim / g.block ||
      g.splits < 1 || g.k_split < 1 ||
      (int64_t)(g.splits - 1) * g.k_split >= kc ||
      (int64_t)g.splits * g.k_split < kc)
    return cudaErrorInvalidValue;
  if (bm == 0) {
    // skinny: M <= 16; V = 2 needs even column runs (and the caller's
    // pointer alignment); the activation rows must fit 48 KB of smem
    if (g.M > 16 || (vec != 1 && vec != 2) ||
        (vec == 2 && (n_out % 2 || (COLS && g.block % 2))) ||
        skinny_smem(skinny_rows(g.M), vec, g.k_split) > 48 * 1024)
      return cudaErrorInvalidValue;
  } else if (bm != 64) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch_t<float, COLS>(g, bm, vec);
  if (dtype == 1) return dispatch_t<__nv_bfloat16, COLS>(g, bm, vec);
  return cudaErrorInvalidValue;
}

}  // namespace rdp

extern "C" int rdp_matmul_cols(const void* a, const void* w, void* out,
                               void* ws, int dtype, int M, int K, int N,
                               int dp, int bias, int block, int bm, int vec,
                               int splits, int k_split, float scale,
                               void* stream) {
  const rdp::Args g{a, w, out, ws, M, K, N, dp, bias, block, splits,
                    k_split, scale, (cudaStream_t)stream};
  return (int)rdp::dispatch<true>(g, dtype, bm, vec);
}

extern "C" int rdp_matmul_rows(const void* a, const void* w, void* out,
                               void* ws, int dtype, int M, int K, int N,
                               int dp, int bias, int block, int bm, int vec,
                               int splits, int k_split, float scale,
                               void* stream) {
  const rdp::Args g{a, w, out, ws, M, K, N, dp, bias, block, splits,
                    k_split, scale, (cudaStream_t)stream};
  return (int)rdp::dispatch<false>(g, dtype, bm, vec);
}
