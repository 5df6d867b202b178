// Backward products of the compact RDP matmuls for Hopper (sm_90a): for
// each forward kernel of rdp_matmul.cu, its activation gradient (dgrad) and
// its compact weight gradient (wgrad).
//
// Replace the TPU kernels rdp_cols_dgrad, rdp_cols_wgrad, rdp_rows_dgrad and
// rdp_rows_wgrad (src/repro/kernels/rdp_matmul_bwd.py).  With M the tokens
// of a training step:
//
//   cols_dgrad  dA[M, K]    = dC[M, N/dp] @ W[:, kept]^T   (x scale)
//   cols_wgrad  dWc[K, N/dp] = A^T @ dC                    (x scale)
//   rows_dgrad  dAc[M, K/dp] = dC[M, N] @ W[kept rows, :]^T (x scale)
//   rows_wgrad  dWc[K/dp, N] = Ac^T @ dC                   (x scale)
//
// At training sizes (M ~ 2048) all four do ~2 * M * d_model * d_ff / dp
// operations on a few MB of operands, so they are bound by operations, not
// bytes.  The dgrads read only kept blocks of W, the wgrads never read W at
// all and write only the kept blocks' gradients (the caller places them into
// a zeroed full dW: dropped blocks get exactly zero).  Compact indices map to
// source indices per element (kept_src_fast), so ragged block widths such
// as 70 need no alignment.
//
// The Pallas kernels carry an f32 scratch across a sequential contraction
// grid axis; here one CTA loops over its contraction range in shared-memory
// stages (tile_product), and when the output tiles alone would not fill the
// card the contraction is split across CTAs into f32 partials that a second
// pass sums in a fixed order (deterministic, no atomics).  Operands stored
// transposed relative to the product (W's kept columns contracted along
// their rows, A^T and Ac^T in the wgrads) are fetched along their contiguous
// axis and transposed in shared memory.  FMA on CUDA cores, f32
// accumulation, one cast at the end.
#include "tile_gemm.cuh"

namespace rdp {

// Row-major [kdim, ld] matrix read transposed: element (r, k) = p[k][r].
// For the wgrads, r is an output row (a column of A) and k a token.
template <typename T> struct TransA {
  const T* p;
  int ld, kdim;
  __device__ float operator()(int r, int k) const {
    return (r < ld && k < kdim) ? to_f32(p[(int64_t)k * ld + r]) : 0.f;
  }
};

// Row-major [K, N] matrix as the B operand, element (k, n) = p[k][n].
template <typename T> struct DenseB {
  const T* p;
  int K, N;
  __device__ float operator()(int k, int n) const {
    return (k < K && n < N) ? to_f32(p[(int64_t)k * N + n]) : 0.f;
  }
};

// W [K, N] at its kept columns, transposed: element (c, n) = W[n, src(c)]
// for compact column c < N/dp and output column n < K.
template <typename T> struct KeptColsT {
  const T* w;
  int K, N, Nc, block, dp, bias, nb;
  float inv = 1.f / block;
  __device__ float operator()(int c, int n) const {
    if (c >= Nc || n >= K) return 0.f;
    return to_f32(
        w[(int64_t)n * N + kept_src_fast(c, inv, block, dp, bias, nb)]);
  }
};

// W [K, N] at its kept rows, transposed: element (k, c) = W[src(c), k] for
// contraction index k < N and compact row c < K/dp.
template <typename T> struct KeptRowsT {
  const T* w;
  int Kc, N, block, dp, bias, nb;
  float inv = 1.f / block;
  __device__ float operator()(int k, int c) const {
    if (k >= N || c >= Kc) return 0.f;
    return to_f32(w[kept_src_fast(c, inv, block, dp, bias, nb) * N + k]);
  }
};

struct Args {
  const void* x;   // dC (dgrads) or the forward activation (wgrads)
  const void* y;   // W (dgrads) or dC (wgrads)
  void* out;
  void* ws;
  int M, K, N, dp, bias, block, splits, k_split;
  float scale;
  cudaStream_t stream;
};

enum Which { COLS_DGRAD = 0, COLS_WGRAD = 1, ROWS_DGRAD = 2, ROWS_WGRAD = 3 };

// Output [rows, cols] and contraction length of each product.  K, N are the
// forward weight's shape; M the tokens.
__host__ __device__ inline void dims(int which, int M, int K, int N, int dp,
                                     int* rows, int* cols, int* kc) {
  switch (which) {
    case COLS_DGRAD: *rows = M; *cols = K; *kc = N / dp; break;
    case COLS_WGRAD: *rows = K; *cols = N / dp; *kc = M; break;
    case ROWS_DGRAD: *rows = M; *cols = K / dp; *kc = N; break;
    default: *rows = K / dp; *cols = N; *kc = M; break;
  }
}

template <typename T, int BM, int WHICH>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* x, const T* y, T* out, float* ws, int M, int K, int N,
           int dp, int bias, int block, int k_split, float scale) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  int rows, cols, kc;
  dims(WHICH, M, K, N, dp, &rows, &cols, &kc);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int k0 = s * k_split, k1 = min(kc, k0 + k_split);
  float acc[BM / 16][4] = {};
  if constexpr (WHICH == COLS_DGRAD) {
    // x = dC [M, N/dp]; y = W [K, N]
    const int nb = N / block;
    tile_product<BM, true, true>(
        DenseA<T>{x, M, kc},
        KeptColsT<T>{y, K, N, kc, block, dp, bias, nb}, m0, n0, k0, k1, As,
        Bs, acc);
  } else if constexpr (WHICH == COLS_WGRAD) {
    // x = A [M, K]; y = dC [M, N/dp]
    tile_product<BM, false, false>(TransA<T>{x, K, M},
                                   DenseB<T>{y, M, cols}, m0, n0, k0, k1, As,
                                   Bs, acc);
  } else if constexpr (WHICH == ROWS_DGRAD) {
    // x = dC [M, N]; y = W [K, N]
    const int nb = K / block;
    tile_product<BM, true, true>(
        DenseA<T>{x, M, N}, KeptRowsT<T>{y, cols, N, block, dp, bias, nb},
        m0, n0, k0, k1, As, Bs, acc);
  } else {
    // x = Ac [M, K/dp]; y = dC [M, N]
    tile_product<BM, false, false>(TransA<T>{x, rows, M},
                                   DenseB<T>{y, M, N}, m0, n0, k0, k1, As,
                                   Bs, acc);
  }
  store_tile<T, BM>(acc, out, ws, s, gridDim.z, rows, cols, m0, n0, scale);
}

template <typename T, int WHICH>
cudaError_t launch(const Args& g) {
  constexpr int BM = 64;
  int rows, cols, kc;
  dims(WHICH, g.M, g.K, g.N, g.dp, &rows, &cols, &kc);
  dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM, g.splits);
  bwd_kernel<T, BM, WHICH><<<grid, kThreads, 0, g.stream>>>(
      (const T*)g.x, (const T*)g.y, (T*)g.out, (float*)g.ws, g.M, g.K, g.N,
      g.dp, g.bias, g.block, g.k_split, g.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_reduce<T>((const float*)g.ws, (T*)g.out,
                          (int64_t)rows * cols, g.splits, g.scale, g.stream);
}

template <int WHICH>
cudaError_t dispatch(const Args& g, int dtype) {
  // the dimension the pattern drops: W's columns (cols) or rows (rows)
  const bool cols_pattern = WHICH == COLS_DGRAD || WHICH == COLS_WGRAD;
  const int dim = cols_pattern ? g.N : g.K;
  int rows, cols, kc;
  if (g.M < 1 || g.K < 1 || g.N < 1 || g.dp < 1 || g.block < 1 ||
      dim % g.block != 0 || (dim / g.block) % g.dp != 0 || g.bias < 0 ||
      g.bias >= dim / g.block)
    return cudaErrorInvalidValue;
  dims(WHICH, g.M, g.K, g.N, g.dp, &rows, &cols, &kc);
  if (g.splits < 1 || g.k_split < 1 ||
      (int64_t)(g.splits - 1) * g.k_split >= kc ||
      (int64_t)g.splits * g.k_split < kc ||
      (g.splits > 1 && g.ws == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, WHICH>(g);
  if (dtype == 1) return launch<__nv_bfloat16, WHICH>(g);
  return cudaErrorInvalidValue;
}

}  // namespace rdp

// Every entry point: x, y, out, ws (f32 partials, splits x rows x cols, or
// null when splits == 1), dtype (0 f32, 1 bf16), M tokens, K x N the forward
// weight's shape, dp, bias (ignored by the wgrads), block, splits, k_split,
// scale, stream.  Returns cudaGetLastError() of the launches.
#define RDP_BWD_ENTRY(name, which)                                          \
  extern "C" int name(const void* x, const void* y, void* out, void* ws,     \
                      int dtype, int M, int K, int N, int dp, int bias,     \
                      int block, int splits, int k_split, float scale,      \
                      void* stream) {                                       \
    const rdp::Args g{x, y, out, ws, M, K, N, dp, bias, block, splits,      \
                      k_split, scale, (cudaStream_t)stream};                \
    return (int)rdp::dispatch<which>(g, dtype);                             \
  }

RDP_BWD_ENTRY(rdp_cols_dgrad, rdp::COLS_DGRAD)
RDP_BWD_ENTRY(rdp_cols_wgrad, rdp::COLS_WGRAD)
RDP_BWD_ENTRY(rdp_rows_dgrad, rdp::ROWS_DGRAD)
RDP_BWD_ENTRY(rdp_rows_wgrad, rdp::ROWS_WGRAD)
