// Decode-sized compact products (M <= 16 rows): GEMV-shaped kernels.
//
// At decode the activation has a handful of rows and the kept weights are
// the only real traffic, so these kernels are organised around streaming
// weight rows: the CTA's 8 warps take interleaved weight rows of its
// contraction range, each lane owns V adjacent output columns (one
// V-element load per row; V = 2 needs even, aligned column runs), the
// activation rows sit in shared memory (broadcast reads), each warp keeps
// four rows' loads in flight, and the 8 warps' partial sums are reduced in
// shared memory.  Eight rows of every weight stream are in flight per warp:
// at decode size the loads' latency, not the card's bandwidth, is what
// limits a CTA.  The activation rows and the per-warp partials need at most
// 48 KB of dynamic shared memory with the contraction range the host picks.
#pragma once

#include "tile_gemm.cuh"

namespace rdp {

constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;

// V consecutive elements starting at p (V-aligned) as floats.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[V]);
template <> __device__ __forceinline__ void load_vec<float, 1>(
    const float* p, float (&o)[1]) {
  o[0] = p[0];
}
template <> __device__ __forceinline__ void load_vec<float, 2>(
    const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
template <> __device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float (&o)[1]) {
  o[0] = __bfloat162float(p[0]);
}
template <> __device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, float (&o)[2]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x;
  o[1] = v.y;
}

// xs[m * kr + k] = A[m, k0 + k] for m < M, k0 + k < k1; zero elsewhere.
template <typename T, int MT>
__device__ void stage_rows(const T* a, int lda, int M, int k0, int k1,
                           int kr, float* xs) {
  for (int e = threadIdx.x; e < MT * kr; e += kThreads) {
    const int m = e / kr, k = e % kr;
    xs[e] = (m < M && k0 + k < k1) ? to_f32(a[(int64_t)m * lda + k0 + k])
                                   : 0.f;
  }
}

// For each of NS weight streams: acc[s][m][v] += sum over this warp's rows
// k (k0 + warp, + kWarps, ... < k1) of xs[m][k - k0] * row[s](k)[v], where
// row[s](k) points at the lane's V weights of row k.  The streams share the
// activation reads, and kUnroll rows of every stream are in flight at once.
template <typename T, int V, int MT, int NS, class RowPtr>
__device__ __forceinline__ void stream_rows(const RowPtr (&row)[NS], int k0,
                                            int k1, const float* xs, int kr,
                                            float (&acc)[NS][MT][V]) {
  const int warp = threadIdx.x / 32;
  int k = k0 + warp;
  for (; k + (kUnroll - 1) * kWarps < k1; k += kUnroll * kWarps) {
    float wv[kUnroll][NS][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        load_vec<T, V>(row[s](k + u * kWarps), wv[u][s]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m * kr + k + u * kWarps - k0];
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[s][m][v] = fmaf(xv, wv[u][s][v], acc[s][m][v]);
      }
  }
  for (; k < k1; k += kWarps) {
    float wv[NS][V];
#pragma unroll
    for (int s = 0; s < NS; ++s) load_vec<T, V>(row[s](k), wv[s]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv = xs[m * kr + k - k0];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[s][m][v] = fmaf(xv, wv[s][v], acc[s][m][v]);
    }
  }
}

// Writes this warp's acc into red[warp][m][lane*V + v] (red holds
// kWarps * MT * 32 * V floats); the caller syncs and sums over warps.
template <int V, int MT>
__device__ __forceinline__ void stash(float (&acc)[MT][V],
                                      float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[(warp * MT + m) * 32 * V + lane * V + v] = acc[m][v];
}

__device__ __forceinline__ float warp_sum(const float* red, int MT, int V,
                                          int m, int j) {
  float s = 0.f;
  for (int q = 0; q < kWarps; ++q) s += red[(q * MT + m) * 32 * V + j];
  return s;
}

// Column pointer of a kept column (cols product): row k, compact col c.
template <typename T> struct KeptColRow {
  const T* col;  // &W[0, src(c)]
  int N;
  __device__ const T* operator()(int k) const {
    return col + (int64_t)k * N;
  }
};

// Kept row of W (rows product): compact row k, columns from n.
template <typename T> struct KeptRowAt {
  const T* w;
  int N, n, block, dp, bias, nb;
  __device__ const T* operator()(int k) const {
    return w + kept_src(k, block, dp, bias, nb) * N + n;
  }
};

// C[M, n_out] = A[M, k0:k1] @ B[k0:k1, cols] (+ split partials): one CTA
// per (32*V output columns, contraction split).
template <typename T, int V, int MT, bool COLS>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const T* a, const T* w, T* out, float* ws, int M, int K,
              int N, int dp, int bias, int block, int k_split, float scale) {
  extern __shared__ float smem[];
  const int kc = COLS ? K : K / dp;              // contraction length
  const int n_out = COLS ? N / dp : N;
  const int nb = (COLS ? N : K) / block;
  const int s = blockIdx.y, k0 = s * k_split, k1 = min(kc, k0 + k_split);
  const int kr = k_split;
  float* xs = smem;                              // [MT][kr]
  float* red = smem + MT * kr;                   // [kWarps][MT][32*V]
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * 32 * V + lane * V;  // lane's first column

  stage_rows<T, MT>(a, kc, M, k0, k1, kr, xs);
  __syncthreads();
  float acc[1][MT][V] = {};
  if (n < n_out) {
    if constexpr (COLS) {
      const KeptColRow<T> row[1] = {
          {w + kept_src(n, block, dp, bias, nb), N}};
      stream_rows<T, V, MT, 1>(row, k0, k1, xs, kr, acc);
    } else {
      const KeptRowAt<T> row[1] = {{w, N, n, block, dp, bias, nb}};
      stream_rows<T, V, MT, 1>(row, k0, k1, xs, kr, acc);
    }
  }
  stash<V, MT>(acc[0], red);
  __syncthreads();
  for (int e = threadIdx.x; e < MT * 32 * V; e += kThreads) {
    const int m = e / (32 * V), j = e % (32 * V);
    const int col = blockIdx.x * 32 * V + j;
    if (m >= M || col >= n_out) continue;
    const float sum = warp_sum(red, MT, V, m, j);
    const int64_t o = (int64_t)m * n_out + col;
    if (gridDim.y == 1)
      out[o] = from_f32<T>(sum * scale);
    else
      ws[(int64_t)s * M * n_out + o] = sum;
  }
}

__host__ __device__ constexpr int skinny_rows(int m) {
  return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
}

// Dynamic shared memory of skinny_kernel (bytes).
inline size_t skinny_smem(int mt, int vec, int k_split) {
  return sizeof(float) * ((size_t)mt * k_split + (size_t)kWarps * mt * 32 * vec);
}

}  // namespace rdp
