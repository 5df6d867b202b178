// Shared pieces of the compact RDP kernels: the kept-unit index map, operand
// loaders, a shared-memory tiled f32-accumulating product, the epilogue and
// the split-K reduction.
//
// Everything here is plain CUDA C++ (FMA on CUDA cores, f32 accumulation) for
// sm_90a.  Operands are f32 or bf16, row-major and contiguous.  The pattern
// bias is always a runtime int, never a template parameter, so one compiled
// kernel serves every bias of every period.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdp {

constexpr int kThreads = 256;  // 16 x 16 threads, each owning TM x 4 outputs
constexpr int BN = 64;         // output columns per tile
constexpr int BK = 32;         // contraction depth per shared-memory stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Source index of compact unit c: kept block j = c / block is source block
// (bias + j*dp) mod nb.  Block widths need not be powers of two (qwen2-1.5b
// has 8960 / 128 = 70), so the map is computed per element.
__device__ __forceinline__ int64_t kept_src(int c, int block, int dp,
                                            int bias, int nb) {
  const int j = c / block;
  return (int64_t)((bias + j * dp) % nb) * block + (c % block);
}

// Activation operand: row-major [rows, cols], zero outside.
template <typename T> struct DenseA {
  const T* p;
  int rows, cols;
  __device__ float operator()(int r, int k) const {
    return (r < rows && k < cols) ? to_f32(p[(int64_t)r * cols + k]) : 0.f;
  }
};

// Weight W [K, N] read at its kept columns: compact column n < N/dp.
template <typename T> struct KeptColsB {
  const T* w;
  int K, N, Nc, block, dp, bias, nb;
  __device__ float operator()(int k, int n) const {
    if (k >= K || n >= Nc) return 0.f;
    return to_f32(w[(int64_t)k * N + kept_src(n, block, dp, bias, nb)]);
  }
};

// Weight W [K, N] read at its kept rows: compact row k < K/dp.
template <typename T> struct KeptRowsB {
  const T* w;
  int Kc, N, block, dp, bias, nb;
  __device__ float operator()(int k, int n) const {
    if (k >= Kc || n >= N) return 0.f;
    return to_f32(w[kept_src(k, block, dp, bias, nb) * N + n]);
  }
};

// acc += A[m0:m0+BM, k0:k1] @ B[k0:k1, n0:n0+BN] for this thread's TM x 4
// outputs (rows ty*TM.., columns tx*4..).  The next stage's operands are
// fetched into registers while the current stage is multiplied.  Ends with a
// barrier, so the caller may reuse As/Bs.
template <int BM, class LA, class LB>
__device__ void tile_product(const LA& la, const LB& lb, int m0, int n0,
                             int k0, int k1, float (*As)[BM],
                             float (*Bs)[BN], float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  constexpr int A_PER = BM * BK / kThreads;
  constexpr int B_PER = BK * BN / kThreads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float ra[A_PER], rb[B_PER];

  auto fetch = [&](int kb) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads, m = e / BK, k = e % BK;
      ra[i] = (kb + k < k1) ? la(m0 + m, kb + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads, k = e / BN, n = e % BN;
      rb[i] = (kb + k < k1) ? lb(kb + k, n0 + n) : 0.f;
    }
  };

  if (k0 < k1) fetch(k0);
  for (int kb = k0; kb < k1; kb += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = rb[i];
    }
    __syncthreads();
    if (kb + BK < k1) fetch(kb + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// Epilogue: one split writes its tile straight to `out` (scaled, cast);
// several splits write f32 partials to ws[split] for `reduce_splits`.
template <typename T, int BM>
__device__ void store_tile(float (&acc)[BM / 16][4], T* out,
                           float* ws, int split, int splits, int M, int N,
                           int m0, int n0, float scale) {
  constexpr int TM = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const int64_t o = (int64_t)m * N + n;
      if (splits == 1)
        out[o] = from_f32<T>(acc[i][j] * scale);
      else
        ws[(int64_t)split * M * N + o] = acc[i][j];
    }
  }
}

// out[i] = cast(scale * sum_s ws[s, i]) — the second pass of a split
// contraction.  Summation order is fixed, so results are deterministic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* ws, T* out, int64_t n, int splits, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = from_f32<T>(s * scale);
  }
}

template <typename T>
inline cudaError_t launch_reduce(const float* ws, T* out, int64_t n,
                                 int splits, float scale,
                                 cudaStream_t stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1024 ? want : 1024);
  reduce_splits<T><<<blocks, kThreads, 0, stream>>>(ws, out, n, splits,
                                                    scale);
  return cudaGetLastError();
}

}  // namespace rdp
