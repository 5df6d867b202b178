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

// kept_src for c < N/dp without integer division, for the tiled loaders,
// which map every weight element they load; inv = 1.f / block.
// (c + 0.5) / block lies at least 0.5 / block from an integer, and float
// rounding moves it by less than (c + 0.5) / block * 2^-22, so the
// truncated product is exact for c < 2^20.  bias < nb and j*dp <= nb - dp,
// so one conditional subtraction reduces mod nb.
__device__ __forceinline__ int64_t kept_src_fast(int c, float inv,
                                                 int block, int dp,
                                                 int bias, int nb) {
  const int j = __float2int_rz(((float)c + 0.5f) * inv);
  int s = bias + j * dp;
  if (s >= nb) s -= nb;
  return (int64_t)s * block + (c - j * block);
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
  float inv = 1.f / block;
  __device__ float operator()(int k, int n) const {
    if (k >= K || n >= Nc) return 0.f;
    return to_f32(
        w[(int64_t)k * N + kept_src_fast(n, inv, block, dp, bias, nb)]);
  }
};

// Weight W [K, N] read at its kept rows: compact row k < K/dp.
template <typename T> struct KeptRowsB {
  const T* w;
  int Kc, N, block, dp, bias, nb;
  float inv = 1.f / block;
  __device__ float operator()(int k, int n) const {
    if (k >= Kc || n >= N) return 0.f;
    return to_f32(w[kept_src_fast(k, inv, block, dp, bias, nb) * N + n]);
  }
};

// acc += A[m0:m0+BM, k0:k1] @ B[k0:k1, n0:n0+BN] for this thread's TM x 4
// outputs (rows ty*TM.., columns tx*4..).  The next stage's operands are
// fetched into registers while the current stage is multiplied.  Ends with a
// barrier, so the caller may reuse As/Bs.
//
// A_KFAST / B_KFAST say which index of each operand is contiguous in memory:
// the contraction index (true) or the tile's row / column index (false).
// Neighbouring threads fetch neighbouring addresses either way, and the
// tile is transposed on its way into shared memory.  The defaults are the
// forward products' layouts (row-major activation, weight read by columns).
// A transposed store puts a warp's 32 consecutive k of one row into one
// shared-memory column, all in one bank; the column index is XOR-swizzled
// with k (swz) so those stores hit 32 banks, and the reads apply the same
// swizzle.
template <int BM, bool A_KFAST = true, bool B_KFAST = false, class LA,
          class LB>
__device__ void tile_product(const LA& la, const LB& lb, int m0, int n0,
                             int k0, int k1, float (*As)[BM],
                             float (*Bs)[BN], float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  constexpr int A_PER = BM * BK / kThreads;
  constexpr int B_PER = BK * BN / kThreads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float ra[A_PER], rb[B_PER];
  // shared-memory column of (k, column c) in a tile `width` wide
  auto swz = [](bool on, int width, int k, int c) {
    return on ? c ^ (k & ((width < 32 ? width : 32) - 1)) : c;
  };

  auto fetch = [&](int kb) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      const int m = A_KFAST ? e / BK : e % BM, k = A_KFAST ? e % BK : e / BM;
      ra[i] = (kb + k < k1) ? la(m0 + m, kb + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      const int k = B_KFAST ? e % BK : e / BN, n = B_KFAST ? e / BK : e % BN;
      rb[i] = (kb + k < k1) ? lb(kb + k, n0 + n) : 0.f;
    }
  };

  if (k0 < k1) fetch(k0);
  for (int kb = k0; kb < k1; kb += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * kThreads;
      if (A_KFAST) As[e % BK][swz(true, BM, e % BK, e / BK)] = ra[i];
      else As[e / BM][e % BM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * kThreads;
      if (B_KFAST) Bs[e % BK][swz(true, BN, e % BK, e / BK)] = rb[i];
      else Bs[e / BN][e % BN] = rb[i];
    }
    __syncthreads();
    if (kb + BK < k1) fetch(kb + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = As[k][swz(A_KFAST, BM, k, ty * TM + i)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = Bs[k][swz(B_KFAST, BN, k, tx * 4 + j)];
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
