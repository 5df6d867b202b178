// Fused compact FFN for Hopper (sm_90a):
//   y = (act(x @ Wu[:, kept]) [* (x @ Wg[:, kept])] * dp).astype(x) @ Wd[kept, :]
// with the hidden activation kept in shared memory, never in device memory.
//
// Replaces the TPU kernel fused_ffn_fwd (src/repro/kernels/fused_ffn.py, body
// _fused_kernel).  Like the two-kernel path it is bound by the kept weight
// bytes (3 * d_model * d_ff / dp elements) at the serving path's small M.
// The TPU kernel keeps a [bm, d_model] f32 accumulator resident while it
// walks the kept blocks in order; CUDA blocks run in no order and one SM
// cannot hold that accumulator at d_model 1536, so the reduction over kept
// hidden units is split instead: each CTA owns one chunk of BN kept hidden
// units of one row tile, computes its hidden chunk once (every kept weight
// is read exactly once per row tile), multiplies it into every output
// column, and writes an f32 partial; a second pass sums the partials in a
// fixed order and casts.  The cast of h * dp to x's type before the down
// product is kept, so bf16 numerics match the two-kernel path.
#include <math.h>

#include "skinny.cuh"
#include "tile_gemm.cuh"

namespace rdp {

// A operand read from the shared-memory hidden chunk Hs[k - h0][r - m0].
template <int BM> struct SmemA {
  float (*hs)[BM];
  int m0, h0;
  __device__ float operator()(int r, int k) const {
    return hs[k - h0][r - m0];
  }
};

__device__ __forceinline__ float activate(float u, int act) {
  if (act == 1) return u > 0.f ? u : 0.f;  // relu
  return u / (1.f + expf(-u));             // silu
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* x, const T* wu, const T* wg, const T* wd, float* ws,
             int M, int K, int N, int O, int dp, int bias, int block,
             int act) {
  constexpr int TM = BM / 16;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float Hs[BN][BM];
  const int nb = N / block, Nc = N / dp;
  const int c = blockIdx.x, h0 = c * BN, m0 = blockIdx.y * BM;
  const int h1 = min(Nc, h0 + BN);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // phase 1: this CTA's chunk of the compact hidden activation
  float u[TM][4] = {}, g[TM][4] = {};
  const DenseA<T> xa{x, M, K};
  tile_product<BM>(xa, KeptColsB<T>{wu, K, N, Nc, block, dp, bias, nb}, m0,
                   h0, 0, K, As, Bs, u);
  if (wg != nullptr)
    tile_product<BM>(xa, KeptColsB<T>{wg, K, N, Nc, block, dp, bias, nb},
                     m0, h0, 0, K, As, Bs, g);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float h = activate(u[i][j], act);
      if (wg != nullptr) h *= g[i][j];
      Hs[tx * 4 + j][ty * TM + i] = to_f32(from_f32<T>(h * (float)dp));
    }
  __syncthreads();

  // phase 2: partial y over this chunk, for every output column tile
  const SmemA<BM> ha{Hs, m0, h0};
  const KeptRowsB<T> wdb{wd, Nc, O, block, dp, bias, nb};
  for (int o0 = 0; o0 < O; o0 += BN) {
    float acc[TM][4] = {};
    tile_product<BM>(ha, wdb, m0, o0, h0, h1, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + tx * 4 + j;
        if (o < O) ws[((int64_t)c * M + m) * O + o] = acc[i][j];
      }
    }
  }
}

// M <= 16: one CTA per chunk of 32 * V kept hidden units, all rows.
template <typename T, int V, int MT>
__global__ void __launch_bounds__(kThreads)
fused_skinny(const T* x, const T* wu, const T* wg, const T* wd, float* ws,
             int M, int K, int N, int O, int dp, int bias, int block,
             int act) {
  constexpr int CW = 32 * V;                     // chunk width
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int nb = N / block, Nc = N / dp;
  const int c = blockIdx.x, h0 = c * CW;
  const int hr = min(CW, Nc - h0);               // valid hidden units
  int64_t* srow = reinterpret_cast<int64_t*>(fsmem);  // [CW] Wd row offsets
  float* xs = reinterpret_cast<float*>(srow + CW);    // [MT][K]
  float* red = xs + MT * K;                      // [2][kWarps][MT][CW]
  float* hs = red + 2 * kWarps * MT * CW;        // [MT][CW]
  const int n = h0 + (threadIdx.x % 32) * V;     // lane's first hidden unit

  stage_rows<T, MT>(x, K, M, 0, K, K, xs);
  for (int r = threadIdx.x; r < CW; r += kThreads)
    srow[r] = r < hr ? kept_src(h0 + r, block, dp, bias, nb) * O : 0;
  __syncthreads();

  // phase 1: u = x @ Wu[:, chunk] and g = x @ Wg[:, chunk], streamed
  // together; then h = act(u) [* g], scaled by dp and cast to T
  float* red_g = red + kWarps * MT * CW;
  if (wg != nullptr) {
    float acc[2][MT][V] = {};
    if (n < Nc) {
      const int64_t src = kept_src(n, block, dp, bias, nb);
      const KeptColRow<T> rows[2] = {{wu + src, N}, {wg + src, N}};
      stream_rows<T, V, MT, 2>(rows, 0, K, xs, K, acc);
    }
    stash<V, MT>(acc[0], red);
    stash<V, MT>(acc[1], red_g);
  } else {
    float acc[1][MT][V] = {};
    if (n < Nc) {
      const KeptColRow<T> rows[1] = {
          {wu + kept_src(n, block, dp, bias, nb), N}};
      stream_rows<T, V, MT, 1>(rows, 0, K, xs, K, acc);
    }
    stash<V, MT>(acc[0], red);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MT * CW; e += kThreads) {
    const int m = e / CW, j = e % CW;
    float h = activate(warp_sum(red, MT, V, m, j), act);
    if (wg != nullptr) h *= warp_sum(red_g, MT, V, m, j);
    hs[e] = (m < M && j < hr) ? to_f32(from_f32<T>(h * (float)dp)) : 0.f;
  }
  __syncthreads();

  // phase 2: partial y[:, o] = h[:, chunk] @ Wd[kept rows of chunk, o]
  for (int o = threadIdx.x * V; o < O; o += kThreads * V) {
    float y[MT][V] = {};
    int r = 0;
    for (; r + kUnroll - 1 < hr; r += kUnroll) {
      float wv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_vec<T, V>(wd + srow[r + u] + o, wv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int v = 0; v < V; ++v)
            y[m][v] = fmaf(hs[m * CW + r + u], wv[u][v], y[m][v]);
    }
    for (; r < hr; ++r) {
      float wv[V];
      load_vec<T, V>(wd + srow[r] + o, wv);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v)
          y[m][v] = fmaf(hs[m * CW + r], wv[v], y[m][v]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
#pragma unroll
      for (int v = 0; v < V; ++v)
        ws[((int64_t)c * M + m) * O + o + v] = y[m][v];
    }
  }
}

constexpr int kMaxSkinnySmem = 227 * 1024;

// Dynamic shared memory of fused_skinny (bytes).
inline size_t fused_skinny_smem(int mt, int vec, int K) {
  const size_t cw = 32 * vec;
  return sizeof(float) * ((size_t)mt * K + 2 * (size_t)kWarps * mt * cw +
                          (size_t)mt * cw) + sizeof(int64_t) * cw;
}

struct FusedArgs {
  const void* x;
  const void* wu;
  const void* wg;
  const void* wd;
  void* out;
  void* ws;
  int M, K, N, O, dp, bias, block, act;
  cudaStream_t stream;
};

template <typename T>
cudaError_t reduce_chunks(const FusedArgs& g, int chunks) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<T>((const float*)g.ws, (T*)g.out, (int64_t)g.M * g.O,
                          chunks, 1.f, g.stream);
}

template <typename T, int BM>
cudaError_t launch_tiled(const FusedArgs& g) {
  const int chunks = (g.N / g.dp + BN - 1) / BN;
  dim3 grid(chunks, (g.M + BM - 1) / BM);
  fused_kernel<T, BM><<<grid, kThreads, 0, g.stream>>>(
      (const T*)g.x, (const T*)g.wu, (const T*)g.wg, (const T*)g.wd,
      (float*)g.ws, g.M, g.K, g.N, g.O, g.dp, g.bias, g.block, g.act);
  return reduce_chunks<T>(g, chunks);
}

template <typename T, int V, int MT>
cudaError_t launch_skinny(const FusedArgs& g) {
  const int chunks = (g.N / g.dp + 32 * V - 1) / (32 * V);
  const size_t smem = fused_skinny_smem(MT, V, g.K);
  static bool configured = false;  // once per instantiation, before capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_skinny<T, V, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSkinnySmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  fused_skinny<T, V, MT><<<chunks, kThreads, smem, g.stream>>>(
      (const T*)g.x, (const T*)g.wu, (const T*)g.wg, (const T*)g.wd,
      (float*)g.ws, g.M, g.K, g.N, g.O, g.dp, g.bias, g.block, g.act);
  return reduce_chunks<T>(g, chunks);
}

template <typename T, int V>
cudaError_t skinny_rows_dispatch(const FusedArgs& g) {
  switch (skinny_rows(g.M)) {
    case 1: return launch_skinny<T, V, 1>(g);
    case 2: return launch_skinny<T, V, 2>(g);
    case 4: return launch_skinny<T, V, 4>(g);
    case 8: return launch_skinny<T, V, 8>(g);
    default: return launch_skinny<T, V, 16>(g);
  }
}

template <typename T>
cudaError_t dispatch_t(const FusedArgs& g, int bm, int vec) {
  if (bm == 16) return launch_tiled<T, 16>(g);
  if (bm == 64) return launch_tiled<T, 64>(g);
  if (vec == 2) return skinny_rows_dispatch<T, 2>(g);
  return skinny_rows_dispatch<T, 1>(g);
}

}  // namespace rdp

// ws must hold chunks * M * O floats: chunks = ceil((N / dp) / W) with
// W = 32 * vec when bm == 0, else 64.
extern "C" int fused_ffn_fwd(const void* x, const void* wu, const void* wg,
                             const void* wd, void* out, void* ws, int dtype,
                             int M, int K, int N, int O, int dp, int bias,
                             int block, int bm, int vec, int act,
                             void* stream) {
  const rdp::FusedArgs g{x, wu, wg, wd, out, ws, M, K, N, O, dp, bias,
                         block, act, (cudaStream_t)stream};
  if (M < 1 || dp < 1 || block < 1 || N % block != 0 ||
      (N / block) % dp != 0 || bias < 0 || bias >= N / block ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  if (bm == 0) {
    if (M > 16 || (vec != 1 && vec != 2) ||
        (vec == 2 && ((N / dp) % 2 || block % 2 || O % 2)) ||
        rdp::fused_skinny_smem(rdp::skinny_rows(M), vec, K) >
            (size_t)rdp::kMaxSkinnySmem)
      return (int)cudaErrorInvalidValue;
  } else if (bm != 16 && bm != 64) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return (int)rdp::dispatch_t<float>(g, bm, vec);
  if (dtype == 1) return (int)rdp::dispatch_t<__nv_bfloat16>(g, bm, vec);
  return (int)cudaErrorInvalidValue;
}
