// Fused LayerNorm + bias-free q/k/v projections for Hopper (sm_90a).
//
//   xn = LN(x) rounded to x's type;  q = xn Wq^T,  k = xn Wk^T,  v = xn Wv^T
//
// Replaces the TPU kernel `_ln_qkv_kernel` (emox/ops/ff.py), which holds a
// row block and the three weight matrices in VMEM and writes the three
// projections from one read of x, so the normalised tokens never reach
// device memory. Weights come in PyTorch's Linear layout [inner, C], one
// pointer each, as the TPU kernel takes three refs.
//
// What bounds it on the H100: at the UNet's level 0 under CFG (M 32768, C
// 320, 3 x 320 outputs) it does 2*M*C*3*inner = 20 GFLOP against 21 MB of x
// and 63 MB of q/k/v in bf16: device memory bounds it (25 us against 20 us
// of tensor-core work). At level 2 and mid (C 1280, M 2048 / 512) the rows
// are few: a grid over row tiles alone would give 8-32 blocks on 132 SMs,
// which is the mistake a whole-row accumulator made in ln_geglu_ff at C
// 1280. So the output columns go on the grid:
//   * grid (ceil(inner / 64), ceil(M / 64)): one block per 64 rows and 64
//     columns of each of q, k and v (the column tiles of a row tile are
//     neighbours in launch order, so their reads of x meet in L2);
//   * prologue: each block recomputes its 64 rows' LayerNorm statistics in
//     fp32 (two passes over the row, as ln_qkv_xla: the mean, then the mean
//     of squared deviations): one extra read of C per row and column tile,
//     from L2;
//   * loop over C in slices of 64: the x slice is normalised once, rounded
//     to x's type and stored in shared memory, the three weight slices [64
//     outputs, 64] beside it, and 8 warps run WMMA products (fp32
//     accumulation; 3xTF32 for float32) into three 64 x 64 tiles;
//   * epilogue: each tile is rounded to x's type and written.
// No TMA, no wgmma, no pipelining: those belong to the PR that makes it fast.
#include "common.cuh"

namespace emox {

constexpr int kQKVThreads = 256;  // 8 warps
constexpr int kQBM = 64;          // rows per tile
constexpr int kQBN = 64;          // columns of each of q, k, v per tile
constexpr int kQBK = 64;          // slice of C per stage

template <typename T>
struct QKVLayout {
  static constexpr int lda = kQBK + Pad<T>::value;  // normalised x slice [BM, BK] (T)
  static constexpr int ldb = kQBK + Pad<T>::value;  // three weight slices [BN, BK] (T)
  static constexpr int ldo = kQBN + 4;              // fp32 tile [BM, BN], aliases a and b
  static constexpr size_t b_off = align128(sizeof(T) * kQBM * lda);
  static constexpr size_t b_size = align128(sizeof(T) * kQBN * ldb);
  static constexpr size_t stats_off = b_off + 3 * b_size;
  static constexpr size_t bytes = align128(stats_off + sizeof(float) * 2 * kQBM);
  static_assert(sizeof(float) * kQBM * ldo <= stats_off, "the fp32 tile must fit in a and b");
};

template <typename T>
__global__ void __launch_bounds__(kQKVThreads)
    ln_qkv_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                  const T* __restrict__ ln_b, const T* __restrict__ wq,
                  const T* __restrict__ wk, const T* __restrict__ wv, T* __restrict__ q,
                  T* __restrict__ k, T* __restrict__ v, int m, int c, int inner, float eps) {
  using M = Mma<T>;
  using L = QKVLayout<T>;
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  float* mu = reinterpret_cast<float*>(smem + L::stats_off);
  float* rstd = mu + kQBM;
  float* tile = reinterpret_cast<float*>(smem);
  const T* w[3] = {wq, wk, wv};
  T* out[3] = {q, k, v};

  const int col0 = blockIdx.x * kQBN;
  const int row0 = blockIdx.y * kQBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- prologue: row statistics in fp32
  for (int r = warp; r < kQBM; r += kQKVThreads / 32) {
    const int row = row0 + r;
    float mean = 0.f;
    float rs = 0.f;
    if (row < m) {
      const T* xr = x + (size_t)row * c;
      float s = 0.f;
      for (int j = lane * V; j < c; j += 32 * V) {
        float e[V];
        Vec16<T>::load(xr + j, e);
#pragma unroll
        for (int i = 0; i < V; ++i) s += e[i];
      }
      mean = warp_sum(s) / c;
      float ss = 0.f;
      for (int j = lane * V; j < c; j += 32 * V) {
        float e[V];
        Vec16<T>::load(xr + j, e);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = e[i] - mean;
          ss += d * d;
        }
      }
      rs = rsqrtf(warp_sum(ss) / c + eps);
    }
    if (lane == 0) {
      mu[r] = mean;
      rstd[r] = rs;
    }
  }

  // ---- products: warp w owns fragment row w / 2 and fragment columns
  // 2 * (w % 2) and 2 * (w % 2) + 1 of each output's 4 x 4 fragments
  const int mi = warp / 2;
  const int nj0 = (warp % 2) * 2;
  typename M::Acc acc[3][2];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    wmma::fill_fragment(acc[o][0], 0.f);
    wmma::fill_fragment(acc[o][1], 0.f);
  }
  for (int k0 = 0; k0 < c; k0 += kQBK) {
    const int kc = min(kQBK, c - k0);
    __syncthreads();  // statistics written / previous slices consumed
    // x slice, normalised: thread t owns column vector t % vpr of every
    // (256 / vpr)-th row, so its LN scale and bias stay in registers
    const int vpr = kc / V;
    const int rstep = kQKVThreads / vpr;
    const int cc = (threadIdx.x % vpr) * V;
    if (threadIdx.x / vpr < rstep) {
      float g[V], b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        g[j] = to_float(ln_w[k0 + cc + j]);
        b[j] = to_float(ln_b[k0 + cc + j]);
      }
      for (int r = threadIdx.x / vpr; r < kQBM; r += rstep) {
        const int row = row0 + r;
        float e[V] = {};
        if (row < m) {
          Vec16<T>::load(x + (size_t)row * c + k0 + cc, e);
#pragma unroll
          for (int j = 0; j < V; ++j) e[j] = (e[j] - mu[r]) * rstd[r] * g[j] + b[j];
        }
        Vec16<T>::store(as + r * L::lda + cc, e);
      }
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      load_rows<T>(reinterpret_cast<T*>(smem + L::b_off + o * L::b_size), L::ldb,
                   w[o] + (size_t)col0 * c + k0, (size_t)c, 0, kQBN, inner - col0, kc);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += M::K) {
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const T* bs = reinterpret_cast<const T*>(smem + L::b_off + o * L::b_size);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          M::template step<wmma::col_major>(acc[o][j], as + (mi * 16) * L::lda + kk, L::lda,
                                            bs + ((nj0 + j) * 16) * L::ldb + kk, L::ldb);
        }
      }
    }
  }

  // ---- epilogue: per output, the tile through shared memory (it aliases
  // the slices), rounded to x's type, its valid part written
  const int ncols = min(kQBN, inner - col0);
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(tile + (mi * 16) * L::ldo + (nj0 + j) * 16, acc[o][j], L::ldo,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kQBM * kQBN; i += kQKVThreads) {
      const int r = i / kQBN;
      const int j = i % kQBN;
      if (row0 + r < m && j < ncols) {
        out[o][(size_t)(row0 + r) * inner + col0 + j] = from_float<T>(tile[r * L::ldo + j]);
      }
    }
  }
}

template <typename T>
static cudaError_t launch_ln_qkv(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wq, const void* wk, const void* wv, void* q, void* k,
                                 void* v, int m, int c, int inner, float eps,
                                 cudaStream_t stream) {
  constexpr size_t bytes = QKVLayout<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((inner + kQBN - 1) / kQBN, (m + kQBM - 1) / kQBM);
  ln_qkv_kernel<T><<<grid, kQKVThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(wq), static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v), m, c, inner, eps);
  return cudaGetLastError();
}

}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16; every tensor has that type. x [m, c];
// ln_w, ln_b [c]; wq, wk, wv [inner, c] (PyTorch Linear layout); q, k, v
// [m, inner]. Contiguous, 16-byte aligned, c % 16 == 0, inner % 16 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int emox_ln_qkv(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                           const void* wk, const void* wv, void* q, void* k, void* v, int m,
                           int c, int inner, float eps, int dtype, void* stream) {
  using namespace emox;
  if (m <= 0 || c <= 0 || c % 16 != 0 || inner <= 0 || inner % 16 != 0 ||
      (m + kQBM - 1) / kQBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_ln_qkv<__nv_bfloat16>(x, ln_w, ln_b, wq, wk, wv, q, k, v, m, c, inner,
                                             eps, s);
  if (dtype == 0)
    return (int)launch_ln_qkv<float>(x, ln_w, ln_b, wq, wk, wv, q, k, v, m, c, inner, eps, s);
  return (int)cudaErrorInvalidValue;
}
