// The GEGLU feed-forward's float32 block body for Hopper (sm_90a), shared by
// two kernels: ln_geglu_ff.cu (LayerNorm prologue and residual epilogue) and
// geglu_ff.cu (neither). It serves float32 only (3xTF32 WMMA):
// bf16 runs on ff_sm90.cu (wgmma + TMA GEMMs), as bf16 attention left the
// WMMA kernels for flash_fwd_sm90.cu. The body stays a template on the type.
//
//   y = [x +] W2 (a * gelu(g)) + b2,   [a | g] = [LN](x) W1 + b1
//
// One block per tile of BM rows (64, or 32 / 16 at wide C so that the fp32
// accumulator [BM, C] and the input tile fit shared memory):
//   * prologue: the x tile in shared memory, with LN: per-row statistics in
//     fp32 (two-pass variance), normalised in place and rounded to x's type;
//   * loop over F in chunks of 64: [a | g] = x W1[chunk] on the tensor cores
//     (WMMA, fp32 accumulation, W1 streamed through shared memory in 64-wide
//     slices of C), h = (a + b1) * gelu(g + b1) with exact erff, rounded to
//     x's type, then acc += h W2[chunk] (acc in fp32, in shared memory);
//   * epilogue: y = acc + b2 (+ x, read again in fp32, with LN).
// Rounding points follow the TPU kernels: the normalised x and h are rounded
// to x's type, everything else stays fp32. The weights are re-read from L2
// by every row tile; no TMA, no wgmma, no pipelining.
#pragma once

#include "common.cuh"

namespace emox {

constexpr int kFFThreads = 256;  // 8 warps
constexpr int kBF = 64;          // hidden (F) chunk
constexpr int kKC = 64;          // slice of C per W1 load
constexpr int kNC = 64;          // slice of C per W2 load

template <typename T>
struct FFLayout {
  int ldx, lda, ldw1, ldh32, ldh, ldw2;
  size_t x_off, acc_off, w1_off, h32_off, h_off, w2_off, bytes;

  __host__ __device__ FFLayout(int bm, int c) {
    constexpr int P = Pad<T>::value;
    ldx = c + P;             // input tile x or LN(x) [BM, C] (T)
    lda = c + 4;             // accumulator [BM, C] (fp32)
    ldw1 = kKC + P;          // W1 rows of the chunk: [2*BF, KC] (T)
    ldh32 = 2 * kBF + 4;     // [a | g] before the gate: [BM, 2*BF] (fp32)
    ldh = kBF + P;           // gated h: [BM, BF] (T)
    ldw2 = kBF + P;          // W2 slice: [NC, BF] (T)
    x_off = 0;
    acc_off = align128(x_off + sizeof(T) * bm * ldx);
    w1_off = align128(acc_off + sizeof(float) * bm * lda);
    h32_off = align128(w1_off + sizeof(T) * 2 * kBF * ldw1);
    h_off = align128(h32_off + sizeof(float) * bm * ldh32);
    w2_off = align128(h_off + sizeof(T) * bm * ldh);
    bytes = align128(w2_off + sizeof(T) * kNC * ldw2);
  }
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

// The block body. kLN: LayerNorm the tile first (ln_w, ln_b, eps) and add x
// to the output; without it ln_w, ln_b and eps are not read.
template <typename T, int BM, bool kLN>
__device__ __forceinline__ void geglu_ff_block(unsigned char* smem, const T* __restrict__ x,
                                               const T* __restrict__ ln_w,
                                               const T* __restrict__ ln_b,
                                               const T* __restrict__ w1, const T* __restrict__ b1,
                                               const T* __restrict__ w2, const T* __restrict__ b2,
                                               T* __restrict__ y, int m, int c, int f, float eps) {
  using M = Mma<T>;
  constexpr int MI = BM / 16;  // 16-row fragment rows in the tile
  const FFLayout<T> lay(BM, c);
  T* xn = reinterpret_cast<T*>(smem + lay.x_off);
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);
  T* w1s = reinterpret_cast<T*>(smem + lay.w1_off);
  float* h32 = reinterpret_cast<float*>(smem + lay.h32_off);
  T* hs = reinterpret_cast<T*>(smem + lay.h_off);
  T* w2s = reinterpret_cast<T*>(smem + lay.w2_off);

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- prologue: x tile -> shared (LayerNorm in place), zero the accumulator
  load_rows<T>(xn, lay.ldx, x, (size_t)c, row0, BM, m, c);
  for (int i = threadIdx.x; i < BM * c; i += kFFThreads) acc[(i / c) * lay.lda + i % c] = 0.f;
  __syncthreads();
  if constexpr (kLN) {
    for (int r = warp; r < BM; r += kFFThreads / 32) {
      T* row = xn + (size_t)r * lay.ldx;
      float s = 0.f;
      for (int j = lane; j < c; j += 32) s += to_float(row[j]);
      const float mu = warp_sum(s) / c;
      float ss = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float d = to_float(row[j]) - mu;
        ss += d * d;
      }
      const float rstd = rsqrtf(warp_sum(ss) / c + eps);
      for (int j = lane; j < c; j += 32) {
        const float xv = (to_float(row[j]) - mu) * rstd;
        row[j] = from_float<T>(xv * to_float(ln_w[j]) + to_float(ln_b[j]));
      }
    }
    __syncthreads();
  }

  for (int f0 = 0; f0 < f; f0 += kBF) {
    // ---- [a | g] = xn W1[chunk]: warp w owns output columns 16w..16w+15 of
    // the 2*BF-wide chunk (w < 4: value columns, w >= 4: gate columns)
    typename M::Acc pa[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) wmma::fill_fragment(pa[i], 0.f);
    for (int k0 = 0; k0 < c; k0 += kKC) {
      const int kc = min(kKC, c - k0);
      __syncthreads();  // previous slice consumed
      load_rows<T>(w1s, lay.ldw1, w1 + (size_t)f0 * c + k0, (size_t)c, 0, kBF, kBF, kc);
      load_rows<T>(w1s + (size_t)kBF * lay.ldw1, lay.ldw1, w1 + (size_t)(f + f0) * c + k0,
                   (size_t)c, 0, kBF, kBF, kc);
      __syncthreads();
      for (int kk = 0; kk < kc; kk += M::K) {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          M::template step<wmma::col_major>(pa[i], xn + (i * 16) * lay.ldx + k0 + kk, lay.ldx,
                                            w1s + (warp * 16) * lay.ldw1 + kk, lay.ldw1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      wmma::store_matrix_sync(h32 + (i * 16) * lay.ldh32 + warp * 16, pa[i], lay.ldh32,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // ---- h = (a + b1) * gelu(g + b1), rounded to x's type
    for (int i = threadIdx.x; i < BM * kBF; i += kFFThreads) {
      const int r = i / kBF;
      const int j = i % kBF;
      const float a = h32[r * lay.ldh32 + j] + to_float(b1[f0 + j]);
      const float g = h32[r * lay.ldh32 + kBF + j] + to_float(b1[f + f0 + j]);
      hs[r * lay.ldh + j] = from_float<T>(a * gelu_erf(g));
    }

    // ---- acc += h W2[chunk], W2 streamed in 64-wide slices of C
    for (int n0 = 0; n0 < c; n0 += kNC) {
      const int nc = min(kNC, c - n0);
      __syncthreads();  // hs written / previous W2 slice consumed
      load_rows<T>(w2s, lay.ldw2, w2 + (size_t)n0 * f + f0, (size_t)f, 0, nc, nc, kBF);
      __syncthreads();
      const int nj_count = nc / 16;
      for (int t = warp; t < MI * nj_count; t += kFFThreads / 32) {
        const int mi = t / nj_count;
        const int nj = t % nj_count;
        float* ap = acc + (mi * 16) * lay.lda + n0 + nj * 16;
        typename M::Acc fr;
        wmma::load_matrix_sync(fr, ap, lay.lda, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBF; kk += M::K) {
          M::template step<wmma::col_major>(fr, hs + (mi * 16) * lay.ldh + kk, lay.ldh,
                                            w2s + (nj * 16) * lay.ldw2 + kk, lay.ldw2);
        }
        wmma::store_matrix_sync(ap, fr, lay.lda, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: y = acc + b2 (+ x in fp32)
  for (int i = threadIdx.x; i < BM * c; i += kFFThreads) {
    const int r = i / c;
    const int j = i % c;
    const int row = row0 + r;
    if (row < m) {
      const size_t g = (size_t)row * c + j;
      float out = acc[r * lay.lda + j] + to_float(b2[j]);
      if constexpr (kLN) out += to_float(x[g]);
      y[g] = from_float<T>(out);
    }
  }
}

// The largest row tile (64, 32, 16) whose working set fits one block's shared
// memory: its kernel from `kernels` (one per tile, in that order), with its
// dynamic shared memory set up.
template <typename T, typename Kernel>
static cudaError_t choose_ff_tile(int c, const Kernel (&kernels)[3], Kernel* kernel, int* bm,
                                  size_t* bytes) {
  int device = 0;
  int smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < 3; ++i) {
    *bm = 64 >> i;
    *bytes = FFLayout<T>(*bm, c).bytes;
    if (*bytes <= (size_t)smem_max) {
      *kernel = kernels[i];
      return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)*bytes);
    }
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace emox
