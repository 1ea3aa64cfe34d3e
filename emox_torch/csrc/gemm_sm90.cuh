// The streamed GEMM of the port's wgmma + TMA kernels whose A operand is a
// row-major [M, K] matrix (ff_sm90.cu's two GEMMs, ln_qkv_sm90.cu's float32
// projection), and the LayerNorm pass that feeds them (bf16, or float32's
// two parts).
//
// A block's 128 rows of A (64 per consumer warpgroup) and BN rows of B, both
// K-major and 128-byte swizzled, arrive 64 columns deep a stage through a
// ring that one producer thread fills with TMA loads; each consumer
// warpgroup runs wgmma on what has arrived, keeps one group in flight and
// hands a stage back once the group that read it is done. With PARTS 2
// (float32 on the two-part split, split.cuh) A and B are bf16 scratch
// [rows, 2w], hi in columns [0, w) and lo in [w, 2w): a stage holds both
// parts of the same 64 columns, A hi, A lo, B hi, B lo, and every product
// runs as A_hi B_hi + A_hi B_lo + A_lo B_hi (sm90.cuh's `product`).
#pragma once

#include "split.cuh"

namespace emox {
namespace gemm_sm90 {

using namespace emox::sm90;

constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kBM = 128;       // rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;        // contraction depth per stage (one 128-byte box)
constexpr int kLnWarps = 8;    // LN passes: rows per 256-thread block

// full[s]: the stage's bytes arrived; empty[s]: both consumer warpgroups are
// done with it.
template <int BN, int STAGES, int PARTS>
struct Ring {
  static constexpr uint32_t a_bytes = kBM * 128;  // one part of A
  static constexpr uint32_t b_bytes = BN * 128;   // one part of B
  static constexpr uint32_t stage = PARTS * (a_bytes + b_bytes);  // a multiple of 1024
  static constexpr uint32_t bar_off = STAGES * stage;
  static constexpr uint32_t bytes = bar_off + 16 * STAGES + 1024;  // + alignment slack
};

// The producer's thread: k-steps [k0, k1) of A (rows m0..) and of B, whose
// boxes come from `nb` maps at rows n0 and lie one after the other; with
// PARTS 2 the lo parts from column `w` on.
template <int BN, int STAGES, int PARTS>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* ta, const CUtensorMap* tb0,
                                        const CUtensorMap* tb1, int nb, int m0, int n0, int k0, int k1, int w) {
  using R = Ring<BN, STAGES, PARTS>;
  const uint32_t full0 = base + R::bar_off, empty0 = full0 + 8 * STAGES;
  for (int j = 0; j < k1 - k0; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
    const uint32_t full = full0 + 8 * s, st = base + s * R::stage;
    mbar_expect_tx(full, R::stage);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      const int kc = (k0 + j) * kBK + p * w;
      const uint32_t bt = st + PARTS * R::a_bytes + p * R::b_bytes;
      tma_load_2d(st + p * R::a_bytes, ta, full, kc, m0);
      tma_load_2d(bt, tb0, full, kc, n0);
      if (nb == 2) tma_load_2d(bt + R::b_bytes / 2, tb1, full, kc, n0);
    }
  }
}

// A consumer warpgroup: acc[BN / 2] = its 64 rows of A times B over `steps`
// k-steps.
template <int BN, int STAGES, int PARTS>
__device__ __forceinline__ void consume(float* acc, uint32_t base, int wg, int steps) {
  using R = Ring<BN, STAGES, PARTS>;
  const uint32_t full0 = base + R::bar_off, empty0 = full0 + 8 * STAGES;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs<BN / 2>(acc);
  for (int j = 0; j < steps; ++j) {
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const uint32_t st = base + s * R::stage;
    wgmma_fence();
    product<BN, 1, PARTS>(acc, st + wg * 64 * 128, R::a_bytes, st + PARTS * R::a_bytes, R::b_bytes, j > 0);
    wgmma_commit();
    wgmma_wait1();
    if (j > 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
  }
  wgmma_wait0();
  fence_regs<BN / 2>(acc);
}

__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }

// N bf16 values, stored as one vector
template <int N>
struct alignas(2 * N) Bf16s {
  uint32_t pair[N / 2];
};

// ---- LayerNorm rows -----------------------------------------------------------------
// xn = (x - mean) * rstd * w + b from fp32 two-pass statistics (the mean,
// then the mean of squared deviations), one warp per row, 16 bytes of x a
// vector (c a multiple of 8 in bf16, of 4 in float32). bf16: xn [m, c]
// rounded to bf16, the reference's rounding point. float32 (its own type:
// not rounded): xn's parts [m, 2wd], hi | lo, zeros past c.
template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
    ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                   __nv_bfloat16* __restrict__ xn, int m, int c, int wd, float eps) {
  constexpr int kV = 16 / sizeof(T);            // values a vector
  constexpr bool kParts = sizeof(T) == 4;       // float32: write both parts
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * c);
  const int vecs = c / kV;
  float s = 0.f;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 u = xr[v];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kV; ++i) s += ld(e, i);
  }
  const float mu = warp_sum(s) / c;
  float ss = 0.f;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 u = xr[v];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float d = ld(e, i) - mu;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / c + eps);
  __nv_bfloat16* out = xn + (size_t)row * (kParts ? 2 * wd : c);
  for (int v = lane; v < (kParts ? wd / kV : vecs); v += 32) {
    float y[kV];
    if (v < vecs) {
      const uint4 u = xr[v];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kV; ++i) y[i] = (ld(e, i) - mu) * rstd * ld(w, kV * v + i) + ld(b, kV * v + i);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) y[i] = 0.f;
    }
    Bf16s<kV> hi, lo;
#pragma unroll
    for (int i = 0; i < kV / 2; ++i) {
      if constexpr (kParts) {
        split_pair(y[2 * i], y[2 * i + 1], hi.pair[i], lo.pair[i]);
      } else {
        hi.pair[i] = pack_bf16(y[2 * i], y[2 * i + 1]);
      }
    }
    *reinterpret_cast<Bf16s<kV>*>(out + kV * v) = hi;
    if constexpr (kParts) *reinterpret_cast<Bf16s<kV>*>(out + wd + kV * v) = lo;
  }
}

// wd: float32's part width (c padded to 64); unused in bf16
template <typename T>
static cudaError_t ln_rows(const T* x, const T* w, const T* b, __nv_bfloat16* xn, int m, int c, int wd, float eps,
                           cudaStream_t stream) {
  ln_rows_kernel<T><<<(m + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, w, b, xn, m, c, wd, eps);
  return cudaGetLastError();
}

template <typename Kernel>
static cudaError_t smem_attr(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace gemm_sm90
}  // namespace emox
