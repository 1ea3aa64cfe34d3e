// Fused LayerNorm + GEGLU feed-forward + residual for Hopper (sm_90a), float32.
// bf16 runs on ff_sm90.cu (wgmma + TMA); this kernel serves the float32
// step and train phases.
//
//   y = x + W2 (a * gelu(g)) + b2,   [a | g] = LN(x) W1 + b1
//
// Replaces two TPU kernels (emox/ops/ff.py): `_ln_ff_kernel` (weights
// resident, taken at level 0, C 320) and `_ln_ff_wide_kernel` (the hidden
// dimension F tiled into an fp32 accumulator, taken at level 1, C 640).
// They differ only because the TPU's VMEM could not hold the wide weights;
// here one kernel that tiles F covers every width.
//
// What bounds it on the H100: at level 0 under CFG (M 32768 rows, C 320,
// F 1280) it does 6*M*C*F = 80.5 GFLOP against 42 MB of x and y and 2.5 MB
// of weights: the tensor cores bound it. Unfused, the [M, 2F] projection
// and the [M, F] gated activation would cost 250 MB of extra device-memory
// traffic in bf16, three times the work's own bytes. The design keeps both
// on chip; it is the block body of geglu_ff.cuh with its LayerNorm prologue
// (per-row fp32 statistics, two-pass variance, the normalised tile rounded
// to x's type) and the residual epilogue (x read again in fp32), shared with
// K6 (geglu_ff.cu). The weights are re-read from L2 by every row
// tile; no TMA, no wgmma, no pipelining. The working set leaves room for
// one block (8 warps) per SM at every width, and each block walks all of F
// alone, so a grid of fewer blocks than SMs (C 1280 at a few thousand rows
// or less) leaves SMs idle: ff_sm90.cu, the bf16 path, splits F across
// blocks.
#include "geglu_ff.cuh"

namespace emox {

template <typename T, int BM>
__global__ void __launch_bounds__(kFFThreads)
    ln_geglu_ff_kernel(const T* __restrict__ x, const T* __restrict__ ln_w,
                       const T* __restrict__ ln_b, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       const T* __restrict__ b2, T* __restrict__ y, int m, int c, int f,
                       float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  geglu_ff_block<T, BM, true>(smem, x, ln_w, ln_b, w1, b1, w2, b2, y, m, c, f, eps);
}

template <typename T>
using FFKernel = decltype(&ln_geglu_ff_kernel<T, 64>);

template <typename T>
static cudaError_t choose_tile(int c, FFKernel<T>* kernel, int* bm, size_t* bytes) {
  const FFKernel<T> kernels[] = {&ln_geglu_ff_kernel<T, 64>, &ln_geglu_ff_kernel<T, 32>,
                                 &ln_geglu_ff_kernel<T, 16>};
  return choose_ff_tile<T>(c, kernels, kernel, bm, bytes);
}

template <typename T>
static cudaError_t dispatch_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* y, int m,
                               int c, int f, float eps, cudaStream_t stream) {
  FFKernel<T> kernel;
  int bm;
  size_t bytes;
  cudaError_t err = choose_tile<T>(c, &kernel, &bm, &bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(m + bm - 1) / bm, kFFThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), m, c, f, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t plan_ff(int c, int* plan) {
  FFKernel<T> kernel;
  int bm;
  size_t bytes;
  cudaError_t err = choose_tile<T>(c, &kernel, &bm, &bytes);
  if (err != cudaSuccess) return err;
  plan[0] = bm;
  plan[1] = (int)bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[2], kernel, kFFThreads, bytes);
}

}  // namespace emox

// dtype: 0 = float32 (bfloat16 runs on ff_sm90.cu and is refused here);
// every tensor has that type. x and y
// [m, c]; ln_w, ln_b, b2 [c]; w1 [2f, c] and b1 [2f] (PyTorch Linear layout,
// value rows first, then gate rows); w2 [c, f]. Contiguous, 16-byte
// aligned, c % 16 == 0, f % 64 == 0. Returns a cudaError_t (0 = launched).
extern "C" int emox_ln_geglu_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* y, int m,
                                int c, int f, float eps, int dtype, void* stream) {
  using namespace emox;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || c % 16 != 0 || f <= 0 || f % kBF != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return (int)dispatch_ff<float>(x, ln_w, ln_b, w1, b1, w2, b2, y, m, c, f, eps, s);
  return (int)cudaErrorInvalidValue;
}

// What emox_ln_geglu_ff launches at width c on the current device, for
// reports: plan[0] the row tile (the grid is ceil(m / plan[0]) blocks),
// plan[1] the dynamic shared memory of a block in bytes, plan[2] the blocks
// resident on one SM. Returns a cudaError_t.
extern "C" int emox_ln_geglu_ff_plan(int c, int dtype, int* plan) {
  using namespace emox;
  if (dtype == 0) return (int)plan_ff<float>(c, plan);
  return (int)cudaErrorInvalidValue;
}
