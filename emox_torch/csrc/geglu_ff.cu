// GEGLU feed-forward for Hopper (sm_90a), without LayerNorm or residual.
//
//   y = W2 (a * gelu(g)) + b2,   [a | g] = x W1 + b1
//
// Replaces the TPU kernel `_ff_kernel` (emox/ops/ff.py, called by
// `_ff_impl` behind `fused_geglu_ff` and the dispatcher `geglu_ff`), which
// keeps the [M, 2F] projection and the gated [M, F] activation in VMEM with
// both weights resident. Here the same function is the block body of
// geglu_ff.cuh without its LayerNorm prologue and residual epilogue: one
// block per tile of BM rows, F walked in chunks of 64 with an fp32
// accumulator [BM, C] in shared memory, so no width is refused for want of
// room (the TPU kernel stopped at C 448).
//
// What bounds it on the H100: at M 32768 x C 320 (F 1280) it does
// 6*M*C*F = 80.5 GFLOP against 42 MB of x and y and 2.5 MB of weights, so
// the tensor cores bound it (0.081 ms at 989 TFLOP/s); unfused, the two
// intermediates would move 250 MB more in bf16. Rounding points follow the
// TPU kernel: h is rounded to x's type, both products accumulate in fp32,
// the output is rounded once. WMMA from shared-memory tiles, no TMA, wgmma
// or pipelining: making it fast is later work.
#include "geglu_ff.cuh"

namespace emox {

template <typename T, int BM>
__global__ void __launch_bounds__(kFFThreads)
    geglu_ff_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ y, int m,
                    int c, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  geglu_ff_block<T, BM, false>(smem, x, nullptr, nullptr, w1, b1, w2, b2, y, m, c, f, 0.f);
}

template <typename T>
using GegluKernel = decltype(&geglu_ff_kernel<T, 64>);

template <typename T>
static cudaError_t launch_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* y, int m, int c, int f,
                                   cudaStream_t stream) {
  const GegluKernel<T> kernels[] = {&geglu_ff_kernel<T, 64>, &geglu_ff_kernel<T, 32>,
                                    &geglu_ff_kernel<T, 16>};
  GegluKernel<T> kernel;
  int bm;
  size_t bytes;
  cudaError_t err = choose_ff_tile<T>(c, kernels, &kernel, &bm, &bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(m + bm - 1) / bm, kFFThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y), m, c, f);
  return cudaGetLastError();
}

}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16; every tensor has that type. x and y
// [m, c]; b2 [c]; w1 [2f, c] and b1 [2f] (PyTorch Linear layout, value rows
// first, then gate rows); w2 [c, f]. Contiguous, 16-byte aligned,
// c % 16 == 0, f % 64 == 0. Returns a cudaError_t (0 = launched).
extern "C" int emox_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, int m, int c, int f, int dtype,
                             void* stream) {
  using namespace emox;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || c % 16 != 0 || f <= 0 || f % kBF != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) return (int)launch_geglu_ff<__nv_bfloat16>(x, w1, b1, w2, b2, y, m, c, f, s);
  if (dtype == 0) return (int)launch_geglu_ff<float>(x, w1, b1, w2, b2, y, m, c, f, s);
  return (int)cudaErrorInvalidValue;
}
