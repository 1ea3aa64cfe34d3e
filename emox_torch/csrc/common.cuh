// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Tile products run on the tensor cores through WMMA, from tiles staged in
// shared memory, with fp32 accumulation:
//   * bfloat16 operands: one m16n16k16 bf16 product per 16-deep step;
//   * float32 operands: m16n16k8 TF32 products in the 3xTF32 split
//     (a = a_hi + a_lo, b = b_hi + b_lo; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi),
//     which keeps float32 accuracy (the dropped a_lo*b_lo term is below
//     float32 rounding) while still running on the tensor cores. The
//     float32 path exists so a float32 model on the card can be held
//     against the same model on the CPU at float32 tolerance.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace emox {

using namespace nvcuda;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Row padding of shared-memory tiles: 16 bytes, which keeps every WMMA
// fragment pointer 32-byte aligned (fragments start at multiples of 16 rows
// and 16 columns, or 8 columns for TF32) and staggers rows across banks.
template <typename T>
struct Pad {
  static constexpr int value = 16 / sizeof(T);
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;  // depth of one step
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  // c(16x16) += a(16xK, row-major, lda) * b(Kx16, LayoutB, ldb)
  template <typename LayoutB>
  static __device__ __forceinline__ void step(Acc& c, const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* b, int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

  template <typename LayoutB>
  static __device__ __forceinline__ void step(Acc& c, const float* a, int lda, const float* b,
                                              int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> ah, al;
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, LayoutB> bh, bl;
    wmma::load_matrix_sync(ah, a, lda);
    wmma::load_matrix_sync(bh, b, ldb);
#pragma unroll
    for (int i = 0; i < ah.num_elements; ++i) {
      const float v = ah.x[i];
      const float hi = wmma::__float_to_tf32(v);
      al.x[i] = wmma::__float_to_tf32(v - hi);
      ah.x[i] = hi;
    }
#pragma unroll
    for (int i = 0; i < bh.num_elements; ++i) {
      const float v = bh.x[i];
      const float hi = wmma::__float_to_tf32(v);
      bl.x[i] = wmma::__float_to_tf32(v - hi);
      bh.x[i] = hi;
    }
    wmma::mma_sync(c, al, bh, c);
    wmma::mma_sync(c, ah, bl, c);
    wmma::mma_sync(c, ah, bh, c);
  }
};

// Copy rows [row0, row0 + rows) x columns [0, cols) of a row-major global
// array (row stride `stride` elements) into a shared tile with leading
// dimension `ld`; rows at or past `nrows` are zero-filled. 16-byte vectors:
// `cols`, `stride`, `ld` and the column offset of `src` must keep every
// vector 16-byte aligned (the wrappers check the base pointers).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, size_t stride, int row0,
                                          int rows, int nrows, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = cols / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int cc = (i - r * vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + cc);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + cc) = val;
  }
}

// Element strides of one [B, H, L, D] operand whose last dimension is
// contiguous: element (b, h, row, d) sits at b*b + h*h + row*r + d.
struct Strides3 {
  long long b, h, r;
};

// load_rows for a strided operand whose head dim `cols` is narrower than the
// tile: columns [cols, cols_pad) of the tile are zero-filled, as are rows at
// or past `nrows`. Zero columns leave q k^T, P v and every gradient product
// unchanged, as the TPU kernels' zero pad of the head dim does. `cols`,
// `cols_pad`, `ld`, `stride` and `src` must keep each 16-byte vector aligned
// (the wrappers check the pointers and the strides).
template <typename T>
__device__ __forceinline__ void load_rows_padded(T* dst, int ld, const T* src, long long stride,
                                                 int row0, int rows, int nrows, int cols,
                                                 int cols_pad) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = cols_pad / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int cc = (i - r * vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cc < cols && row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + cc);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + cc) = val;
  }
}

// One 16-byte vector of T (4 float32 or 8 bfloat16 values) between memory
// and fp32 registers; the pointer must be 16-byte aligned. Stores round to
// nearest even, as torch's .to(bfloat16).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace emox
