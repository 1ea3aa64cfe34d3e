// The split launches of the float32 kernels that run on bf16 wgmma (the
// attention kernels of flash_fwd_sm90.cu, flash_bwd_sm90.cu,
// flash_bwd_d512_sm90.cu, flash_fwd_wide.cu and flash_attn_wide.cu; the GEMMs of ff_sm90.cu and
// ln_qkv_sm90.cu): each float32 operand x is written once into bf16 scratch
// as its two parts (sm90.cuh's split_pair), which the kernel then reads by
// TMA like any bf16 operand; a row of width w of the scratch holds hi in
// columns [0, w) and lo in [w, 2w), zero past the true width (the head dim,
// or the contraction), so zero columns change no product.
#pragma once

#include "sm90.cuh"

namespace emox {
namespace sm90 {

// One float32 row of d values (d a multiple of 4, 16-byte aligned) into its
// parts, a scratch row of 2w bf16: 128 threads of four columns each.
__device__ __forceinline__ void split_row(const float* __restrict__ in, int d, int w, __nv_bfloat16* __restrict__ row) {
  for (int c = 4 * threadIdx.x; c < w; c += 4 * 128) {
    const float4 v = c < d ? *reinterpret_cast<const float4*>(in + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 hi, lo;
    split_pair(v.x, v.y, hi.x, lo.x);
    split_pair(v.z, v.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(row + c) = hi;
    *reinterpret_cast<uint2*>(row + w + c) = lo;
  }
}

// One row of a float32 [B, H, L, d] operand (element strides (sb, sh, sr),
// d a multiple of 4, rows 16-byte aligned) into contiguous bf16 scratch
// [B, H, L, 2w]. A block per row.
__global__ void __launch_bounds__(128) split_rows(const float* __restrict__ x, long long sb, long long sh,
                                                  long long sr, int d, int w, __nv_bfloat16* __restrict__ out,
                                                  int heads, int len) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  split_row(x + b * sb + h * sh + (long long)r * sr, d, w, out + (((long long)b * heads + h) * len + r) * 2 * w);
}

// Up to four contiguous float32 matrices [rows, d] (d a multiple of 4, rows
// 16-byte aligned), each into its scratch [rows, 2w], in one launch: a
// block per row of them all, in order.
struct SplitJob {
  const float* src;
  __nv_bfloat16* dst;
  int rows, d, w;
};
constexpr int kMaxSplitJobs = 4;
struct SplitJobs {
  SplitJob job[kMaxSplitJobs];
  int count;
};

__global__ void __launch_bounds__(128) split_matrices_kernel(const SplitJobs jobs) {
  int r = blockIdx.x;
  SplitJob j = jobs.job[0];
#pragma unroll
  for (int k = 1; k < kMaxSplitJobs; ++k) {
    if (k < jobs.count && r >= j.rows) {
      r -= j.rows;
      j = jobs.job[k];
    }
  }
  split_row(j.src + (long long)r * j.d, j.d, j.w, j.dst + (long long)r * 2 * j.w);
}

static cudaError_t split_matrices(const SplitJobs& jobs, cudaStream_t stream) {
  long long rows = 0;
  for (int k = 0; k < jobs.count; ++k) rows += jobs.job[k].rows;
  if (jobs.count < 1 || jobs.count > kMaxSplitJobs || rows > 0x7fffffff) return cudaErrorInvalidValue;
  split_matrices_kernel<<<(unsigned)rows, 128, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// The parts' width of a float32 contraction of d columns: d padded to whole
// 64-column (128-byte) TMA boxes, so that no hi box runs into the lo part.
static int split_width(int d) { return (d + 63) / 64 * 64; }

// The parts of a float32 operand with element strides st (batch, head, row)
// into `out` ([batch, heads, len, 2w] bf16, contiguous), on `stream`.
static cudaError_t split_operand(const void* x, const long long* st, int batch, int heads, int len, int d, int w,
                                 void* out, cudaStream_t stream) {
  split_rows<<<dim3(len, heads, batch), 128, 0, stream>>>(static_cast<const float*>(x), st[0], st[1], st[2], d, w,
                                                          static_cast<__nv_bfloat16*>(out), heads, len);
  return cudaGetLastError();
}

// The element strides (batch, head, row) of that scratch
static void scratch_strides(long long* st, int heads, int len, int w) {
  st[0] = (long long)heads * len * 2 * w;
  st[1] = (long long)len * 2 * w;
  st[2] = 2 * w;
}

}  // namespace sm90
}  // namespace emox
