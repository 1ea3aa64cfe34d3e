// The split launch of the float32 attention kernels that run on bf16 wgmma
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_d512_sm90.cu,
// flash_attn_wide.cu): each float32 operand x is written once into bf16
// scratch as its two parts (sm90.cuh's split_pair), which the attention
// kernel then reads by TMA like any bf16 operand; a row of width w of the
// scratch holds hi in columns [0, w) and lo in [w, 2w), zero past the true
// head dim, so zero columns change no product.
#pragma once

#include "sm90.cuh"

namespace emox {
namespace sm90 {

// One row of a float32 [B, H, L, d] operand (element strides (sb, sh, sr),
// d a multiple of 4, rows 16-byte aligned) into contiguous bf16 scratch
// [B, H, L, 2w]. A block per row, 128 threads of four columns each.
__global__ void __launch_bounds__(128) split_rows(const float* __restrict__ x, long long sb, long long sh,
                                                  long long sr, int d, int w, __nv_bfloat16* __restrict__ out,
                                                  int heads, int len) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float* in = x + b * sb + h * sh + (long long)r * sr;
  __nv_bfloat16* row = out + (((long long)b * heads + h) * len + r) * 2 * w;
  for (int c = 4 * threadIdx.x; c < w; c += 4 * 128) {
    const float4 v = c < d ? *reinterpret_cast<const float4*>(in + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 hi, lo;
    split_pair(v.x, v.y, hi.x, lo.x);
    split_pair(v.z, v.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(row + c) = hi;
    *reinterpret_cast<uint2*>(row + w + c) = lo;
  }
}

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
