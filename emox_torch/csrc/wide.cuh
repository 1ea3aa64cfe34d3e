// The column slices of the attention kernels at head dims above 512
// (flash_fwd_wide.cu, the forward; flash_attn_wide.cu, the backward): their
// shared constants, launch arguments and operand setup. The reference sends
// every head dim d % 64 == 0 to its packed kernel and any other d to its
// strided one, with no width limit. No preset reaches such a head dim; a VAE
// of last width 640 or 1024 at L >= 2048 would.
//
// The room is the problem: one fp32 accumulator row of width d is d/2
// registers a thread at 64 rows a warpgroup, and a 64-row operand tile d/8
// KB. The design keeps no tile of full width anywhere: the head dim is cut
// into column slices, and a block owns only its slice of the outputs.
//
// Float32 (PARTS = 2): q, k, v (and dO) are first split into bf16 scratch
// [B, H, L, 2W] (split.cuh: hi in columns [0, W), lo in [W, 2W), W the head
// dim padded to the slices), every product a b runs as a_hi b_hi + a_hi b_lo
// + a_lo b_hi with fp32 accumulation, and P and dS are split in registers.
// bf16 reads the caller's operands directly: the columns past d of the last
// chunk and slice arrive zero-filled (TMA out-of-bounds fill), as do keys
// past Lk (masked: P = 0) and rows past Lq (P = 0 through lse = +inf in the
// dk/dv kernel, whose lse and delta come as [B, H, Lq_pad], Lq_pad the next
// multiple of 64, padded with +inf and 0).
#pragma once

#include "split.cuh"

namespace emox {
namespace wide {

using namespace emox::sm90;

constexpr int kSlice = 128;        // head-dim columns a block owns
constexpr int kRows = 64;          // query rows (forward, dq) or keys (dk/dv) a block owns
constexpr int kThreads = 256;      // warpgroup 0: consumer; 1: producer (its first thread)
constexpr int STAGES = 2;          // chunks in flight
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr uint32_t kBox = 64 * 128;  // one 64-row x 64-column bf16 box

template <typename TO>
struct Args {
  TO *o, *dq, *dk, *dv;
  float* lse;          // forward: written (element strides l_b, l_h, l_r)
  const float* lse_in;  // backward: [B, H, lq_pad], +inf past lq
  const float* delta;   // backward: [B, H, lq_pad], 0 past lq
  long long o_b, o_h, o_r, l_b, l_h, l_r;
  long long dq_b, dq_h, dq_r, dk_b, dk_h, dk_r, dv_b, dv_h, dv_r;
  int heads, lq, lk, lq_pad, d;
  int chunks;          // 64-column chunks of the head dim
  int slices;          // 128-column slices of the head dim
  int lo;              // float32: the first column of the lo parts in the scratch (W)
  float scale, scale_log2;
  int cs, ck, kstages, vstages;  // the cluster forward's plan (ClusterFwd)
};

// The columns of chunk or slice box `c` of part `part` (0: hi, the
// caller's columns in bf16; 1: lo)
__device__ __forceinline__ int column(int part, int c, int lo) { return part * lo + 64 * c; }

__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, 128);
  }
}

// The operands the kernels read: the caller's (bf16) or their parts in the
// scratch (float32, split here first). st: (batch, head, row) element
// strides of each, in the order of `src`; returns the maps' width.
static int operands(const void** src, void** parts, const int* lens, int n, const long long* strides,
                    long long* st, int batch, int heads, int d, int w, bool f32, cudaStream_t s, cudaError_t* err) {
  *err = cudaSuccess;
  for (int i = 0; i < n; ++i) {
    if (f32) {
      *err = split_operand(src[i], strides + 3 * i, batch, heads, lens[i], d, w, parts[i], s);
      if (*err != cudaSuccess) return 0;
      scratch_strides(st + 3 * i, heads, lens[i], w);
      src[i] = parts[i];
    } else {
      for (int x = 0; x < 3; ++x) st[3 * i + x] = strides[3 * i + x];
    }
  }
  return f32 ? 2 * w : d;
}

}  // namespace wide
}  // namespace emox

// The slices and padded width of a head dim: 128-column slices, the scratch
// of a float32 operand [.., 2w] with w = 128 * slices
static int wide_slices(int head_dim) { return (head_dim + emox::wide::kSlice - 1) / emox::wide::kSlice; }
