// Flash-attention backward at head dim 512 for Hopper (sm_90a): wgmma + TMA,
// bf16, the head dim split over a cluster of two blocks.
//
// Replaces the TPU kernels `_flash_bwd_nlc_dq_kernel` and
// `_flash_bwd_nlc_dkv_kernel` (emox/ops/attention.py:465,508) where the head
// dim is 512: the gradient of the VAE's single-head mid-attention, which VAE
// pretraining (stage 5) differentiates. From q, k, v, the output gradient dO,
// the forward's log-sum-exp lse and delta = sum_d dO*O per row (both fp32,
// computed outside the kernels as the TPU path computes delta), it returns
//   P = exp(q k^T * scale - lse),  dv = P^T dO,  dS = P (dO v^T - delta),
//   dq = dS k * scale,             dk = dS^T q * scale.
// The operands are [B, H, L, 512] with element strides (batch, head, row), so
// head-split views of packed tokens [N, L, H*512] need no copy.
//
// What bounds it on the H100: stage 5 at 512^2 (N 4, L 4096, H 1) needs
// 10*N*H*L*L*d = 344 GFLOP against 134 MB of operands and gradients: the
// tensor cores, 0.347 ms at 989 TFLOP/s. What makes d 512 hard is room, not
// work: at 64 rows one fp32 gradient tile of width 512 is 128 KB, half an
// SM's registers, and one 64 x 512 bf16 operand tile 64 KB of the 227 KB of
// shared memory a block may have. The design:
//   * two kernels, as the TPU kernels are (dq; dk and dv), each block owning
//     the rows it writes: no atomics, the same bits from run to run;
//   * a cluster of two blocks per tile, each owning one 256-column half of
//     the head dim: it loads only its half of every operand (TMA, 64-column
//     boxes) and writes only its half of the gradients. S = q k^T and
//     dP = dO v^T are sums over the head dim, so each block computes its
//     half's partial (wgmma, fp32) and sends it to the other block's shared
//     memory (st.async, whose bytes count on the receiver's mbarrier as
//     they land; the receiver arms it with the bytes it expects and polls
//     it with acquire semantics at cluster scope); each adds the two
//     partials, and since a + b == b + a in IEEE arithmetic both blocks
//     hold the same bits of S and dP. The receiver's warpgroup arrives once
//     on the sender's `free` barrier when it has read them, before the
//     sender overwrites them with the next tile's. No recompute beyond
//     the 7 products of N*H*L*L*d (S and dP in both kernels);
//   * dq kernel, a pair per (64 query rows, head, batch): Q and dO (its
//     half) stay in shared memory, 64-key K and V tiles stream through a
//     two-stage ring from one producer warp. Consumer warpgroup w takes keys
//     32w..32w+31 of every tile: their S and dP partials (m64n32 products,
//     256 deep; S goes to the peer while dP's products still run), the
//     exchange, dS = P (dP - delta) rounded to bf16 as the
//     register A operand, and dQ_w += dS K over its keys into a [64, 256]
//     fp32 accumulator (128 registers). At the end warpgroup 1 hands its
//     dQ_1 through shared memory and warpgroup 0 stores dQ_0 + dQ_1;
//   * dk/dv kernel, a pair per (64 keys, head, batch): K and V (its half)
//     stay, 64-row Q and dO tiles stream through a two-stage ring with their
//     lse and delta (bulk copies from [B, H, Lq_pad], padded with lse = +inf
//     and delta = 0, so rows past Lq give P = 0 and dS = 0). Warpgroup 0
//     computes the S^T partial (m64n64), exchanges it, and owns dV [64, 256]
//     (from P^T); warpgroup 1 the dP^T partial and dK [64, 256] (from dS^T).
//     Warpgroup 0 writes P^T over the peer's S^T partial in its slot, where
//     warpgroup 1 reads it, so that the exchange needs no third buffer;
//   * keys past Lk of a ragged K tile arrive zero-filled and are masked to
//     P = 0 in the dq kernel; the dk/dv kernel does not store them. Rows past
//     Lq are not stored. cluster.sync() at the end keeps each block's shared
//     memory alive while its partner may still arrive on its barriers.
// Head dims 129-256 (emox_flash_bwd_d256_sm90, both types) run the same two
// kernels at half the width, HALF = 128 columns a block: bf16 on the
// caller's operands (the columns past d arrive zero-filled), float32 on a
// two-part bf16 split of q, k, v and dO (split.cuh, [B, H, L, 512] scratch:
// hi in columns 0-255, lo in 256-511), PARTS = 2, every product
// a_hi b_hi + a_hi b_lo + a_lo b_hi, P and dS split in registers. A
// float32 block holds as many bytes as a bf16 one at d 512 (231,504 B for
// dk/dv), and half the accumulator registers. They replace the WMMA kernels
// that took these head dims before (flash_attn_bwd.cu), which spilled dK and
// dV at 192 and 256.
// Float32 at head dims 257-512 (emox_flash_bwd_d512_f32; 257-511 arrive
// zero-padded to 512) runs the same kernels with HALF 128, PARTS 2 and a
// cluster of four blocks a tile (CLUSTER 4), each owning 128 of the 512
// columns: the per-block geometry of float32 d 129-256, on a [B, H, L, 1024]
// split scratch (hi in columns 0-511, lo in 512-1023). It replaces the 3xTF32
// WMMA kernels of flash_bwd_d512.cu (17x the fp32 CUDA cores' bound). A
// HALF 256 float32 pair does not fit: its resident Q/dO and one stage of K/V
// alone exceed 227 KB. The four S (dP) partials are summed in two rounds of
// the pair's exchange on the pair's slots: first with rank ^ 1, then the
// pair sums with rank ^ 2, so every rank holds (p0 + p1) + (p2 + p3) in the
// same bits: rank 1 adds (p1 + p0) + (p3 + p2), rank 2 (p2 + p3) + (p0 + p1),
// and IEEE addition is commutative. A slot takes round 1 from rank ^ 1 and
// round 2 from rank ^ 2, so each round has its own `free` arrival: the
// receiver frees it to rank ^ 2 once it has read round 1, and to rank ^ 1
// (for the next tile) once it has read round 2; the receiver's in_full
// barrier completes twice a tile. The second round costs a round trip a
// tile and 16 B of barriers (230,488 / 231,520 B a block).
// Not yet done: a persistent grid (at L 2304, N 2, each kernel's 144 blocks
// take two waves of 132 SMs), overlap of the exchange with the next tile's
// products.
// The kernels are flash_bwd_cluster.cuh's, which flash_bwd_wide_sm90.cu shares
// (head dims above 512, the plan's cluster at run time).
#include "flash_bwd_cluster.cuh"

// bf16 attention backward at head dim 512 on [batch, heads, L, 512] operands
// with element strides: `strides` holds (batch, head, row) for q, k, v, dout,
// dq, dk and dv in that order (21 values; those of an output not asked for
// are ignored), the head dim contiguous. q, k, v, dout: 16-byte aligned base
// pointers and 16-byte multiples for every stride in bytes. lse and delta:
// [batch, heads, lq_pad] float32, contiguous, 16-byte aligned, lq_pad a
// multiple of 64 with lq <= lq_pad < lq + 64, padded with lse = +inf and
// delta = 0. dq == NULL skips the dq kernel; dk and dv are both given (the
// dk/dv kernel runs) or both NULL. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_bwd_d512_sm90(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                        const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                        float scale, void* stream) {
  using namespace emox::bwd_d512_sm90;
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv)) return (int)cudaErrorInvalidValue;
  const auto a = make_args<__nv_bfloat16>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, 512, scale);
  return (int)launch<256, 1, 2, 2>(q, k, v, dout, strides, 512, a, batch, static_cast<cudaStream_t>(stream));
}

// Attention backward at head dims 129-256 in bf16 (dtype 1) or float32
// (dtype 0), as emox_flash_bwd_d512_sm90 on [batch, heads, L, head_dim]
// operands (bf16: head_dim a multiple of 8; float32: of 4). Float32 splits q,
// k, v and dout first into q2, k2, v2, do2: bf16 scratch of [batch, heads,
// lq or lk, 512] elements, contiguous (NULL in bf16).
extern "C" int emox_flash_bwd_d256_sm90(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                        const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                        int head_dim, float scale, int dtype, void* q2, void* k2, void* v2, void* do2,
                                        void* stream) {
  using namespace emox::bwd_d512_sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv) || head_dim <= 128 || head_dim > 256 ||
      head_dim % (dtype == 1 ? 8 : 4) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    const auto a = make_args<__nv_bfloat16>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
    return (int)launch<128, 1, 2, 2>(q, k, v, dout, strides, head_dim, a, batch, s);
  }
  long long st[12];
  const cudaError_t err = split_operands(q, k, v, dout, strides, batch, heads, lq, lk, head_dim, 256, q2, k2, v2, do2,
                                         st, s);
  if (err != cudaSuccess) return (int)err;
  const auto a = make_args<float>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
  return (int)launch<128, 2, 2, 2>(q2, k2, v2, do2, st, 512, a, batch, s);
}

// float32 attention backward at head dim 512, as emox_flash_bwd_d512_sm90 on
// float32 operands (16-byte aligned rows), on a cluster of four blocks of
// 128 columns: q, k, v and dout are split first into q2, k2, v2, do2, bf16
// scratch of [batch, heads, lq or lk, 1024] elements, contiguous.
extern "C" int emox_flash_bwd_d512_f32(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                       const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                       float scale, void* q2, void* k2, void* v2, void* do2, void* stream) {
  using namespace emox::bwd_d512_sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv)) return (int)cudaErrorInvalidValue;
  long long st[12];
  const cudaError_t err = split_operands(q, k, v, dout, strides, batch, heads, lq, lk, 512, 512, q2, k2, v2, do2, st, s);
  if (err != cudaSuccess) return (int)err;
  const auto a = make_args<float>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, 512, scale);
  return (int)launch<128, 2, 4, 2>(q2, k2, v2, do2, st, 1024, a, batch, s);
}
