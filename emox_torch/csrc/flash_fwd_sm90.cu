// Flash-attention forward for Hopper (sm_90a): wgmma + TMA, bf16.
//
// Replaces the TPU kernels `_flash_nlc_kernel` (emox/ops/attention.py:409,
// the packed [N, L, H*D] layout) and `_flash_kernel` (:69, the [B, H, L, D]
// layout): softmax(q k^T * scale) v with the per-row log-sum-exp written in
// fp32 for the backward kernels, as lse [N, Lq, H] (packed) or [B, H, Lq]
// (strided). The two layouts are one function: packed tokens are
// [N, H, L, D] with strides (L*H*D, D, H*D, 1), so one kernel serves both,
// taking element strides for q, k, v, o and lse.
//
// What bounds it on the H100: at the 256^2 serving shape (N 32, Lq 1024,
// Lk 2048, H 5, d 64) it does 4*N*H*Lq*Lk*d = 86 GFLOP against 126 MB of
// input and output, about 680 FLOP per byte: the tensor cores bound it, at
// 0.0869 ms for 989 TFLOP/s. The 512^2 level-0 site (Lq 4096, Lk 8192) is
// 16x that work (1.39 ms), level 1 (C 640, H 10) 0.174 ms.
//
// What the WMMA kernels it replaces (the bf16 paths that flash_attn_nlc.cu
// and flash_attn.cu held before) lost, at 33-48 TFLOP/s, and what this
// design does about it:
//   * they multiplied with WMMA fragments; here S = q k^T runs as wgmma with
//     both operands in shared memory, and O += P v as wgmma with P in
//     registers and V in shared memory (an MN-major operand);
//   * the fp32 scores, the bf16 P and the fp32 output accumulator made a
//     round trip through shared memory on every K/V tile; here the online
//     softmax runs on the wgmma accumulator registers (a thread owns two
//     rows, the four threads of a quad share a row), P is rounded to bf16 in
//     registers in the layout of wgmma's register A operand, and O stays in
//     registers until the epilogue;
//   * the threads copied K/V themselves with no overlap of load and compute;
//     here one producer warp issues TMA loads into a ring of K/V stages
//     guarded by mbarriers (full: the bytes arrived; empty: both consumers
//     are done with the stage), and loads the 128-row Q tile once;
//   * four warps shared a 64-row tile; here two consumer warpgroups own 64
//     query rows each, and setmaxnreg moves registers from the producer
//     warpgroup (24) to them (240): at d 256, O alone is 128 fp32 registers
//     a thread, so d > 128 takes 64-key tiles and d <= 128 128-key tiles.
// TMA does the layout work: the tensor maps are 4-D [d, L, H, B] (innermost
// first) with the caller's strides, boxes of 64 columns (128 bytes, the
// 128-byte swizzle that wgmma's descriptors name) by 128 (Q) or the tile's
// keys (K, V). The d extent is the true head dim, so the padded columns of
// the last box and the keys past Lk of the ragged last tile arrive as zeros
// (out-of-bounds fill); the scores of those keys are masked to -1e30, the
// TPU kernel's _NEG_INF. The head dim pads in shared memory to the swizzle
// atom, a multiple of 64 columns: 40 -> 64, 80 -> 128, 160 -> 192. Zero
// columns change no product, and the scale comes from the true d; the
// padding costs 1.6x the arithmetic at d 40, accepted here (ROADMAP.md).
// Rows whose bytes are not 16-byte aligned (d % 8 != 0) are padded by the
// wrapper before the launch (TMA needs 16-byte global strides).
// Head dim 512 (the VAE's single-head mid-attention) has its own
// kernel below, fwd_wide_kernel: O is split across the two consumer
// warpgroups, which share one 64-row query tile.
// Float32 (emox_flash_fwd_f32_sm90, head dims <= 256, both layouts) runs the
// same two kernels on a two-part bf16 split of q, k and v (split.cuh, one
// launch per operand into scratch of [B, H, L, 2 DP]: hi | lo, zero past d),
// PARTS = 2: every product a b runs as a_hi b_hi + a_hi b_lo + a_lo b_hi on
// bf16 wgmma with fp32 accumulation, P is split in registers, and O is
// stored in float32. It replaces the 3xTF32 WMMA kernel that took
// float32 before (flash_attn.cu), which copied its tiles with the threads and made S, P and
// O round trips through shared memory. What bounds it on the H100: at the
// float32 step's strided shape (N 32, H 8, Lq 1024, Lk 2048, d 40) the
// function is 4*N*H*Lq*Lk*d = 86 GFLOP, 1.28 ms at the CUDA cores' 67
// TFLOP/s; the three bf16 products it issues for each, over the head dim
// padded to 64, are 412 GFLOP, 0.42 ms at 989 TFLOP/s. d <= 64 takes
// 128-key tiles, d <= 128 64-key tiles (Q 64 KB and two stages of K and V
// in both parts: 192 KB), d 129-256 the wide kernel at DP 256 (both parts
// of a 64-row Q tile, one K and one V tile: 192 KB, as bf16 at d 512).
// Not yet done (later PRs): overlap of one warpgroup's softmax with the
// other's products (ping-pong), intra-warpgroup pipelining of S and P v,
// a persistent grid, a TMA store of O.
#include "split.cuh"

namespace emox {
namespace sm90 {

constexpr int kBM = 128;           // query rows per block: 64 per consumer warpgroup
constexpr int kThreads = 384;      // warpgroups 0, 1: consumers; 2: producer
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF

// ---- the kernel -----------------------------------------------------------------
// DP: the head dim padded to a multiple of 64; BN: keys per K/V tile; STAGES:
// K/V tiles in flight; PARTS: 1 (bf16 operands) or 2 (the hi and lo parts of
// float32 operands, hi boxes first).
template <int DP, int BN, int STAGES, int PARTS>
struct Smem {
  static constexpr int CHUNKS = DP / 64;                 // 64-column boxes per row and part
  static constexpr int BOXES = PARTS * CHUNKS;           // boxes per row
  static constexpr uint32_t q_chunk = kBM * 128;         // bytes of one Q box
  static constexpr uint32_t kv_chunk = BN * 128;         // bytes of one K or V box
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_off + BOXES * q_chunk;
  static constexpr uint32_t stage = BOXES * kv_chunk;    // one K (or V) tile
  static constexpr uint32_t v_off = k_off + STAGES * stage;
  static constexpr uint32_t bar_off = v_off + STAGES * stage;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <typename TO>
struct Out {
  TO* o;
  float* lse;
  long long o_b, o_h, o_r;    // element strides of o (batch, head, row)
  long long l_b, l_h, l_r;    // element strides of lse
  int lq, lk, d;
  float scale_log2;           // scale * log2(e): the softmax runs in base 2
};

template <int DP, int BN, int STAGES, int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Out<TO> args) {
  using S = Smem<DP, BN, STAGES, PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle is a function of address bits 4-9
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + S::bar_off;
  const uint32_t full0 = q_full + 8;                 // full[s]: K and V of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;        // empty[s]: both consumers are done with s
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBM;
  const int tiles = (args.lk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      // box c is columns 64c..64c+63: with PARTS 2 the lo boxes follow the hi
      // ones, as in the scratch
      mbar_expect_tx(q_full, S::BOXES * S::q_chunk);
      for (int c = 0; c < S::BOXES; ++c) {
        tma_load_4d(base + S::q_off + c * S::q_chunk, &tq, q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * S::stage);
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load_4d(base + S::k_off + s * S::stage + c * S::kv_chunk, &tk, full, c * 64, j * BN, h, b);
          tma_load_4d(base + S::v_off + s * S::stage + c * S::kv_chunk, &tv, full, c * 64, j * BN, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2) of each row
    float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the running sum
    const uint32_t q_tile = base + S::q_off + wg * 64 * 128;

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t k_tile = base + S::k_off + s * S::stage;
      const uint32_t v_tile = base + S::v_off + s * S::stage;

      // S = q k^T over the padded head dim: 16 columns a step, 4 steps a box
      // (with PARTS 2: q_hi k_hi + q_hi k_lo + q_lo k_hi)
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      fence_regs<BN / 2>(sc);
      wgmma_fence();
      product<BN, S::CHUNKS, PARTS>(sc, q_tile, S::q_chunk, k_tile, S::kv_chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BN / 2>(sc);

      // online softmax in base 2 on the accumulator: sc[4i + e] is row
      // row_lo (e < 2) or row_lo + 8 (e >= 2), column 8i + col0 + e % 2
      const bool ragged = (j + 1) * BN > args.lk;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float v = (ragged && j * BN + 8 * (i / 4) + col0 + (i % 2) >= args.lk) ? kNegInf
                                                                                     : sc[i] * args.scale_log2;
        sc[i] = v;
        if ((i % 4) < 2) mx_lo = fmaxf(mx_lo, v);
        else mx_hi = fmaxf(mx_hi, v);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i % 4) < 2;
        const float p = exp2f(sc[i] - (lo ? mn_lo : mn_hi));
        sc[i] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

      // O += P v: P (bf16) is wgmma's register A operand, whose layout is the
      // accumulator's: keys 16k..16k+15 are sc[8k..8k+7], in pairs (with
      // PARTS 2: P_hi v_hi + P_hi v_lo + P_lo v_hi)
      uint32_t pa[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) a_operand<PARTS>(sc + 8 * k, pa[k], pl[k]);
      fence_regs<DP / 2>(o);
      wgmma_fence();
      // V: keys (the product's depth) on rows, head dim (N) contiguous:
      // MN-major, 64-column boxes BN rows apart, 8-row groups 1024 bytes apart
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) rs_product<DP, S::CHUNKS, PARTS>(o, pa[k], pl[k], v_tile + k * 16 * 128, S::kv_chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DP / 2>(o);
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O / l in the output's type and lse = (m + log2 l) * ln 2, through the strides
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    l_lo = fmaxf(l_lo, 1e-20f);  // as the TPU kernel's l_safe
    l_hi = fmaxf(l_hi, 1e-20f);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const int r_lo = q0 + wg * 64 + row_lo, r_hi = r_lo + 8;
    TO* ob = args.o + b * args.o_b + h * args.o_h;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + col0;
      if (col < args.d) {
        if (r_lo < args.lq) store_pair(ob + r_lo * args.o_r + col, o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
        if (r_hi < args.lq) store_pair(ob + r_hi * args.o_r + col, o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
      }
    }
    if (lane % 4 == 0) {
      float* lb = args.lse + b * args.l_b + h * args.l_h;
      constexpr float kLn2 = 0.6931471805599453f;
      if (r_lo < args.lq) lb[r_lo * args.l_r] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < args.lq) lb[r_hi * args.l_r] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// ---- head dim 512 (bf16: the VAE's single-head mid-attention), and 256 in both parts
// One warpgroup cannot hold O [64, 512] (256 fp32 registers a thread), so a
// block takes one 64-row query tile and both consumer warpgroups share it:
// each computes the same S = q k^T over 64 keys and the same online softmax
// (1.5x the function's arithmetic, traded for no exchange through shared
// memory), and owns one half of O's columns (DP / 4 registers). Q (64 KB), one
// K tile and one V tile (64 KB each) fill 192 KB, at DP 512 in bf16 as at DP
// 256 in both float32 parts; the producer refills K as soon as both S
// products of a tile are done and V as soon as both P v are, so each load
// overlaps the other product.
template <int DP, int PARTS>
struct WideSmem {
  static constexpr int CHUNKS = DP / 64;             // 64-column boxes per row and part
  static constexpr int BOXES = PARTS * CHUNKS;       // boxes per row: hi, then lo
  static constexpr uint32_t chunk = 64 * 128;        // one 64-row box
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = BOXES * chunk;
  static constexpr uint32_t v_off = 2 * BOXES * chunk;
  static constexpr uint32_t bar_off = 3 * BOXES * chunk;
  static constexpr uint32_t bytes = bar_off + 8 * 5 + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int DP, int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Out<TO> args) {
  using S = WideSmem<DP, PARTS>;
  constexpr int HALF = DP / 2;  // O's columns a warpgroup owns
  constexpr int BN = 64;  // keys per tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + S::bar_off;
  const uint32_t k_full = q_full + 8, k_empty = q_full + 16;  // K arrived / both S products done
  const uint32_t v_full = q_full + 24, v_empty = q_full + 32;  // V arrived / both P v done
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * 64;
  const int tiles = (args.lk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 2 * 128);
    mbar_init(v_empty, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, S::BOXES * S::chunk);
      for (int c = 0; c < S::BOXES; ++c) tma_load_4d(base + S::q_off + c * S::chunk, &tq, q_full, c * 64, q0, h, b);
      for (int j = 0; j < tiles; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        mbar_expect_tx(k_full, S::BOXES * S::chunk);
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load_4d(base + S::k_off + c * S::chunk, &tk, k_full, c * 64, j * BN, h, b);
        }
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_full, S::BOXES * S::chunk);
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load_4d(base + S::v_off + c * S::chunk, &tv, v_full, c * 64, j * BN, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    float o[HALF / 2];                        // columns [HALF wg, HALF wg + HALF) of O
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;
    float l_lo = 0.f, l_hi = 0.f;
    const uint32_t q_tile = base + S::q_off, k_tile = base + S::k_off;
    // this warpgroup's boxes of V (hi; the lo ones CHUNKS boxes on)
    const uint32_t v_half = base + S::v_off + wg * (S::CHUNKS / 2) * S::chunk;

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      mbar_wait(k_full, j & 1);
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      fence_regs<BN / 2>(sc);
      wgmma_fence();
      product<BN, S::CHUNKS, PARTS>(sc, q_tile, S::chunk, k_tile, S::chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BN / 2>(sc);
      mbar_arrive(k_empty);

      // the online softmax of fwd_kernel, on the 64 keys of this tile
      const bool ragged = (j + 1) * BN > args.lk;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float v = (ragged && j * BN + 8 * (i / 4) + col0 + (i % 2) >= args.lk) ? kNegInf
                                                                                     : sc[i] * args.scale_log2;
        sc[i] = v;
        if ((i % 4) < 2) mx_lo = fmaxf(mx_lo, v);
        else mx_hi = fmaxf(mx_hi, v);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i % 4) < 2;
        const float p = exp2f(sc[i] - (lo ? mn_lo : mn_hi));
        sc[i] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < HALF / 2; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

      uint32_t pa[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) a_operand<PARTS>(sc + 8 * k, pa[k], pl[k]);
      mbar_wait(v_full, j & 1);
      fence_regs<HALF / 2>(o);
      wgmma_fence();
      // V's half as in fwd_kernel: MN-major, 64-column boxes S::chunk apart
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) rs_product<HALF, S::CHUNKS, PARTS>(o, pa[k], pl[k], v_half + k * 16 * 128, S::chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HALF / 2>(o);
      mbar_arrive(v_empty);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    l_lo = fmaxf(l_lo, 1e-20f);
    l_hi = fmaxf(l_hi, 1e-20f);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const int r_lo = q0 + row_lo, r_hi = r_lo + 8;
    TO* ob = args.o + b * args.o_b + h * args.o_h + wg * HALF;
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      const int col = 8 * i + col0;
      if (wg * HALF + col < args.d) {
        if (r_lo < args.lq) store_pair(ob + r_lo * args.o_r + col, o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
        if (r_hi < args.lq) store_pair(ob + r_hi * args.o_r + col, o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
      }
    }
    if (wg == 0 && lane % 4 == 0) {  // both warpgroups hold the same statistics
      float* lb = args.lse + b * args.l_b + h * args.l_h;
      constexpr float kLn2 = 0.6931471805599453f;
      if (r_lo < args.lq) lb[r_lo * args.l_r] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < args.lq) lb[r_hi * args.l_r] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// ---- host side ------------------------------------------------------------------
// q, k, v as TMA maps of `width` columns (the caller's d for bf16, the
// scratch's 2 DP for float32), Q boxes of `q_rows` rows and K/V boxes of
// `kv_rows`; st: (batch, head, row) element strides of q, k and v.
static bool make_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const long long* st, int batch,
                      int heads, int lq, int lk, int width, int q_rows, int kv_rows) {
  return make_map(&m[0], q, batch, heads, lq, width, st, q_rows) &&
         make_map(&m[1], k, batch, heads, lk, width, st + 3, kv_rows) &&
         make_map(&m[2], v, batch, heads, lk, width, st + 6, kv_rows);
}

template <int DP, int BN, int STAGES, int PARTS, typename TO>
static cudaError_t launch(const void* q, const void* k, const void* v, const long long* st, int width,
                          const Out<TO>& out, int batch, int heads, cudaStream_t stream) {
  using S = Smem<DP, BN, STAGES, PARTS>;
  CUtensorMap m[3];
  if (!make_maps(m, q, k, v, st, batch, heads, out.lq, out.lk, width, kBM, BN)) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<DP, BN, STAGES, PARTS, TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((out.lq + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, S::bytes, stream>>>(m[0], m[1], m[2], out);
  return cudaGetLastError();
}

template <int DP, int PARTS, typename TO>
static cudaError_t launch_wide(const void* q, const void* k, const void* v, const long long* st, int width,
                               const Out<TO>& out, int batch, int heads, cudaStream_t stream) {
  using S = WideSmem<DP, PARTS>;
  CUtensorMap m[3];
  if (!make_maps(m, q, k, v, st, batch, heads, out.lq, out.lk, width, 64, 64)) return cudaErrorInvalidValue;
  auto kernel = fwd_wide_kernel<DP, PARTS, TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((out.lq + 63) / 64, heads, batch);
  kernel<<<grid, kThreads, S::bytes, stream>>>(m[0], m[1], m[2], out);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace emox

// bf16 attention forward on [batch, heads, L, head_dim] operands with element
// strides: `strides` holds (batch, head, row) for q, k, v, o and lse in that
// order (15 values), the head dim contiguous. q, k, v: 16-byte aligned base
// pointers and 16-byte multiples for every stride in bytes; head_dim <= 256
// and even, or 512. lse float32. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const long long* strides, int batch, int heads, int lq, int lk,
                                   int head_dim, float scale, void* stream) {
  using namespace emox::sm90;
  using B16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      head_dim <= 0 || (head_dim > 256 && head_dim != 512) || head_dim % 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* so = strides + 9;
  const long long* sl = strides + 12;
  const Out<B16> out{static_cast<B16*>(o), static_cast<float*>(lse), so[0], so[1], so[2], sl[0], sl[1],
                     sl[2], lq, lk, head_dim, scale * kLog2e};
  const int d = head_dim;
  if (d <= 64) return (int)launch<64, 128, 3, 1>(q, k, v, strides, d, out, batch, heads, s);
  if (d <= 128) return (int)launch<128, 128, 2, 1>(q, k, v, strides, d, out, batch, heads, s);
  if (d <= 192) return (int)launch<192, 64, 2, 1>(q, k, v, strides, d, out, batch, heads, s);
  if (d <= 256) return (int)launch<256, 64, 2, 1>(q, k, v, strides, d, out, batch, heads, s);
  return (int)launch_wide<512, 1>(q, k, v, strides, d, out, batch, heads, s);
}

// The scratch width w of a float32 head dim: each part of a row of q2, k2
// and v2 (hi in columns [0, w), lo in [w, 2w))
static int f32_width(int head_dim) { return head_dim <= 64 ? 64 : head_dim <= 128 ? 128 : 256; }

// float32 attention forward on [batch, heads, L, head_dim] operands with
// element strides, as emox_flash_fwd_sm90 (q, k, v and o float32, 16-byte
// aligned rows), head_dim <= 256 and a multiple of 4. q2, k2, v2: bf16
// scratch of [batch, heads, lq or lk, 2w] elements, contiguous, w = 64 for
// head_dim <= 64, 128 for <= 128, else 256, which this call fills with the
// operands' parts before the attention kernel reads them. Returns a
// cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_f32_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                       const long long* strides, int batch, int heads, int lq, int lk,
                                       int head_dim, float scale, void* q2, void* k2, void* v2, void* stream) {
  using namespace emox::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      head_dim <= 0 || head_dim > 256 || head_dim % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int w = f32_width(head_dim);
  const void* src[3] = {q, k, v};
  void* parts[3] = {q2, k2, v2};
  const int lens[3] = {lq, lk, lk};
  long long st[9];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = split_operand(src[i], strides + 3 * i, batch, heads, lens[i], head_dim, w, parts[i], s);
    if (err != cudaSuccess) return (int)err;
    scratch_strides(st + 3 * i, heads, lens[i], w);
  }
  const long long* so = strides + 9;
  const long long* sl = strides + 12;
  const Out<float> out{static_cast<float*>(o), static_cast<float*>(lse), so[0], so[1], so[2], sl[0], sl[1],
                       sl[2], lq, lk, head_dim, scale * kLog2e};
  if (w == 64) return (int)launch<64, 128, 2, 2>(q2, k2, v2, st, 2 * w, out, batch, heads, s);
  if (w == 128) return (int)launch<128, 64, 2, 2>(q2, k2, v2, st, 2 * w, out, batch, heads, s);
  return (int)launch_wide<256, 2>(q2, k2, v2, st, 2 * w, out, batch, heads, s);
}
