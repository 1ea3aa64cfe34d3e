// Flash-attention backward for Hopper (sm_90a): wgmma + TMA, bf16, head dim <= 128.
//
// Replaces the TPU kernels `_flash_bwd_nlc_dq_kernel` and
// `_flash_bwd_nlc_dkv_kernel` (emox/ops/attention.py:465,508, the packed
// [N, L, H*D] layout) and `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (:118,160, the [B, H, L, D] layout). From q, k, v, the output gradient dO,
// the forward's log-sum-exp lse and delta = sum_d dO*O per row (both fp32,
// computed outside the kernels as the TPU path computes delta), it returns
//   P = exp(q k^T * scale - lse),  dv = P^T dO,  dS = P (dO v^T - delta),
//   dq = dS k * scale,             dk = dS^T q * scale.
// As in flash_fwd_sm90.cu the operands are [B, H, L, D] with element strides:
// packed tokens are [N, H, L, D] with strides (L*H*D, D, H*D, 1), so both
// layouts take the same kernels with no copy.
//
// What bounds it on the H100: at the 256^2 stage-2 shape (N 16, Lq 1024,
// Lk 2048, H 5, d 64) the function needs 10*N*H*Lq*Lk*d = 107 GFLOP against
// about 34 MB of inputs and outputs: the tensor cores, 0.109 ms at 989
// TFLOP/s (512^2 level 0, Lq 4096, Lk 8192: 1.74 ms).
//
// Design: two kernels, as the TPU kernels are, each shaped like
// flash_fwd_sm90: one producer warp issues every TMA load into a ring of
// stages guarded by mbarriers (full: the bytes arrived; empty: both
// consumers are done with the stage), and two consumer warpgroups own 64 rows
// each, with setmaxnreg moving registers from the producer (24) to them (240).
//   * dq kernel, a block per (128 query rows, head, batch): Q and dO are
//     loaded once, K and V tiles stream through the ring. S = Q K^T and
//     dP = dO V^T run back to back as wgmma with both operands in shared
//     memory (K-major); P and dS are computed on the accumulator registers and
//     dS is rounded to bf16 in the layout of wgmma's register A operand;
//     dQ += dS K reads the same K tile as an MN-major B operand. Keys at or
//     past Lk arrive zero-filled and are masked to P = 0.
//   * dkv kernel, a block per (128 keys, head, batch): K and V are loaded
//     once, tiles of Q and dO (128 rows at d <= 64, 64 at d 128) stream
//     through the ring with their lse and delta (a 1-D bulk copy each: TMA
//     cannot read the packed lse [N, Lq, H], whose row stride is H*4 bytes,
//     so the wrapper hands both as [B, H, Lq_pad] contiguous, padded with
//     lse = +inf and delta = 0 so that rows past Lq give P = 0 and dS = 0;
//     Lq_pad is a multiple of 128, so every tile's slice is 16-byte
//     aligned and never reads past the padding). S^T = K Q^T and
//     dP^T = V dO^T; dV += P^T dO and dK += dS^T Q with P^T and dS^T from
//     registers and dO and Q as MN-major B operands. dK and dV stay in
//     registers (d fp32 a thread at head dim 128).
// Each block owns the rows it writes: no atomics, no fp32 scratch and no
// conversion pass, and the result is the same bits from run to run. The
// price is that both kernels compute S and dP: 14 rather than 10 units of
// N*H*Lq*Lk*d. The head dim pads in shared memory to the 64-column swizzle
// atom (40 -> 64, 80 -> 128; zero columns, out-of-bounds fill, change no
// product); rows not 16-byte aligned are padded by the wrapper first.
// Float32 at head dims <= 128 (emox_flash_bwd_f32_sm90) runs the same two
// kernels on a two-part bf16 split of q, k, v and dO (split.cuh: one launch
// per operand into [B, H, L, 2 DP] scratch, hi | lo), PARTS = 2: every
// product a b is a_hi b_hi + a_hi b_lo + a_lo b_hi with fp32 accumulation, P
// and dS are split in registers as the register A operand, and the
// gradients are stored in float32. The parts double the operand bytes, so
// the tiles are reckoned again: d 64 streams 64-key K/V tiles (dq: Q and dO
// 64 KB, three stages of K and V 96 KB) and 64-row Q/dO tiles (dk/dv), d 128
// 32-key and 32-row tiles in two stages (192 KB each), which keeps dK and dV
// (64 fp32 registers each) beside S^T, dP^T and their split A operands
// within 240 registers. It replaces the 3xTF32 WMMA kernels that took
// float32 before (flash_attn_bwd.cu), which spilled their dk/dv accumulators at 192 and 256.
// What bounds it: at the float32 train step's shape (N 2, Lq 1024, Lk 2048,
// H 5, d 64) the function is 13.4 GFLOP, 0.200 ms at the CUDA cores' 67
// TFLOP/s; it issues 3 x 14 units of N*H*Lq*Lk*d on bf16 wgmma, 56 GFLOP,
// 0.057 ms at 989 TFLOP/s. Head dims 129-256 (both types) run on
// flash_bwd_d512_sm90.cu's cluster pair at half its width.
// Not yet done (later PRs): dq accumulated across key blocks in fp32 (one
// kernel, no recompute), overlap of the elementwise step with the products.
#include "split.cuh"

namespace emox {
namespace bwd_sm90 {

using namespace emox::sm90;

constexpr int kRows = 128;     // rows a block owns (query rows or keys): 64 per consumer warpgroup
constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kLqPad = 128;    // lse and delta come padded to a multiple of this

template <typename TO>
struct Args {
  TO *dq, *dk, *dv;
  const float* lse;    // [B, H, lq_pad]: +inf past lq
  const float* delta;  // [B, H, lq_pad]: 0 past lq
  long long dq_b, dq_h, dq_r, dk_b, dk_h, dk_r, dv_b, dv_h, dv_r;  // element strides (batch, head, row)
  int heads, lq, lk, lq_pad, d;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e): P runs in base 2
};

// One warpgroup's 64 accumulator rows (d[4i + e]: row row_lo (e < 2) or
// row_lo + 8, column 8i + col0 + e % 2), times `mul`, to rows r0 and r0 + 8
// of a strided output of type TO; rows at or past `nrows` and columns at or
// past `d` are dropped.
template <int DP, typename TO>
__device__ __forceinline__ void store_rows(TO* out, long long stride, const float* acc, int r0, int nrows, int col0,
                                           int d, float mul) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + col0;
    if (col < d) {
      if (r0 < nrows) store_pair(out + r0 * stride + col, acc[4 * i] * mul, acc[4 * i + 1] * mul);
      if (r0 + 8 < nrows) store_pair(out + (r0 + 8) * stride + col, acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
  }
}

// ---- dq: a block per 128 query rows; K/V tiles of BN keys stream -------------------
// PARTS: 1 (bf16 operands) or 2 (the hi and lo parts of float32 operands,
// the lo boxes of a tile after its hi ones)
template <int DP, int BN, int STAGES, int PARTS>
struct DqSmem {
  static constexpr int CHUNKS = DP / 64;            // 64-column boxes per row and part
  static constexpr int BOXES = PARTS * CHUNKS;      // boxes per row
  static constexpr uint32_t q_chunk = kRows * 128;  // one box of Q or dO
  static constexpr uint32_t kv_chunk = BN * 128;    // one box of K or V
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_off + BOXES * q_chunk;
  static constexpr uint32_t stage = BOXES * kv_chunk;  // one K (or V) tile
  static constexpr uint32_t k_off = do_off + BOXES * q_chunk;
  static constexpr uint32_t v_off = k_off + STAGES * stage;
  static constexpr uint32_t bar_off = v_off + STAGES * stage;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int DP, int BN, int STAGES, int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DqSmem<DP, BN, STAGES, PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle is a function of address bits 4-9
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + S::bar_off;    // Q and dO arrived
  const uint32_t full0 = q_full + 8;            // full[s]: K and V of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;   // empty[s]: both consumers are done with s
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
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
      mbar_expect_tx(q_full, 2 * S::BOXES * S::q_chunk);
      for (int c = 0; c < S::BOXES; ++c) {
        tma_load_4d(base + S::q_off + c * S::q_chunk, &tq, q_full, c * 64, q0, h, b);
        tma_load_4d(base + S::do_off + c * S::q_chunk, &tdo, q_full, c * 64, q0, h, b);
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
    const int r_lo = q0 + wg * 64 + row_lo;   // < lq_pad: the grid covers ceil(lq / 128) blocks
    const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
    const float lse_lo = args.lse[vec + r_lo] * kLog2e, lse_hi = args.lse[vec + r_lo + 8] * kLog2e;
    const float dl_lo = args.delta[vec + r_lo], dl_hi = args.delta[vec + r_lo + 8];
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    const uint32_t q_tile = base + S::q_off + wg * 64 * 128;
    const uint32_t do_tile = base + S::do_off + wg * 64 * 128;

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t k_tile = base + S::k_off + s * S::stage;
      const uint32_t v_tile = base + S::v_off + s * S::stage;

      // S = Q K^T and dP = dO V^T over the padded head dim, 16 columns a step
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs<BN / 2>(sc);
      fence_regs<BN / 2>(dp);
      wgmma_fence();
      product<BN, S::CHUNKS, PARTS>(sc, q_tile, S::q_chunk, k_tile, S::kv_chunk);
      product<BN, S::CHUNKS, PARTS>(dp, do_tile, S::q_chunk, v_tile, S::kv_chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BN / 2>(sc);
      fence_regs<BN / 2>(dp);

      // P and dS = P (dP - delta) on the accumulators; keys past Lk get P = 0
      const bool ragged = (j + 1) * BN > args.lk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i % 4) < 2;
        float p = prob(sc[i], args.scale_log2, lo ? lse_lo : lse_hi);
        if (ragged && j * BN + 8 * (i / 4) + col0 + (i % 2) >= args.lk) p = 0.f;
        dp[i] = p * (dp[i] - (lo ? dl_lo : dl_hi));
      }
      // dQ += dS K: dS (bf16) is the register A operand (keys 16k..16k+15 are
      // dp[8k..8k+7], in pairs); K is read as an MN-major B operand: keys on
      // rows, head dim contiguous, 64-column boxes BN rows apart
      uint32_t da[BN / 16][4], dl[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) a_operand<PARTS>(dp + 8 * k, da[k], dl[k]);
      fence_regs<DP / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
        rs_product<DP, S::CHUNKS, PARTS>(dq, da[k], dl[k], k_tile + k * 16 * 128, S::kv_chunk);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DP / 2>(dq);
      mbar_arrive(empty0 + 8 * s);
    }
    store_rows<DP>(args.dq + b * args.dq_b + h * args.dq_h, args.dq_r, dq, r_lo, args.lq, col0, args.d,
                   args.scale);
  }
}

// ---- dk, dv: a block per 128 keys; Q/dO tiles of BQ rows stream ---------------------
template <int DP, int BQ, int STAGES, int PARTS>
struct DkvSmem {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int BOXES = PARTS * CHUNKS;
  static constexpr uint32_t kv_chunk = kRows * 128;  // one box of K or V
  static constexpr uint32_t q_chunk = BQ * 128;      // one box of Q or dO
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = k_off + BOXES * kv_chunk;
  static constexpr uint32_t tile = BOXES * q_chunk;  // one Q (or dO) tile
  static constexpr uint32_t q_off = v_off + BOXES * kv_chunk;
  static constexpr uint32_t do_off = q_off + STAGES * tile;
  static constexpr uint32_t vec = BQ * 4;  // one tile's lse (or delta)
  static constexpr uint32_t lse_off = do_off + STAGES * tile;
  static constexpr uint32_t delta_off = lse_off + STAGES * vec;
  static constexpr uint32_t bar_off = delta_off + STAGES * vec;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
  static_assert(kLqPad % BQ == 0, "a Q tile never reads past the lse padding");
};

template <int DP, int BQ, int STAGES, int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DkvSmem<DP, BQ, STAGES, PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  const uint32_t kv_full = base + S::bar_off;  // K and V arrived
  const uint32_t full0 = kv_full + 8;          // full[s]: Q, dO, lse and delta of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int tiles = (args.lq + BQ - 1) / BQ;  // <= lq_pad / BQ

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * S::BOXES * S::kv_chunk);
      for (int c = 0; c < S::BOXES; ++c) {
        tma_load_4d(base + S::k_off + c * S::kv_chunk, &tk, kv_full, c * 64, k0, h, b);
        tma_load_4d(base + S::v_off + c * S::kv_chunk, &tv, kv_full, c * 64, k0, h, b);
      }
      const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * S::tile + 2 * S::vec);
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load_4d(base + S::q_off + s * S::tile + c * S::q_chunk, &tq, full, c * 64, i * BQ, h, b);
          tma_load_4d(base + S::do_off + s * S::tile + c * S::q_chunk, &tdo, full, c * 64, i * BQ, h, b);
        }
        bulk_load(base + S::lse_off + s * S::vec, args.lse + vec + i * BQ, S::vec, full);
        bulk_load(base + S::delta_off + s * S::vec, args.delta + vec + i * BQ, S::vec, full);
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's keys: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and query rows col0, col0 + 1 of every 8
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_tile = base + S::k_off + wg * 64 * 128;
    const uint32_t v_tile = base + S::v_off + wg * 64 * 128;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const uint32_t q_tile = base + S::q_off + s * S::tile;
      const uint32_t do_tile = base + S::do_off + s * S::tile;
      const float* lse = reinterpret_cast<const float*>(gbase + S::lse_off + s * S::vec);
      const float* delta = reinterpret_cast<const float*>(gbase + S::delta_off + s * S::vec);

      // S^T = K Q^T and dP^T = V dO^T: keys on rows, this tile's query rows on columns
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int c = 0; c < BQ / 2; ++c) st[c] = dpt[c] = 0.f;
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);
      wgmma_fence();
      product<BQ, S::CHUNKS, PARTS>(st, k_tile, S::kv_chunk, q_tile, S::q_chunk);
      product<BQ, S::CHUNKS, PARTS>(dpt, v_tile, S::kv_chunk, do_tile, S::q_chunk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);

      // P^T and dS^T = P^T (dP^T - delta), with the lse and delta of each
      // column (query row); rows past Lq have lse = +inf, so P = 0 there.
      // Keys past Lk need no mask: their rows of dk and dv are not stored.
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {  // accumulator pair e, e + 1: query rows col, col + 1
        const int col = 8 * (e / 4) + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta + col);
        st[e] = prob(st[e], args.scale_log2, l2.x * kLog2e);
        st[e + 1] = prob(st[e + 1], args.scale_log2, l2.y * kLog2e);
        dpt[e] = st[e] * (dpt[e] - d2.x);
        dpt[e + 1] = st[e + 1] * (dpt[e + 1] - d2.y);
      }
      uint32_t pa[BQ / 16][4], pl[BQ / 16][4], sa[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
        a_operand<PARTS>(st + 8 * k, pa[k], pl[k]);
        a_operand<PARTS>(dpt + 8 * k, sa[k], sl[k]);
      }
      // dV += P^T dO and dK += dS^T Q: the query rows are the products' depth;
      // dO and Q are MN-major B operands (64-column boxes BQ rows apart)
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
        rs_product<DP, S::CHUNKS, PARTS>(dv, pa[k], pl[k], do_tile + k * 16 * 128, S::q_chunk);
      }
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
        rs_product<DP, S::CHUNKS, PARTS>(dk, sa[k], sl[k], q_tile + k * 16 * 128, S::q_chunk);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      mbar_arrive(empty0 + 8 * s);
    }
    const int r_lo = k0 + wg * 64 + row_lo;
    store_rows<DP>(args.dk + b * args.dk_b + h * args.dk_h, args.dk_r, dk, r_lo, args.lk, col0, args.d,
                   args.scale);
    store_rows<DP>(args.dv + b * args.dv_b + h * args.dv_h, args.dv_r, dv, r_lo, args.lk, col0, args.d, 1.f);
  }
}

// ---- host side ------------------------------------------------------------------
// st: (batch, head, row) element strides of q, k, v, dout; `width`: the maps'
// columns (the head dim in bf16, the scratch's 2 DP in float32); rows_q /
// rows_kv: the box rows of q and dO / of k and v.
template <typename TO>
static bool make_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout,
                      const long long* st, int batch, const Args<TO>& a, int width, int rows_q, int rows_kv) {
  return make_map(&m[0], q, batch, a.heads, a.lq, width, st, rows_q) &&
         make_map(&m[1], dout, batch, a.heads, a.lq, width, st + 9, rows_q) &&
         make_map(&m[2], k, batch, a.heads, a.lk, width, st + 3, rows_kv) &&
         make_map(&m[3], v, batch, a.heads, a.lk, width, st + 6, rows_kv);
}

// DP: the padded head dim; the dq kernel's keys per tile and stages, then the
// dkv kernel's query rows per tile and stages
template <int DP, int BN, int DQ_STAGES, int BQ, int DKV_STAGES, int PARTS, typename TO>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const long long* st,
                          int width, const Args<TO>& a, int batch, cudaStream_t stream) {
  CUtensorMap m[4];
  if (a.dq != nullptr) {
    using S = DqSmem<DP, BN, DQ_STAGES, PARTS>;
    if (!make_maps(m, q, k, v, dout, st, batch, a, width, kRows, BN)) return cudaErrorInvalidValue;
    auto kernel = dq_kernel<DP, BN, DQ_STAGES, PARTS, TO>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.lq + kRows - 1) / kRows, a.heads, batch), kThreads, S::bytes, stream>>>(m[0], m[1], m[2],
                                                                                              m[3], a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.dk == nullptr) return cudaSuccess;
  using S = DkvSmem<DP, BQ, DKV_STAGES, PARTS>;
  if (!make_maps(m, q, k, v, dout, st, batch, a, width, BQ, kRows)) return cudaErrorInvalidValue;
  auto kernel = dkv_kernel<DP, BQ, DKV_STAGES, PARTS, TO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.lk + kRows - 1) / kRows, a.heads, batch), kThreads, S::bytes, stream>>>(m[0], m[1], m[2], m[3],
                                                                                           a);
  return cudaGetLastError();
}

static bool bad_args(int batch, int heads, int lq, int lk, int lq_pad, const void* lse, const void* delta,
                     const void* dk, const void* dv) {
  return batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || lq_pad < lq ||
         lq_pad % kLqPad || (dk == nullptr) != (dv == nullptr) || reinterpret_cast<uintptr_t>(lse) % 16 ||
         reinterpret_cast<uintptr_t>(delta) % 16;
}

template <typename TO>
static Args<TO> make_args(void* dq, void* dk, void* dv, const void* lse, const void* delta, const long long* strides,
                          int heads, int lq, int lk, int lq_pad, int head_dim, float scale) {
  const long long* so = strides + 12;
  return Args<TO>{static_cast<TO*>(dq), static_cast<TO*>(dk), static_cast<TO*>(dv),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  so[0], so[1], so[2], so[3], so[4], so[5], so[6], so[7], so[8],
                  heads, lq, lk, lq_pad, head_dim, scale, scale * kLog2e};
}

}  // namespace bwd_sm90
}  // namespace emox

// bf16 attention backward on [batch, heads, L, head_dim] operands with
// element strides: `strides` holds (batch, head, row) for q, k, v, dout, dq,
// dk and dv in that order (21 values; those of an output not asked for are
// ignored), the head dim contiguous. q, k, v, dout: 16-byte aligned base
// pointers and 16-byte multiples for every stride in bytes; head_dim <= 128
// and a multiple of 8. lse and delta: [batch, heads, lq_pad] float32,
// contiguous, 16-byte aligned, lq_pad a multiple of 128 and >= lq, padded
// with lse = +inf and delta = 0. dq == NULL skips the dq kernel; dk and dv
// are both given (the dkv kernel runs) or both NULL. Returns a cudaError_t
// (0 = launched).
extern "C" int emox_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                   const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                   int head_dim, float scale, void* stream) {
  using namespace emox::bwd_sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv) || head_dim <= 0 || head_dim > 128 ||
      head_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const auto a = make_args<__nv_bfloat16>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
  // tiles chosen on the H100: at d 64 the dkv kernel streams 128-row Q tiles
  // (S^T and dP^T are 64 fp32 registers a thread each); at d 128 dK and dV
  // take 128, so it streams 64-row tiles there
  if (head_dim <= 64) return (int)launch<64, 128, 3, 128, 3, 1>(q, k, v, dout, strides, head_dim, a, batch, s);
  return (int)launch<128, 64, 3, 64, 3, 1>(q, k, v, dout, strides, head_dim, a, batch, s);
}

// float32 attention backward, as emox_flash_bwd_sm90 with float32 q, k, v,
// dout, dq, dk and dv (rows 16-byte aligned) and head_dim <= 128, a multiple
// of 4. q2, k2, v2, do2: bf16 scratch of [batch, heads, lq or lk, 2w]
// elements, contiguous, w = 64 for head_dim <= 64 and 128 above, which this
// call fills with the operands' parts before the kernels read them.
extern "C" int emox_flash_bwd_f32_sm90(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                       const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                       int head_dim, float scale, void* q2, void* k2, void* v2, void* do2,
                                       void* stream) {
  using namespace emox::bwd_sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv) || head_dim <= 0 || head_dim > 128 ||
      head_dim % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int w = head_dim <= 64 ? 64 : 128;
  const void* src[4] = {q, k, v, dout};
  void* parts[4] = {q2, k2, v2, do2};
  const int lens[4] = {lq, lk, lk, lq};
  long long st[12];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = split_operand(src[i], strides + 3 * i, batch, heads, lens[i], head_dim, w, parts[i], s);
    if (err != cudaSuccess) return (int)err;
    scratch_strides(st + 3 * i, heads, lens[i], w);
  }
  const auto a = make_args<float>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
  // both parts double the operand bytes: at d 64 the dq kernel streams
  // 64-key tiles in three stages (160 KB), the dkv kernel 64-row tiles; at d
  // 128 both stream 32-row tiles in two stages (192 KB)
  if (w == 64) return (int)launch<64, 64, 3, 64, 3, 2>(q2, k2, v2, do2, st, 2 * w, a, batch, s);
  return (int)launch<128, 32, 2, 32, 2, 2>(q2, k2, v2, do2, st, 2 * w, a, batch, s);
}
