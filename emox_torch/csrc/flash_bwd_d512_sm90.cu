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
#include <cooperative_groups.h>

#include "split.cuh"

namespace emox {
namespace bwd_d512_sm90 {

using namespace emox::sm90;
namespace coop = cooperative_groups;

constexpr int kThreads = 384;              // warpgroups 0, 1: consumers; 2: producer
constexpr int kLqPad = 64;                 // lse and delta come padded to a multiple of this
constexpr uint32_t kBox64 = 64 * 128;      // one 64-row x 64-column bf16 box
constexpr uint32_t kPart = 4 * 128 * 16;   // one warpgroup's [64, 32] fp32 partial, in fragment order

template <typename TO>
struct Args {
  TO *dq, *dk, *dv;
  const float* lse;    // [B, H, lq_pad]: +inf past lq
  const float* delta;  // [B, H, lq_pad]: 0 past lq
  long long dq_b, dq_h, dq_r, dk_b, dk_h, dk_r, dv_b, dv_h, dv_r;  // element strides (batch, head, row)
  int heads, lq, lk, lq_pad;
  int d;             // the true head dim: columns at or past it are not stored
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e): P runs in base 2
};

// A warpgroup's [64, HALF] accumulator (d[4i + e]: row row_lo (e < 2) or
// row_lo + 8, column 8i + col0 + e % 2), times `mul`, to rows r0 and r0 + 8
// of a strided output of type TO whose columns start at `out`; rows at or
// past `nrows` and columns at or past `ncols` are dropped.
template <int HALF, typename TO>
__device__ __forceinline__ void store_rows(TO* out, long long stride, const float* acc, int r0, int nrows, int col0,
                                           int ncols, float mul) {
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) {
    const int col = 8 * i + col0;
    if (col < ncols) {
      if (r0 < nrows) store_pair(out + r0 * stride + col, acc[4 * i] * mul, acc[4 * i + 1] * mul);
      if (r0 + 8 < nrows) store_pair(out + (r0 + 8) * stride + col, acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
  }
}

// HALF: the head-dim columns a block owns (256 at d 512 in bf16, 128 at
// d <= 256 and in float32 at d 512); PARTS: 1 (bf16 operands) or 2 (float32
// as two bf16 parts, each tile's lo boxes CH boxes after its hi ones, the lo
// columns of the scratch CLUSTER HALF after the hi ones); CLUSTER: the blocks
// of a tile, 2 (a pair) or 4 (two rounds of the pair's exchange)
template <int HALF, int PARTS, int CLUSTER>
struct Geometry {
  static constexpr int CH = HALF / 64;                // 64-column boxes a block owns, per part
  static constexpr int BOXES = PARTS * CH;            // boxes of a block's part of a row
  static constexpr int LO = CLUSTER * HALF;           // the lo part's first column in the scratch
  static constexpr int ROUNDS = CLUSTER / 2;          // exchanges a tile: with rank ^ 1, then rank ^ 2
  static constexpr int FREE2 = ROUNDS - 1;            // the second round's `free` barriers (per slot)
  static_assert(CLUSTER == 2 || CLUSTER == 4, "a pair, or two pairs");
};

// ---- dq: a cluster per 64 query rows; 64-key K/V tiles stream -------------------------
template <int HALF, int PARTS, int CLUSTER>
struct DqSmem {
  using G = Geometry<HALF, PARTS, CLUSTER>;
  static constexpr int STAGES = 2;
  static constexpr uint32_t q_off = 0;                         // Q: its boxes of 64 rows
  static constexpr uint32_t do_off = q_off + G::BOXES * kBox64;  // dO
  static constexpr uint32_t stage = 2 * G::BOXES * kBox64;     // K then V
  static constexpr uint32_t ring_off = do_off + G::BOXES * kBox64;
  static constexpr uint32_t xch_off = ring_off + STAGES * stage;  // [warpgroup][S, dP] partials from the peer
  static constexpr uint32_t bar_off = xch_off + 4 * kPart;
  // q_full, full[STAGES], empty[STAGES], in_full[2], out_free[2] (, out_free2[2])
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES + 4 + 2 * G::FREE2) + 1024;  // + alignment slack
  static_assert(128 * (HALF / 8) * 16 <= STAGES * stage, "dQ_1 staging fits the ring");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int HALF, int PARTS, int CLUSTER, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DqSmem<HALF, PARTS, CLUSTER>;
  using G = Geometry<HALF, PARTS, CLUSTER>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  const uint32_t q_full = base + S::bar_off;
  const uint32_t full0 = q_full + 8;                    // full[s]: K and V of stage s arrived
  const uint32_t empty0 = full0 + 8 * S::STAGES;        // empty[s]: both consumers are done with s
  const uint32_t in_full0 = empty0 + 8 * S::STAGES;     // in_full[w]: the partner's warpgroup w sent its partials
  const uint32_t out_free0 = in_full0 + 16;             // out_free[w]: rank ^ 1's warpgroup w read ours
  const uint32_t out_free20 = out_free0 + 16;           // out_free2[w]: rank ^ 2's warpgroup w read ours (CLUSTER 4)
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x / CLUSTER) * 64;
  const int c0 = rank * HALF;  // this block's head-dim columns
  const int tiles = (args.lk + 63) / 64;
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    for (int w = 0; w < 2; ++w) {  // armed for the partner's bytes; one arrival frees
      mbar_init(in_full0 + 8 * w, 1);
      mbar_init(out_free0 + 8 * w, 1);
      if constexpr (G::FREE2) mbar_init(out_free20 + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers exist before any arrives on another's

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      // box c of a tile: hi columns c0 + 64c (c < CH), lo columns LO + c0 + 64 (c - CH)
      mbar_expect_tx(q_full, 2 * G::BOXES * kBox64);
      for (int c = 0; c < G::BOXES; ++c) {
        const int col = (c < G::CH ? 0 : G::LO - HALF) + c0 + 64 * c;
        tma_load_4d(base + S::q_off + c * kBox64, &tq, q_full, col, q0, h, b);
        tma_load_4d(base + S::do_off + c * kBox64, &tdo, q_full, col, q0, h, b);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % S::STAGES;
        if (j >= S::STAGES) mbar_wait(empty0 + 8 * s, ((j / S::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
        mbar_expect_tx(full, S::stage);
        for (int c = 0; c < G::BOXES; ++c) {
          const int col = (c < G::CH ? 0 : G::LO - HALF) + c0 + 64 * c;
          tma_load_4d(st + c * kBox64, &tk, full, col, j * 64, h, b);
          tma_load_4d(st + (G::BOXES + c) * kBox64, &tv, full, col, j * 64, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes keys 32 wg .. 32 wg + 31 of each tile ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    const int r_lo = q0 + row_lo;             // < lq_pad: the grid covers ceil(lq / 64) tiles
    const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
    const float lse_lo = args.lse[vec + r_lo] * kLog2e, lse_hi = args.lse[vec + r_lo + 8] * kLog2e;
    const float dl_lo = args.delta[vec + r_lo], dl_hi = args.delta[vec + r_lo + 8];
    const uint32_t slot = base + S::xch_off + wg * 2 * kPart;  // the peer's partials of this warpgroup's keys
    const uint32_t in_full = in_full0 + 8 * wg, out_free = out_free0 + 8 * wg;
    const uint32_t peer_out_free = map_rank(out_free, peer);
    float dq[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % S::STAGES;
      mbar_wait(full0 + 8 * s, (j / S::STAGES) & 1);
      const uint32_t k_tile = base + S::ring_off + s * S::stage;
      const uint32_t v_tile = k_tile + G::BOXES * kBox64;
      const uint32_t keys = wg * 32 * 128;  // this warpgroup's 32 keys within each box

      // partial S = Q K^T and dP = dO V^T over this block's HALF columns
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      fence_regs<16>(sc);
      fence_regs<16>(dp);
      wgmma_fence();
      product<32, G::CH, PARTS>(sc, base + S::q_off, kBox64, k_tile + keys, kBox64);
      wgmma_commit();  // S's products, then dP's: S goes to the peer while dP's run
      product<32, G::CH, PARTS>(dp, base + S::do_off, kBox64, v_tile + keys, kBox64);
      wgmma_commit();

      // the exchange: our partials into the peer's slot, then theirs from ours
      if (j > 0) mbar_wait_cluster(out_free, (j - 1) & 1);
      if (t == 0) mbar_expect_tx(in_full, 2 * kPart);  // the peer's partials of this tile
      wgmma_wait1();
      fence_regs<16>(sc);
      send_part<16>(slot, in_full, peer, sc, t);
      wgmma_wait0();
      fence_regs<16>(dp);
      send_part<16>(slot + kPart, in_full, peer, dp, t);
      mbar_wait_cluster(in_full, (j * G::ROUNDS) & 1);
      add_part<16>(sc, gbase + (slot - base), t);
      add_part<16>(dp, gbase + (slot - base) + kPart, t);
      warpgroup_sync(wg);
      if constexpr (G::FREE2) {
        // round 2: the pair's sums into rank ^ 2's slot, once it has read its round 1
        const uint32_t far = rank ^ 2;
        if (t == 0) {
          mbar_expect_tx(in_full, 2 * kPart);
          mbar_arrive_cluster(map_rank(out_free20 + 8 * wg, far));
        }
        mbar_wait_cluster(out_free20 + 8 * wg, j & 1);
        send_part<16>(slot, in_full, far, sc, t);
        send_part<16>(slot + kPart, in_full, far, dp, t);
        mbar_wait_cluster(in_full, (j * G::ROUNDS + 1) & 1);
        add_part<16>(sc, gbase + (slot - base), t);
        add_part<16>(dp, gbase + (slot - base) + kPart, t);
        warpgroup_sync(wg);
      }
      if (t == 0) mbar_arrive_cluster(peer_out_free);

      // P and dS = P (dP - delta); keys past Lk get P = 0
      const bool ragged = (j + 1) * 64 > args.lk;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool lo = (i % 4) < 2;
        float p = prob(sc[i], args.scale_log2, lo ? lse_lo : lse_hi);
        if (ragged && j * 64 + wg * 32 + 8 * (i / 4) + col0 + (i % 2) >= args.lk) p = 0.f;
        dp[i] = p * (dp[i] - (lo ? dl_lo : dl_hi));
      }
      uint32_t da[2][4], dl[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) a_operand<PARTS>(dp + 8 * k, da[k], dl[k]);
      // dQ_w += dS K over this warpgroup's keys: K as an MN-major B operand
      // (keys on rows, head dim contiguous, 64-column boxes kBox64 apart)
      fence_regs<HALF / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs_product<HALF, G::CH, PARTS>(dq, da[k], dl[k], k_tile + keys + k * 16 * 128, kBox64);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HALF / 2>(dq);
      mbar_arrive(empty0 + 8 * s);
    }

    // dQ = dQ_0 + dQ_1: warpgroup 1 stages its sum in the ring, now unused
    consumers_sync();
    float4* stage = reinterpret_cast<float4*>(gbase + S::ring_off);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HALF / 8; ++i) {
        stage[i * 128 + t] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HALF / 8; ++i) {
        const float4 p = stage[i * 128 + t];
        dq[4 * i] += p.x;
        dq[4 * i + 1] += p.y;
        dq[4 * i + 2] += p.z;
        dq[4 * i + 3] += p.w;
      }
      store_rows<HALF>(args.dq + b * args.dq_b + h * args.dq_h + c0, args.dq_r, dq, r_lo, args.lq, col0,
                       args.d - c0, args.scale);
    }
  }
  cluster.sync();  // no block leaves while its partner may still arrive on its barriers
}

// ---- dk, dv: a cluster per 64 keys; 64-row Q/dO tiles stream ------------------------------
template <int HALF, int PARTS, int CLUSTER>
struct DkvSmem {
  using G = Geometry<HALF, PARTS, CLUSTER>;
  static constexpr int BQ = 64;  // query rows a streamed tile
  static constexpr int STAGES = 2;
  static constexpr uint32_t box = BQ * 128;               // one BQ-row box of Q or dO
  static constexpr uint32_t part = BQ * 256;              // a warpgroup's [64, BQ] fp32 partial
  static constexpr uint32_t k_off = 0;                    // K: its boxes of 64 rows
  static constexpr uint32_t v_off = k_off + G::BOXES * kBox64;  // V
  static constexpr uint32_t stage = 2 * G::BOXES * box;   // Q then dO
  static constexpr uint32_t ring_off = v_off + G::BOXES * kBox64;
  static constexpr uint32_t vec = BQ * 4;                 // one tile's lse (or delta)
  static constexpr uint32_t vec_off = ring_off + STAGES * stage;
  static constexpr uint32_t xch_off = vec_off + STAGES * 2 * vec;  // S^T from the peer (then P^T), dP^T from the peer
  static constexpr uint32_t bar_off = xch_off + 2 * part;
  // kv_full, full[STAGES], empty[STAGES], in_s, in_dp, free_s, free_dp, p_ready (, free_s2, free_dp2)
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES + 5 + 2 * G::FREE2) + 1024;
  static_assert(kLqPad % BQ == 0, "a Q tile never reads past the lse padding");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int HALF, int PARTS, int CLUSTER, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DkvSmem<HALF, PARTS, CLUSTER>;
  using G = Geometry<HALF, PARTS, CLUSTER>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + S::bar_off;
  const uint32_t full0 = kv_full + 8;              // full[s]: Q, dO, lse and delta of stage s arrived
  const uint32_t empty0 = full0 + 8 * S::STAGES;
  const uint32_t in_s = empty0 + 8 * S::STAGES;    // the peer's warpgroup 0 sent its S^T partial
  const uint32_t in_dp = in_s + 8;                 // the peer's warpgroup 1 sent its dP^T partial
  const uint32_t free_s = in_s + 16;               // the peer's warpgroup 1 read P^T from the slot we sent S^T to
  const uint32_t free_dp = in_s + 24;              // the peer's warpgroup 1 read our dP^T partial
  const uint32_t p_ready = in_s + 32;              // our warpgroup 0 wrote P^T over the peer's S^T partial
  const uint32_t free_s2 = in_s + 40;              // CLUSTER 4: rank ^ 2's warpgroup 0 read its round 1 of S^T
  const uint32_t free_dp2 = in_s + 48;             // CLUSTER 4: rank ^ 2's warpgroup 1 read its round 1 of dP^T
  const uint32_t slot_s = base + S::xch_off, slot_dp = slot_s + S::part;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (blockIdx.x / CLUSTER) * 64;
  const int c0 = rank * HALF;
  const int tiles = (args.lq + BQ - 1) / BQ;  // <= lq_pad / BQ
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    // armed for the peer's bytes; one elected arrival for the rest
    mbar_init(in_s, 1);
    mbar_init(in_dp, 1);
    mbar_init(free_s, 1);
    mbar_init(free_dp, 1);
    mbar_init(p_ready, 1);
    if constexpr (G::FREE2) {
      mbar_init(free_s2, 1);
      mbar_init(free_dp2, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * G::BOXES * kBox64);
      for (int c = 0; c < G::BOXES; ++c) {
        const int col = (c < G::CH ? 0 : G::LO - HALF) + c0 + 64 * c;
        tma_load_4d(base + S::k_off + c * kBox64, &tk, kv_full, col, k0, h, b);
        tma_load_4d(base + S::v_off + c * kBox64, &tv, kv_full, col, k0, h, b);
      }
      const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % S::STAGES;
        if (i >= S::STAGES) mbar_wait(empty0 + 8 * s, ((i / S::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
        mbar_expect_tx(full, S::stage + 2 * S::vec);
        for (int c = 0; c < G::BOXES; ++c) {
          const int col = (c < G::CH ? 0 : G::LO - HALF) + c0 + 64 * c;
          tma_load_4d(st + c * S::box, &tq, full, col, i * BQ, h, b);
          tma_load_4d(st + (G::BOXES + c) * S::box, &tdo, full, col, i * BQ, h, b);
        }
        const uint32_t vs = base + S::vec_off + s * 2 * S::vec;
        bulk_load(vs, args.lse + vec + i * BQ, S::vec, full);
        bulk_load(vs + S::vec, args.delta + vec + i * BQ, S::vec, full);
      }
    }
  } else {
    // ---- consumers: warpgroup 0 owns dV (from P^T), warpgroup 1 dK (from dS^T) ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's keys: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and query rows col0, col0 + 1 of every 8
    float acc[HALF / 2];                      // dV (warpgroup 0) or dK (warpgroup 1), [64, HALF]
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
    const uint32_t a_tile = base + (wg == 0 ? S::k_off : S::v_off);  // S^T = K Q^T, dP^T = V dO^T

    mbar_wait(kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % S::STAGES;
      mbar_wait(full0 + 8 * s, (i / S::STAGES) & 1);
      const uint32_t q_tile = base + S::ring_off + s * S::stage;
      const uint32_t do_tile = q_tile + G::BOXES * S::box;
      const float* lse = reinterpret_cast<const float*>(gbase + S::vec_off + s * 2 * S::vec);
      const float* delta = lse + BQ;

      // this warpgroup's partial: S^T (0) or dP^T (1), keys on rows, the tile's query rows on columns
      const uint32_t b_tile = wg == 0 ? q_tile : do_tile;
      float x[BQ / 2];
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) x[e] = 0.f;
      fence_regs<BQ / 2>(x);
      wgmma_fence();
      product<BQ, G::CH, PARTS>(x, a_tile, kBox64, b_tile, S::box);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BQ / 2>(x);

      // the exchange: warpgroup w sends its partial into the peer's slot w and
      // adds the peer's from its own; warpgroup 0 then writes P^T over the
      // peer's S^T partial for warpgroup 1, which frees the slot once read
      const uint32_t slot = wg == 0 ? slot_s : slot_dp;
      if (i > 0) mbar_wait_cluster(wg == 0 ? free_s : free_dp, (i - 1) & 1);
      if (t == 0) mbar_expect_tx(wg == 0 ? in_s : in_dp, S::part);  // the peer's partial of this tile
      send_part<BQ / 2>(slot, wg == 0 ? in_s : in_dp, peer, x, t);
      mbar_wait_cluster(wg == 0 ? in_s : in_dp, (i * G::ROUNDS) & 1);
      add_part<BQ / 2>(x, gbase + (slot - base), t);  // S^T or dP^T = ours + the peer's (the peer: theirs + ours)
      if constexpr (G::FREE2) {
        // round 2: the pair's sum into rank ^ 2's slot, once it has read its round 1
        const uint32_t far = rank ^ 2, in = wg == 0 ? in_s : in_dp, free2 = wg == 0 ? free_s2 : free_dp2;
        warpgroup_sync(wg);
        if (t == 0) {
          mbar_expect_tx(in, S::part);
          mbar_arrive_cluster(map_rank(free2, far));
        }
        mbar_wait_cluster(free2, i & 1);
        send_part<BQ / 2>(slot, in, far, x, t);
        mbar_wait_cluster(in, (i * G::ROUNDS + 1) & 1);
        add_part<BQ / 2>(x, gbase + (slot - base), t);  // (ours + rank ^ 1's) + (rank ^ 2's + rank ^ 3's)
      }

      // P^T (warpgroup 0) or dS^T (warpgroup 1) as the register A operand (lo: its split's second part)
      uint32_t frag[BQ / 16][4], lo[BQ / 16][4];
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < BQ / 2; e += 2) {  // accumulator pair e, e + 1: query rows col, col + 1
          const int col = 8 * (e / 4) + col0;
          const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
          x[e] = prob(x[e], args.scale_log2, l2.x * kLog2e);
          x[e + 1] = prob(x[e + 1], args.scale_log2, l2.y * kLog2e);
        }
        store_part<BQ / 2>(gbase + (slot_s - base), x, t);
        warpgroup_sync(wg);
        if (t == 0) mbar_arrive(p_ready);
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) a_operand<PARTS>(x + 8 * k, frag[k], lo[k]);
      } else {
        mbar_wait(p_ready, i & 1);
        float p[BQ / 2];
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) p[e] = 0.f;
        add_part<BQ / 2>(p, gbase + (slot_s - base), t);
        warpgroup_sync(wg);
        if (t == 0) {
          mbar_arrive_cluster(map_rank(free_s, peer));
          mbar_arrive_cluster(map_rank(free_dp, peer));
        }
#pragma unroll
        for (int e = 0; e < BQ / 2; e += 2) {
          const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * (e / 4) + col0);
          x[e] = p[e] * (x[e] - d2.x);
          x[e + 1] = p[e + 1] * (x[e + 1] - d2.y);
        }
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) a_operand<PARTS>(x + 8 * k, frag[k], lo[k]);
      }
      // dV += P^T dO (0) or dK += dS^T Q (1): the tile's query rows are the
      // depth; dO and Q are MN-major B operands (64-column boxes S::box apart)
      const uint32_t rhs = wg == 0 ? do_tile : q_tile;
      fence_regs<HALF / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) rs_product<HALF, G::CH, PARTS>(acc, frag[k], lo[k], rhs + k * 16 * 128, S::box);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HALF / 2>(acc);
      mbar_arrive(empty0 + 8 * s);
    }
    const int r_lo = k0 + row_lo;
    if (wg == 0) {
      store_rows<HALF>(args.dv + b * args.dv_b + h * args.dv_h + c0, args.dv_r, acc, r_lo, args.lk, col0,
                       args.d - c0, 1.f);
    } else {
      store_rows<HALF>(args.dk + b * args.dk_b + h * args.dk_h + c0, args.dk_r, acc, r_lo, args.lk, col0,
                       args.d - c0, args.scale);
    }
  }
  cluster.sync();
}

// ---- host side ------------------------------------------------------------------
template <int CLUSTER, typename Kernel, typename TO>
static cudaError_t launch_pairs(Kernel kernel, uint32_t smem, int tiles, int heads, int batch, const CUtensorMap* m,
                                const Args<TO>& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * tiles, heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Both kernels on q, dO, k and v as TMA maps of `width` columns and 64-row
// boxes (st: their (batch, head, row) element strides, in the order q, k, v, dout)
template <int HALF, int PARTS, int CLUSTER, typename TO>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const long long* st,
                          int width, const Args<TO>& a, int batch, cudaStream_t stream) {
  using Dq = DqSmem<HALF, PARTS, CLUSTER>;
  using Dkv = DkvSmem<HALF, PARTS, CLUSTER>;
  static_assert(Dkv::BQ == 64, "the dk/dv kernel's Q and dO tiles are the maps' boxes");
  CUtensorMap m[4];
  if (!make_map(&m[0], q, batch, a.heads, a.lq, width, st, 64) ||
      !make_map(&m[1], dout, batch, a.heads, a.lq, width, st + 9, 64) ||
      !make_map(&m[2], k, batch, a.heads, a.lk, width, st + 3, 64) ||
      !make_map(&m[3], v, batch, a.heads, a.lk, width, st + 6, 64)) {
    return cudaErrorInvalidValue;
  }
  if (a.dq != nullptr) {
    const cudaError_t err = launch_pairs<CLUSTER>(dq_kernel<HALF, PARTS, CLUSTER, TO>, Dq::bytes, (a.lq + 63) / 64,
                                                  a.heads, batch, m, a, stream);
    if (err != cudaSuccess) return err;
  }
  if (a.dk != nullptr) {
    return launch_pairs<CLUSTER>(dkv_kernel<HALF, PARTS, CLUSTER, TO>, Dkv::bytes, (a.lk + 63) / 64, a.heads,
                                 batch, m, a, stream);
  }
  return cudaSuccess;
}

static bool bad_args(int batch, int heads, int lq, int lk, int lq_pad, const void* lse, const void* delta,
                     const void* dk, const void* dv) {
  return batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || lq_pad < lq ||
         lq_pad % kLqPad || lq_pad >= lq + kLqPad || (dk == nullptr) != (dv == nullptr) ||
         reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16;
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

// The parts of q, k, v and dout (float32, head_dim columns) into their
// scratch [batch, heads, L, 2w]; st: the scratch's element strides, in the
// order q, k, v, dout.
static cudaError_t split_operands(const void* q, const void* k, const void* v, const void* dout,
                                  const long long* strides, int batch, int heads, int lq, int lk, int head_dim, int w,
                                  void* q2, void* k2, void* v2, void* do2, long long* st, cudaStream_t s) {
  const void* src[4] = {q, k, v, dout};
  void* parts[4] = {q2, k2, v2, do2};
  const int lens[4] = {lq, lk, lk, lq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = split_operand(src[i], strides + 3 * i, batch, heads, lens[i], head_dim, w, parts[i], s);
    if (err != cudaSuccess) return err;
    scratch_strides(st + 3 * i, heads, lens[i], w);
  }
  return cudaSuccess;
}

}  // namespace bwd_d512_sm90
}  // namespace emox

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
  return (int)launch<256, 1, 2>(q, k, v, dout, strides, 512, a, batch, static_cast<cudaStream_t>(stream));
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
    return (int)launch<128, 1, 2>(q, k, v, dout, strides, head_dim, a, batch, s);
  }
  long long st[12];
  const cudaError_t err = split_operands(q, k, v, dout, strides, batch, heads, lq, lk, head_dim, 256, q2, k2, v2, do2,
                                         st, s);
  if (err != cudaSuccess) return (int)err;
  const auto a = make_args<float>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
  return (int)launch<128, 2, 2>(q2, k2, v2, do2, st, 512, a, batch, s);
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
  return (int)launch<128, 2, 4>(q2, k2, v2, do2, st, 1024, a, batch, s);
}
