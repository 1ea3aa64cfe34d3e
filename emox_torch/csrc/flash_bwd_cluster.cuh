// The cluster kernels of the flash-attention backward for Hopper (sm_90a):
// wgmma + TMA, the head dim split over the blocks of a cluster, which sum
// their S and dP partials through distributed shared memory. Shared by
// flash_bwd_d512_sm90.cu (head dims 129-512: a pair of blocks a tile, or four
// in float32 at 512; its notes give the design) and flash_bwd_wide_sm90.cu
// (head dims above 512: CLUSTER 0, the plan's cluster at run time: 2, 4 or
// 8 slices, and the streamed dimension in one or two parts).
//
// Up to eight slices: the partials are summed in log2(slices) butterfly
// rounds, round r with rank ^ (1 << r) into the same slot, so every rank
// holds ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)) in the same bits
// (IEEE addition is commutative: each round adds the same two values in
// either order). A slot takes round r from rank ^ (1 << r), so each round
// has its own `free` arrival: the receiver frees its slot to the next
// round's sender once it has read this round, and to rank ^ 1 (for the
// next tile) once it has read the last round.
// Two parts of the streamed dimension (the keys in dq, the query rows in
// dk/dv) on small grids: the cluster's ranks [0, cs) and [cs, 2 cs) each
// stream one half of the tiles, with their own exchange. At the end part 1's
// accumulators (dQ; dV and dK) go into part 0's shared memory, once part 0
// has freed it, by st.async counted on a merge barrier; part 0 adds them to
// its own and stores. a + b == b + a: the same bits whichever part merged.
#pragma once

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
  // CLUSTER 0: the plan's slices a tile (2, 4 or 8) and the parts of the
  // streamed dimension (1 or 2) of the dq and dk/dv kernels
  int cs = 0, dq_parts = 1, dkv_parts = 1;
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

// acc += A B over one 16-deep step into a [64, HALF] accumulator (rs_product;
// N of one wgmma is at most 256, so HALF 320 runs as 192 + 128 columns)
template <int HALF, int CH, int PARTS>
__device__ __forceinline__ void rs_half(float* acc, const uint32_t* ah, const uint32_t* al, uint32_t b, uint32_t box) {
  if constexpr (HALF > 256) {
    rs_product<192, CH, PARTS>(acc, ah, al, b, box);
    rs_product<HALF - 192, CH, PARTS>(acc + 96, ah, al, b + 3 * box, box);
  } else {
    rs_product<HALF, CH, PARTS>(acc, ah, al, b, box);
  }
}

// HALF: the head-dim columns a block owns (256 at d 512 in bf16, 128 at
// d <= 256 and in float32 at d 512; above 512 192, 256 or 320); PARTS: 1
// (bf16 operands) or 2 (float32 as two bf16 parts, each tile's lo boxes CH
// boxes after its hi ones, the lo columns of the scratch cs HALF after the
// hi ones); CLUSTER: the blocks of a tile, 2 (a pair) or 4 (two rounds of
// the pair's exchange), or 0 (the plan's, Args::cs and the parts, at run
// time: room for three rounds and the merge of two parts)
template <int HALF, int PARTS, int CLUSTER>
struct Geometry {
  static constexpr int CH = HALF / 64;                // 64-column boxes a block owns, per part
  static constexpr int BOXES = PARTS * CH;            // boxes of a block's part of a row
  static constexpr bool WIDE = CLUSTER == 0;
  static constexpr int ROUNDS = CLUSTER == 2 ? 1 : CLUSTER == 4 ? 2 : 3;  // the most exchanges a tile
  static constexpr int FREE2 = ROUNDS - 1;            // the later rounds' `free` barriers (two each)
  static_assert(CLUSTER == 0 || CLUSTER == 2 || CLUSTER == 4, "a pair, two pairs, or the plan's cluster");
};

// A block's place in its cluster: slices cs, exchange rounds, its part of
// the streamed dimension (of `parts`), the first column it owns and the
// first column of the scratch's lo part
struct Place {
  int cs, rounds, part, c0, lo;
};

template <int HALF, int CLUSTER>
__device__ __forceinline__ Place place(uint32_t rank, int cs_arg) {
  if constexpr (CLUSTER != 0) {
    return Place{CLUSTER, CLUSTER / 2, 0, (int)rank * HALF, CLUSTER * HALF};
  } else {
    const int cs = cs_arg;
    return Place{cs, cs == 2 ? 1 : cs == 4 ? 2 : 3, (int)rank / cs, ((int)rank % cs) * HALF, cs * HALF};
  }
}

// ---- dq: a cluster per 64 query rows; 64-key K/V tiles stream -------------------------
template <int HALF, int PARTS, int CLUSTER, int STAGES>
struct DqSmem {
  using G = Geometry<HALF, PARTS, CLUSTER>;
  static constexpr uint32_t q_off = 0;                         // Q: its boxes of 64 rows
  static constexpr uint32_t do_off = q_off + G::BOXES * kBox64;  // dO
  static constexpr uint32_t stage = 2 * G::BOXES * kBox64;     // K then V
  static constexpr uint32_t ring_off = do_off + G::BOXES * kBox64;
  static constexpr uint32_t xch_off = ring_off + STAGES * stage;  // [warpgroup][S, dP] partials from the peer
  static constexpr uint32_t bar_off = xch_off + 4 * kPart;
  // q_full, full[STAGES], empty[STAGES], in_full[2], out_free[2], out_free2[FREE2][2]
  // (, merge_ready, merge_full)
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES + 4 + 2 * G::FREE2 + (G::WIDE ? 2 : 0)) + 1024;
  static_assert(128 * (HALF / 8) * 16 <= STAGES * stage, "dQ_1 staging fits the ring");
  static_assert(128 * (HALF / 8) * 16 <= ring_off, "the other part's dQ fits Q and dO");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int HALF, int PARTS, int CLUSTER, int STAGES, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DqSmem<HALF, PARTS, CLUSTER, STAGES>;
  using G = Geometry<HALF, PARTS, CLUSTER>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  const uint32_t q_full = base + S::bar_off;
  const uint32_t full0 = q_full + 8;                    // full[s]: K and V of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;           // empty[s]: both consumers are done with s
  const uint32_t in_full0 = empty0 + 8 * STAGES;        // in_full[w]: the partner's warpgroup w sent its partials
  const uint32_t out_free0 = in_full0 + 16;             // out_free[w]: rank ^ 1's warpgroup w read ours
  const uint32_t out_free20 = out_free0 + 16;           // out_free2[r - 1][w]: rank ^ (1 << r)'s warpgroup w read ours
  const uint32_t merge_ready = out_free20 + 16 * G::FREE2;  // part 0's Q and dO are free for part 1's dQ
  const uint32_t merge_full = merge_ready + 8;              // part 1's dQ arrived
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int parts = G::WIDE ? args.dq_parts : 1;
  const Place pl = place<HALF, CLUSTER>(rank, args.cs);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x / (pl.cs * parts)) * 64;
  const int c0 = pl.c0;  // this block's head-dim columns
  const int all = (args.lk + 63) / 64, per = (all + parts - 1) / parts;
  const int j0 = pl.part * per, tiles = min(all, j0 + per) - j0;  // this part's 64-key tiles
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    for (int w = 0; w < 2; ++w) {  // armed for the partner's bytes; one arrival frees
      mbar_init(in_full0 + 8 * w, 1);
      mbar_init(out_free0 + 8 * w, 1);
      for (int r = 0; r < G::FREE2; ++r) mbar_init(out_free20 + 16 * r + 8 * w, 1);
    }
    if constexpr (G::WIDE) {
      mbar_init(merge_ready, 1);
      mbar_init(merge_full, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers exist before any arrives on another's

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      // box c of a tile: hi columns c0 + 64c (c < CH), lo columns lo + c0 + 64 (c - CH)
      mbar_expect_tx(q_full, 2 * G::BOXES * kBox64);
      for (int c = 0; c < G::BOXES; ++c) {
        const int col = (c < G::CH ? 0 : pl.lo - HALF) + c0 + 64 * c;
        tma_load_4d(base + S::q_off + c * kBox64, &tq, q_full, col, q0, h, b);
        tma_load_4d(base + S::do_off + c * kBox64, &tdo, q_full, col, q0, h, b);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
        mbar_expect_tx(full, S::stage);
#pragma unroll 1  // the producer has 24 registers: no column hoisted out of the tile loop
        for (int c = 0; c < G::BOXES; ++c) {
          const int col = (c < G::CH ? 0 : pl.lo - HALF) + c0 + 64 * c;
          tma_load_4d(st + c * kBox64, &tk, full, col, (j0 + j) * 64, h, b);
          tma_load_4d(st + (G::BOXES + c) * kBox64, &tv, full, col, (j0 + j) * 64, h, b);
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
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
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
      mbar_wait_cluster(in_full, (j * pl.rounds) & 1);
      add_part<16>(sc, gbase + (slot - base), t);
      add_part<16>(dp, gbase + (slot - base) + kPart, t);
      warpgroup_sync(wg);
      for (int r = 1; r < pl.rounds; ++r) {
        // round r: the sums so far into rank ^ (1 << r)'s slot, once it has read its round r - 1
        const uint32_t far = rank ^ (1u << r), free2 = out_free20 + 16 * (r - 1) + 8 * wg;
        if (t == 0) {
          mbar_expect_tx(in_full, 2 * kPart);
          mbar_arrive_cluster(map_rank(free2, far));
        }
        mbar_wait_cluster(free2, j & 1);
        send_part<16>(slot, in_full, far, sc, t);
        send_part<16>(slot + kPart, in_full, far, dp, t);
        mbar_wait_cluster(in_full, (j * pl.rounds + r) & 1);
        add_part<16>(sc, gbase + (slot - base), t);
        add_part<16>(dp, gbase + (slot - base) + kPart, t);
        warpgroup_sync(wg);
      }
      if (t == 0) mbar_arrive_cluster(peer_out_free);

      // P and dS = P (dP - delta); keys past Lk get P = 0
      const int key0 = (j0 + j) * 64;
      const bool ragged = key0 + 64 > args.lk;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool lo = (i % 4) < 2;
        float p = prob(sc[i], args.scale_log2, lo ? lse_lo : lse_hi);
        if (ragged && key0 + wg * 32 + 8 * (i / 4) + col0 + (i % 2) >= args.lk) p = 0.f;
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
      for (int k = 0; k < 2; ++k) rs_half<HALF, G::CH, PARTS>(dq, da[k], dl[k], k_tile + keys + k * 16 * 128, kBox64);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HALF / 2>(dq);
      mbar_arrive(empty0 + 8 * s);
    }

    // dQ = dQ_0 + dQ_1: warpgroup 1 stages its sum in the ring, now unused;
    // with two parts of the keys, part 1's dQ then goes into part 0's Q and dO
    consumers_sync();
    if (G::WIDE && parts == 2 && pl.part == 0 && threadIdx.x == 0) {
      mbar_arrive_cluster(map_rank(merge_ready, rank + pl.cs));
    }
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
      if (G::WIDE && parts == 2) {
        if (pl.part == 1) {
          mbar_wait_cluster(merge_ready, 0);
          send_part<HALF / 2>(base + S::q_off, merge_full, rank - pl.cs, dq, t);
        } else {
          if (t == 0) mbar_expect_tx(merge_full, 128 * (HALF / 8) * 16);
          mbar_wait_cluster(merge_full, 0);
          add_part<HALF / 2>(dq, gbase + S::q_off, t);
        }
      }
      if (pl.part == 0) {
        store_rows<HALF>(args.dq + b * args.dq_b + h * args.dq_h + c0, args.dq_r, dq, r_lo, args.lq, col0,
                         args.d - c0, args.scale);
      }
    }
  }
  cluster.sync();  // no block leaves while its partner may still arrive on its barriers
}

// ---- dk, dv: a cluster per 64 keys; 64-row Q/dO tiles stream ------------------------------
template <int HALF, int PARTS, int CLUSTER, int STAGES>
struct DkvSmem {
  using G = Geometry<HALF, PARTS, CLUSTER>;
  static constexpr int BQ = 64;  // query rows a streamed tile
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
  // kv_full, full[STAGES], empty[STAGES], in_s, in_dp, free_s, free_dp, p_ready, free2[FREE2][s, dp]
  // (, merge_ready, merge_v, merge_k)
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES + 5 + 2 * G::FREE2 + (G::WIDE ? 3 : 0)) + 1024;
  static_assert(kLqPad % BQ == 0, "a Q tile never reads past the lse padding");
  static_assert(128 * (HALF / 8) * 16 <= ring_off && 128 * (HALF / 8) * 16 <= STAGES * stage,
                "the other part's dV fits K and V, its dK the ring");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int HALF, int PARTS, int CLUSTER, int STAGES, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DkvSmem<HALF, PARTS, CLUSTER, STAGES>;
  using G = Geometry<HALF, PARTS, CLUSTER>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + S::bar_off;
  const uint32_t full0 = kv_full + 8;              // full[s]: Q, dO, lse and delta of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t in_s = empty0 + 8 * STAGES;       // the peer's warpgroup 0 sent its S^T partial
  const uint32_t in_dp = in_s + 8;                 // the peer's warpgroup 1 sent its dP^T partial
  const uint32_t free_s = in_s + 16;               // the peer's warpgroup 1 read P^T from the slot we sent S^T to
  const uint32_t free_dp = in_s + 24;              // the peer's warpgroup 1 read our dP^T partial
  const uint32_t p_ready = in_s + 32;              // our warpgroup 0 wrote P^T over the peer's S^T partial
  const uint32_t free20 = in_s + 40;               // free2[r - 1][w]: rank ^ (1 << r)'s warpgroup w read its round r - 1
  const uint32_t merge_ready = free20 + 16 * G::FREE2;  // part 0's K, V and ring are free for part 1's dV and dK
  const uint32_t merge0 = merge_ready + 8;              // merge[w]: part 1's dV (0) or dK (1) arrived
  const uint32_t slot_s = base + S::xch_off, slot_dp = slot_s + S::part;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int parts = G::WIDE ? args.dkv_parts : 1;
  const Place pl = place<HALF, CLUSTER>(rank, args.cs);
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (blockIdx.x / (pl.cs * parts)) * 64;
  const int c0 = pl.c0;
  const int all = (args.lq + BQ - 1) / BQ, per = (all + parts - 1) / parts;  // all <= lq_pad / BQ
  const int i0 = pl.part * per, tiles = min(all, i0 + per) - i0;          // this part's query tiles
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    // armed for the peer's bytes; one elected arrival for the rest
    mbar_init(in_s, 1);
    mbar_init(in_dp, 1);
    mbar_init(free_s, 1);
    mbar_init(free_dp, 1);
    mbar_init(p_ready, 1);
    for (int r = 0; r < 2 * G::FREE2; ++r) mbar_init(free20 + 8 * r, 1);
    if constexpr (G::WIDE) {
      for (int r = 0; r < 3; ++r) mbar_init(merge_ready + 8 * r, 1);
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
        const int col = (c < G::CH ? 0 : pl.lo - HALF) + c0 + 64 * c;
        tma_load_4d(base + S::k_off + c * kBox64, &tk, kv_full, col, k0, h, b);
        tma_load_4d(base + S::v_off + c * kBox64, &tv, kv_full, col, k0, h, b);
      }
      const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
        mbar_expect_tx(full, S::stage + 2 * S::vec);
#pragma unroll 1  // the producer has 24 registers: no column hoisted out of the tile loop
        for (int c = 0; c < G::BOXES; ++c) {
          const int col = (c < G::CH ? 0 : pl.lo - HALF) + c0 + 64 * c;
          tma_load_4d(st + c * S::box, &tq, full, col, (i0 + i) * BQ, h, b);
          tma_load_4d(st + (G::BOXES + c) * S::box, &tdo, full, col, (i0 + i) * BQ, h, b);
        }
        const uint32_t vs = base + S::vec_off + s * 2 * S::vec;
        bulk_load(vs, args.lse + vec + (i0 + i) * BQ, S::vec, full);
        bulk_load(vs + S::vec, args.delta + vec + (i0 + i) * BQ, S::vec, full);
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
      const int s = i % STAGES;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
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
      const uint32_t in = wg == 0 ? in_s : in_dp;
      if (i > 0) mbar_wait_cluster(wg == 0 ? free_s : free_dp, (i - 1) & 1);
      if (t == 0) mbar_expect_tx(in, S::part);  // the peer's partial of this tile
      send_part<BQ / 2>(slot, in, peer, x, t);
      mbar_wait_cluster(in, (i * pl.rounds) & 1);
      add_part<BQ / 2>(x, gbase + (slot - base), t);  // S^T or dP^T = ours + the peer's (the peer: theirs + ours)
      for (int r = 1; r < pl.rounds; ++r) {
        // round r: the sums so far into rank ^ (1 << r)'s slot, once it has read its round r - 1
        const uint32_t far = rank ^ (1u << r), free2 = free20 + 16 * (r - 1) + 8 * wg;
        warpgroup_sync(wg);
        if (t == 0) {
          mbar_expect_tx(in, S::part);
          mbar_arrive_cluster(map_rank(free2, far));
        }
        mbar_wait_cluster(free2, i & 1);
        send_part<BQ / 2>(slot, in, far, x, t);
        mbar_wait_cluster(in, (i * pl.rounds + r) & 1);
        add_part<BQ / 2>(x, gbase + (slot - base), t);  // the same sum in every rank of the part
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
        // dS^T = P^T (dP^T - delta), P^T read from the slot warpgroup 0 wrote
        mbar_wait(p_ready, i & 1);
        const uint8_t* pt = gbase + (slot_s - base);
#pragma unroll
        for (int e = 0; e < BQ / 2; e += 4) {
          const float4 p = *reinterpret_cast<const float4*>(pt + ((e / 4) * 128 + t) * 16);
          const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * (e / 4) + col0);
          x[e] = p.x * (x[e] - d2.x);
          x[e + 1] = p.y * (x[e + 1] - d2.y);
          x[e + 2] = p.z * (x[e + 2] - d2.x);
          x[e + 3] = p.w * (x[e + 3] - d2.y);
        }
        warpgroup_sync(wg);
        if (t == 0) {
          mbar_arrive_cluster(map_rank(free_s, peer));
          mbar_arrive_cluster(map_rank(free_dp, peer));
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
      for (int k = 0; k < BQ / 16; ++k) rs_half<HALF, G::CH, PARTS>(acc, frag[k], lo[k], rhs + k * 16 * 128, S::box);
      wgmma_commit();
      wgmma_wait0();
      fence_regs<HALF / 2>(acc);
      mbar_arrive(empty0 + 8 * s);
    }
    if (G::WIDE && parts == 2) {
      // part 1's dV and dK into part 0's K and V (dV) and ring (dK), once part 0 is done with them
      const uint32_t buf = base + (wg == 0 ? S::k_off : S::ring_off), merge = merge0 + 8 * wg;
      consumers_sync();
      if (pl.part == 0) {
        if (threadIdx.x == 0) mbar_arrive_cluster(map_rank(merge_ready, rank + pl.cs));
        if (t == 0) mbar_expect_tx(merge, 128 * (HALF / 8) * 16);
        mbar_wait_cluster(merge, 0);
        add_part<HALF / 2>(acc, gbase + (buf - base), t);
      } else {
        mbar_wait_cluster(merge_ready, 0);
        send_part<HALF / 2>(buf, merge, rank - pl.cs, acc, t);
      }
    }
    if (pl.part == 0) {
      const int r_lo = k0 + row_lo;
      if (wg == 0) {
        store_rows<HALF>(args.dv + b * args.dv_b + h * args.dv_h + c0, args.dv_r, acc, r_lo, args.lk, col0,
                         args.d - c0, 1.f);
      } else {
        store_rows<HALF>(args.dk + b * args.dk_b + h * args.dk_h + c0, args.dk_r, acc, r_lo, args.lk, col0,
                         args.d - c0, args.scale);
      }
    }
  }
  cluster.sync();
}

// ---- host side ------------------------------------------------------------------
template <typename Kernel, typename TO>
static cudaError_t launch_pairs(Kernel kernel, uint32_t smem, int cluster, int tiles, int heads, int batch,
                                const CUtensorMap* m, const Args<TO>& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * tiles, heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A second stream for the dq kernel, and the events that fork it from and
// join it to the caller's stream (fork.stream null: one stream)
struct Fork {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

// Both kernels on q, dO, k and v as TMA maps of `width` columns and 64-row
// boxes (st: their (batch, head, row) element strides, in the order q, k, v,
// dout); CLUSTER 0 takes its cluster from a (cs slices times each kernel's
// parts of the streamed dimension). With a second stream (side) the dq
// kernel runs on it, beside the dk/dv kernel, which reads the same inputs
// and writes other outputs: the two grids share the card's SMs.
template <int HALF, int PARTS, int CLUSTER, int STAGES, typename TO>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const long long* st,
                          int width, const Args<TO>& a, int batch, cudaStream_t stream, const Fork& side = Fork{}) {
  using Dq = DqSmem<HALF, PARTS, CLUSTER, STAGES>;
  using Dkv = DkvSmem<HALF, PARTS, CLUSTER, STAGES>;
  static_assert(Dkv::BQ == 64, "the dk/dv kernel's Q and dO tiles are the maps' boxes");
  CUtensorMap m[4];
  if (!make_map(&m[0], q, batch, a.heads, a.lq, width, st, 64) ||
      !make_map(&m[1], dout, batch, a.heads, a.lq, width, st + 9, 64) ||
      !make_map(&m[2], k, batch, a.heads, a.lk, width, st + 3, 64) ||
      !make_map(&m[3], v, batch, a.heads, a.lk, width, st + 6, 64)) {
    return cudaErrorInvalidValue;
  }
  const bool two = side.stream != nullptr && a.dq != nullptr && a.dk != nullptr;
  cudaError_t err = cudaSuccess;
  if (two && ((err = cudaEventRecord(side.fork, stream)) != cudaSuccess ||
              (err = cudaStreamWaitEvent(side.stream, side.fork, 0)) != cudaSuccess)) {
    return err;
  }
  if (a.dq != nullptr) {
    const int cluster = CLUSTER ? CLUSTER : a.cs * a.dq_parts;
    err = launch_pairs(dq_kernel<HALF, PARTS, CLUSTER, STAGES, TO>, Dq::bytes, cluster, (a.lq + 63) / 64, a.heads,
                       batch, m, a, two ? side.stream : stream);
    if (err != cudaSuccess) return err;
  }
  if (a.dk != nullptr) {
    const int cluster = CLUSTER ? CLUSTER : a.cs * a.dkv_parts;
    err = launch_pairs(dkv_kernel<HALF, PARTS, CLUSTER, STAGES, TO>, Dkv::bytes, cluster, (a.lk + 63) / 64,
                       a.heads, batch, m, a, stream);
    if (err != cudaSuccess) return err;
  }
  if (two && ((err = cudaEventRecord(side.join, side.stream)) != cudaSuccess ||
              (err = cudaStreamWaitEvent(stream, side.join, 0)) != cudaSuccess)) {
    return err;
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
