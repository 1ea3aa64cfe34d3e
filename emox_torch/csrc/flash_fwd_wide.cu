// Flash attention forward at head dims above 512 for Hopper (sm_90a): wgmma
// + TMA, bf16 and float32 (a two-part bf16 split).
//
// Replaces the TPU kernels `_flash_nlc_kernel` (emox/ops/attention.py:409)
// and `_flash_kernel` (:69) where the head dim is above 512: softmax(q k^T *
// scale) v with the per-row log-sum-exp lse (wide.cuh: the room, the split).
//
// Head dims up to 2240 (bf16) / 1152 (float32), cluster_fwd_kernel:
// a cluster per 64 query rows of cs blocks, each owning a slice of W = 64 CH
// columns of Q, K, V and O (wide_plan in emox_torch/ops/attention.py: the
// fewest slices, 2 to 8, whose W fits; cluster_fwd_fits checks the plan it
// passes; bf16 CH 4 or 5, float32 CH 3 or 4: at d 640 two slices of
// 320 in bf16, three of 256 in float32). S = q k^T is issued once a tile:
// each block computes its slice's partial (wgmma, fp32), sends it into a
// slot of every other block's shared memory (st.async, counted on the
// receiver's in_full mbarrier) and sums the cs partials in slice order,
// p_0 + p_1 + ... + p_{cs-1}, its own at its turn: the same additions in
// the same order in every block, so the same bits of S, the same softmax
// and the same lse in the whole cluster. A receiver frees its slots by one
// arrival on each sender's out_free (cs - 1 a phase) once it has read them;
// a sender waits for that before it sends the next tile's. The exchange is
// what costs: distributed shared memory moves a few tens of GB/s a block, so
// the fewer and wider the slices, the fewer bytes per product (one [64, 64]
// fp32 partial, 16 KB, a tile and other slice). Two consumer warpgroups,
// each with its own online softmax and O_w [64, W], merged at the end as
// split-K flash attention does; they split every tile's keys (float32) or
// take alternate whole tiles (bf16: products of N 64, and each partial's
// exchange lands while the other warpgroup works). Where the grid would
// leave most SMs idle (the float32 VAE's N 1 x 1024), the keys are split
// in two halves of the cluster too, each half's (O, m, l) merged into the
// other's at the end through distributed shared memory. One producer warp
// streams K and V slices through rings of one or two stages.
// Wider heads (fwd_kernel): a block per (64-row tile, 128-column
// slice, kSlice), every slice's block computing the whole S (streamed over
// 64-column chunks, summed in the same order in every slice: the same
// bits), one consumer warpgroup: no cluster, no width limit; it issues
// 2 (d / 128 + 1) units, the price of the reference's unbounded width.
// What bounds it on the H100: the function is 4 N*H*Lq*Lk*d flops on the
// tensor cores, three times over on float32's parts; the cluster forward
// issues those 4 units (over the slices' padded width), the slice kernel
// 2 (d / 128 + 1).
#include <cooperative_groups.h>

#include "wide.cuh"

namespace emox {
namespace wide {

namespace coop = cooperative_groups;

// ---- the slice forward, past the cluster's reach: a block per (64 query rows, slice) --------
// ring stage: Q chunk then K chunk (hi, and lo after them); V slice: 2 boxes a part
template <int PARTS>
struct FwdSmem {
  static constexpr uint32_t stage = 2 * PARTS * kBox;
  static constexpr uint32_t ring_off = 0;
  static constexpr uint32_t v_off = ring_off + STAGES * stage;
  static constexpr uint32_t bar_off = v_off + 2 * PARTS * kBox;
  // full[STAGES], empty[STAGES], v_full, v_empty
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = FwdSmem<PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + S::bar_off, empty0 = full0 + 8 * STAGES;
  const uint32_t v_full = empty0 + 8 * STAGES, v_empty = v_full + 8;
  const int slice = blockIdx.x % args.slices, q0 = (blockIdx.x / args.slices) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (args.lk + 63) / 64, chunks = args.chunks;

  if (threadIdx.x == 0) {
    init_ring(full0, empty0);
    mbar_init(v_full, 1);
    mbar_init(v_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {  // the producer
      int it = 0;
      for (int j = 0; j < tiles; ++j) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
          mbar_expect_tx(full, S::stage);
          for (int p = 0; p < PARTS; ++p) {
            tma_load_4d(st + (2 * p) * kBox, &tq, full, column(p, c, args.lo), q0, h, b);
            tma_load_4d(st + (2 * p + 1) * kBox, &tk, full, column(p, c, args.lo), j * 64, h, b);
          }
        }
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_full, 2 * PARTS * kBox);
        for (int p = 0; p < PARTS; ++p) {
          for (int i = 0; i < 2; ++i) {
            tma_load_4d(base + S::v_off + (2 * p + i) * kBox, &tv, v_full, column(p, 2 * slice + i, args.lo),
                        j * 64, h, b);
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows, the slice's 128 columns of O ----------
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
  const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    // S = q k^T over every chunk of the head dim, in chunk order
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs<32>(sc);
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t st = base + S::ring_off + s * S::stage;
      wgmma_fence();
      product<64, 1, PARTS>(sc, st, 2 * kBox, st + kBox, 2 * kBox, c > 0);  // lo boxes 2 boxes on
      wgmma_commit();
      wgmma_wait0();
      mbar_arrive(empty0 + 8 * s);
    }
    fence_regs<32>(sc);

    // online softmax in base 2 (flash_fwd_sm90.cu's): sc[4i + e] is row
    // row_lo (e < 2) or row_lo + 8, key 8i + col0 + e % 2 of the tile
    const bool ragged = (j + 1) * 64 > args.lk;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float v = (ragged && j * 64 + 8 * (i / 4) + col0 + (i % 2) >= args.lk) ? kNegInf : sc[i] * args.scale_log2;
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
    for (int i = 0; i < 32; ++i) {
      const bool lo = (i % 4) < 2;
      const float p = exp2f(sc[i] - (lo ? mn_lo : mn_hi));
      sc[i] = p;
      if (lo) sum_lo += p;
      else sum_hi += p;
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

    // O += P v[:, slice]: P the register A operand, V's slice MN-major
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a_operand<PARTS>(sc + 8 * k, pa[k], pl[k]);
    mbar_wait(v_full, j & 1);
    fence_regs<64>(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) rs_product<kSlice, 2, PARTS>(o, pa[k], pl[k], base + S::v_off + k * 16 * 128, kBox);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<64>(o);
    mbar_arrive(v_empty);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-20f);  // as the TPU kernel's l_safe
  l_hi = fmaxf(l_hi, 1e-20f);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = q0 + row_lo, r_hi = r_lo + 8;
  const int c_base = slice * kSlice;
  TO* ob = args.o + b * args.o_b + h * args.o_h + c_base;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + col0;
    if (c_base + col < args.d) {
      if (r_lo < args.lq) store_pair(ob + r_lo * args.o_r + col, o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
      if (r_hi < args.lq) store_pair(ob + r_hi * args.o_r + col, o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
    }
  }
  if (slice == 0 && lane % 4 == 0) {  // every slice holds the same statistics
    float* lb = args.lse + b * args.l_b + h * args.l_h;
    constexpr float kLn2 = 0.6931471805599453f;
    if (r_lo < args.lq) lb[r_lo * args.l_r] = (m_lo + log2f(l_lo)) * kLn2;
    if (r_hi < args.lq) lb[r_hi * args.l_r] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

// ---- forward: a cluster per 64 query rows that splits the head dim ------------------------
// The cluster's cs blocks of each key part each own W = 64 CH columns of Q,
// K, V and O (CH 4 or 5 in bf16, 3 or 4 in float32, whose two parts double
// a tile's bytes); with ck = 2 the keys are split in two halves, one a set
// of cs blocks, merged at the end. Block rank r owns slice r % cs of key
// part r / cs. Shared memory: Q's slice (resident), rings of K and V slices
// (64 keys; kst and vst stages), each warpgroup's slots of S partials (fp32
// in fragment order), barriers; at the end the rings hold warpgroup 1's O
// and (ck = 2) the other key part's. The two consumer warpgroups share the
// keys one of two ways:
//   * PP 0 (float32, and bf16 where PP 1 does not fit): warpgroup w takes
//     keys 32w..32w+31 of every 64-key tile ([64, 32] partials, a slot for
//     each other slice); a block's own partial stays in registers, and the
//     next tile's is computed during this tile's softmax and P v and sent
//     once the others have read this one's;
//   * PP 1 (bf16): warpgroup w takes whole tiles w, w + 2, ... ([64, 64]
//     partials: products of N 64, half the shared-memory reads of N 32 for
//     the same work), a slot for every slice, its own included; its next
//     tile's partial is computed behind its P v and sent at once, so the
//     exchange lands while the other warpgroup works.
constexpr int kMaxCluster = 8;                // the portable cluster size
constexpr int kClusterThreads = 384;          // warpgroups 0, 1: consumers; 2: producer

__host__ __device__ constexpr uint32_t part_bytes(int pp) { return (pp ? 64 : 32) * 64 * 4; }  // a partial

struct ClusterFwdSmem {
  uint32_t q_off, k_off, v_off, xch_off, bar_off, bytes, tile, slots;
  __host__ __device__ ClusterFwdSmem(int parts, int ch, int cs, int kst, int vst, int pp) {
    tile = ch * parts * kBox;  // 64 rows of a block's 64 ch columns, hi (and lo) boxes
    slots = pp ? cs : cs - 1;  // a warpgroup's slots: [slice], or [other slice]
    q_off = 0;
    k_off = q_off + tile;
    v_off = k_off + kst * tile;
    xch_off = v_off + vst * tile;
    bar_off = xch_off + 2 * slots * part_bytes(pp);
    // q_full, k_full[2], k_empty[kst], v_full[vst], v_empty[vst], in_full[2], out_free[2], merge_ready, merge_full
    bytes = bar_off + 8 * (1 + 2 + kst + 2 * vst + 6) + 1024;  // + alignment slack
  }
};

// The cluster forward's plan for a head dim: slices cs and their width CH
// chunks, key parts ck, ring stages kst, vst, the warpgroups' key sharing pp
// (cs 0: the slice kernel)
struct ClusterFwd {
  int cs, ch, ck, kst, vst, pp;
};

// Whether plan p can run head dim d (wide_plan in emox_torch/ops/attention.py
// chooses it; this only checks it): 2 to 8 blocks a cluster, each slice an
// instantiated width (bf16 CH 4 or 5, float32 3 or 4) and none of them past
// d, key sharing pp 1 in bf16 only and with two V stages, rings of 1 or 2
// stages within a block's shared memory, and a key split (ck 2) only where
// both halves have keys and the rings hold two O tiles at the end.
static bool cluster_fwd_fits(int parts, int d, int key_tiles, const ClusterFwd& p) {
  const int chunks = (d + 63) / 64, ch_lo = parts == 1 ? 4 : 3;
  if (p.cs < 2 || p.ck < 1 || p.ck > 2 || p.cs * p.ck > kMaxCluster) return false;
  if (p.ch < ch_lo || p.ch > ch_lo + 1 || p.cs * p.ch < chunks || (p.cs - 1) * p.ch >= chunks) return false;
  if (p.pp < 0 || p.pp > (parts == 1 ? 1 : 0) || (p.pp && p.vst < 2)) return false;
  if (p.kst < 1 || p.kst > 2 || p.vst < 1 || p.vst > 2) return false;
  if (p.ck == 2 && ((p.kst + p.vst) * parts < 4 || key_tiles < 2)) return false;
  return ClusterFwdSmem(parts, p.ch, p.cs, p.kst, p.vst, p.pp).bytes <= 232448;
}

// x = the partial S = Q K^T over a block's 64 CH columns for N keys (K's
// rows at k), issued once K has arrived on `full`; in flight until a wgmma
// wait
template <int N, int PARTS, int CH>
__device__ __forceinline__ void issue_partial(float* x, uint32_t q, uint32_t k, uint32_t full, uint32_t parity) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
  fence_regs<N / 2>(x);
  mbar_wait(full, parity);
  wgmma_fence();
  product<N, CH, PARTS>(x, q, kBox, k, kBox);
  wgmma_commit();
  fence_regs<N / 2>(x);
}

// O (+)= P V over one 16-key step: P's parts from registers, V's 64 CH
// columns MN-major at b (64-column boxes; N of one wgmma at most 256)
template <int PARTS, int CH>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* ah, const uint32_t* al, uint32_t b) {
  if constexpr (CH == 5) {
    rs_product<192, CH, PARTS>(o, ah, al, b, kBox);
    rs_product<128, CH, PARTS>(o + 96, ah, al, b + 3 * kBox, kBox);
  } else {
    rs_product<64 * CH, CH, PARTS>(o, ah, al, b, kBox);
  }
}

// A warpgroup's partial (NS values a thread) to the other slices of its key
// part (ranks g0 .. g0 + cs - 1), once they have read its previous one (n:
// this warpgroup's count of tiles; out_free), into their slot for this slice
// counted on their in_full; PP 1: its own slot too. slots, in_full,
// out_free: the warpgroup's (shared::cta addresses); gbase: the generic
// address of the aligned shared memory base.
template <int NS, int PP>
__device__ __forceinline__ void send_partial(const float* x, int n, uint8_t* gbase, uint32_t slots, uint32_t in_full,
                                             uint32_t out_free, int s, int g0, int cs, int t) {
  constexpr uint32_t kBytes = part_bytes(PP);
  if (n > 0) mbar_wait_cluster(out_free, (n - 1) & 1);
  if (PP) store_part<NS>(gbase + (slots - smem_u32(gbase)) + s * kBytes, x, t);
  for (int r = 0; r < cs; ++r) {
    if (r != s) send_part<NS>(slots + (PP || s < r ? s : s - 1) * kBytes, in_full, g0 + r, x, t);
  }
}

template <int PARTS, int CH, int PP, typename TO>
__global__ void __launch_bounds__(kClusterThreads, 1)
    cluster_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  constexpr int W = 64 * CH;            // this block's head-dim columns
  constexpr int KEYS = PP ? 64 : 32;    // a warpgroup's keys of a tile it takes
  constexpr int NS = KEYS / 2;          // their partial's values a thread
  constexpr uint32_t kBytes = part_bytes(PP);
  constexpr int STEP = PP ? 2 : 1;      // a warpgroup's next tile
  const int cs = args.cs, ck = args.ck, kst = args.kstages, vst = args.vstages;
  const ClusterFwdSmem S(PARTS, CH, cs, kst, vst, PP);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  // K_u arrives on k_full[u % KF]: PP 1 gives each warpgroup its own (the
  // two take alternate tiles, and a barrier's waiter may not run a phase
  // ahead), also where the tiles share one K stage
  const int kf = PP ? 2 : kst;
  const uint32_t q_full = base + S.bar_off;
  const uint32_t k_full0 = q_full + 8, k_empty0 = k_full0 + 8 * 2;  // K arrived / K of stage s: its S products done
  const uint32_t v_full0 = k_empty0 + 8 * kst, v_empty0 = v_full0 + 8 * vst;  // V arrived / its P v done
  const uint32_t in_full0 = v_empty0 + 8 * vst;  // in_full[w]: the other slices' warpgroup w sent their partials
  const uint32_t out_free0 = in_full0 + 16;      // out_free[w]: every other slice's warpgroup w read ours
  const uint32_t merge_ready = out_free0 + 16;   // key part 0's rings are free for part 1's O
  const uint32_t merge_full = merge_ready + 8;   // key part 1's O and statistics arrived
  const int rank = (int)cluster_rank(), s = rank % cs, part = rank / cs, g0 = part * cs;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x / (cs * ck)) * kRows;
  const int c0 = s * W;  // this block's head-dim columns (of each part)
  const int all_tiles = (args.lk + 63) / 64, per_part = (all_tiles + ck - 1) / ck;
  const int j0 = part * per_part, tiles = min(all_tiles, j0 + per_part) - j0;  // this key part's 64-key tiles
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) mbar_init(k_full0 + 8 * i, 1);
    for (int i = 0; i < kst; ++i) mbar_init(k_empty0 + 8 * i, 128 * (PP ? 1 : 2));  // the warpgroups that read a tile
    for (int i = 0; i < vst; ++i) {
      mbar_init(v_full0 + 8 * i, 1);
      mbar_init(v_empty0 + 8 * i, 128 * (PP ? 1 : 2));
    }
    for (int w = 0; w < 2; ++w) {  // armed for the others' bytes; one arrival from each other slice frees
      mbar_init(in_full0 + 8 * w, 1);
      mbar_init(out_free0 + 8 * w, cs - 1);
    }
    mbar_init(merge_ready, 1);
    mbar_init(merge_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers exist before any block arrives on another's

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load, in the order the consumers use them
    // (j counting this key part's tiles): Q, K_0, then K_{j+1} ahead of V_j (PP 0); Q, K_0,
    // K_1, then V_j ahead of K_{j+2} (PP 1)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int row) {
        mbar_expect_tx(bar, S.tile);
        for (int p = 0; p < PARTS; ++p) {
          for (int i = 0; i < CH; ++i) {
            tma_load_4d(dst + (CH * p + i) * kBox, map, bar, p * args.lo + c0 + 64 * i, row, h, b);
          }
        }
      };
      load(&tq, base + S.q_off, q_full, q0);
      // step i loads K_i (i < tiles) and V_{i - STEP} (i >= STEP): PP 0 K_{j+1}
      // ahead of V_j; PP 1 K_{j+2} behind V_j. Counters, not divisions: the
      // producer has 24 registers
      int ks = 0, kb = 0, vs = 0;   // the next K stage, K barrier and V stage
      uint32_t kpar = 0, vpar = 0;  // the parity of the stage's last fill (the ring's lap)
      for (int i = 0; i < tiles + STEP; ++i) {
        if (PP && i >= STEP) {
          if (i - STEP >= vst) mbar_wait(v_empty0 + 8 * vs, vpar ^ 1);
          load(&tv, base + S.v_off + vs * S.tile, v_full0 + 8 * vs, (j0 + i - STEP) * 64);
          if (++vs == vst) vs = 0, vpar ^= 1;
        }
        if (i < tiles) {
          if (i >= kst) mbar_wait(k_empty0 + 8 * ks, kpar ^ 1);
          load(&tk, base + S.k_off + ks * S.tile, k_full0 + 8 * kb, (j0 + i) * 64);
          if (++ks == kst) ks = 0, kpar ^= 1;
          if (++kb == kf) kb = 0;
        }
        if (!PP && i >= STEP) {
          if (i - STEP >= vst) mbar_wait(v_empty0 + 8 * vs, vpar ^ 1);
          load(&tv, base + S.v_off + vs * S.tile, v_full0 + 8 * vs, (j0 + i - STEP) * 64);
          if (++vs == vst) vs = 0, vpar ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: PP 0: warpgroup wg takes keys 32 wg .. 32 wg + 31 of every tile;
    // PP 1: tiles wg, wg + 2, ... -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    const uint32_t keys = PP ? 0 : wg * 32 * 128;  // this warpgroup's keys within each box
    const int first = PP ? wg : 0;                 // this warpgroup's first tile
    const uint32_t slots = base + S.xch_off + wg * S.slots * kBytes;  // PP 0: [other slice]; PP 1: [slice]
    const uint8_t* gslots = gbase + (slots - base);
    const uint32_t in_full = in_full0 + 8 * wg, out_free = out_free0 + 8 * wg;
    float o[W / 2];  // O_w: this block's W columns, over this warpgroup's keys
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2) of each row
    float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the running sum
    const auto k_stage = [&](int u) { return u % kst; };

    float sp[NS];  // this block's partial of the tile in the exchange (PP 0; PP 1 keeps it in its slot)
    mbar_wait(q_full, 0);
    if (first < tiles) {
      if (t == 0) mbar_expect_tx(in_full, (cs - 1) * kBytes);  // the others' partials of the first tile
      issue_partial<KEYS, PARTS, CH>(sp, base + S.q_off, base + S.k_off + k_stage(first) * S.tile + keys,
                                     k_full0 + 8 * (first % kf), (first / kf) & 1);
      wgmma_wait0();
      fence_regs<NS>(sp);
      mbar_arrive(k_empty0 + 8 * k_stage(first));
      send_partial<NS, PP>(sp, 0, gbase, slots, in_full, out_free, s, g0, cs, t);
    }

    for (int n = 0, j = first; j < tiles; ++n, j += STEP) {
      const int u = j + STEP;  // this warpgroup's next tile
      const bool next = u < tiles;

      // S = the slices' partials summed in slice order, p_0 + p_1 + ... +
      // p_{cs-1}, in every block of the key part (its own from registers, or
      // from its own slot, at its turn): the same bits of S, so the same
      // softmax, in all of them
      mbar_wait_cluster(in_full, n & 1);
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS / 4; ++i) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < cs; ++r) {
          float4 v;
          if (PP) {
            v = *reinterpret_cast<const float4*>(gslots + r * kBytes + (i * 128 + t) * 16);
          } else {
            v = r == s ? make_float4(sp[4 * i], sp[4 * i + 1], sp[4 * i + 2], sp[4 * i + 3])
                       : *reinterpret_cast<const float4*>(gslots + (r < s ? r : r - 1) * kBytes + (i * 128 + t) * 16);
          }
          if (r == 0) {
            acc = v;
          } else {
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
        }
        sc[4 * i] = acc.x;
        sc[4 * i + 1] = acc.y;
        sc[4 * i + 2] = acc.z;
        sc[4 * i + 3] = acc.w;
      }
      warpgroup_sync(wg);
      if (t == 0) {
        if (next) mbar_expect_tx(in_full, (cs - 1) * kBytes);  // the others' partials of tile u
        for (int r = 0; r < cs; ++r) {
          if (r != s) mbar_arrive_cluster(map_rank(out_free, g0 + r));
        }
      }

      // PP 0: the next tile's partial runs on the tensor cores during this
      // tile's softmax and P v, and goes to the others while P v runs
      float sn[NS];
      if (!PP && next) {
        issue_partial<KEYS, PARTS, CH>(sn, base + S.q_off, base + S.k_off + k_stage(u) * S.tile + keys,
                                       k_full0 + 8 * (u % kf), (u / kf) & 1);
      }

      // online softmax in base 2 on this warpgroup's keys: sc[4i + e] is row
      // row_lo (e < 2) or row_lo + 8, key 8i + col0 + e % 2 of its KEYS
      const int key0 = (j0 + j) * 64 + (PP ? 0 : wg * 32);
      const bool ragged = key0 + KEYS > args.lk;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool masked = ragged && key0 + 8 * (i / 4) + col0 + (i % 2) >= args.lk;
        const float v = masked ? kNegInf : sc[i] * args.scale_log2;
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
      for (int i = 0; i < NS; ++i) {
        const bool lo = (i % 4) < 2;
        // a masked key is 0 even where every key of the row so far is masked
        const float p = sc[i] == kNegInf ? 0.f : exp2f(sc[i] - (lo ? mn_lo : mn_hi));
        sc[i] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

      // O_w += P V_j: P's parts the register A operand, V's slice MN-major
      uint32_t pa[KEYS / 16][4], pl[KEYS / 16][4];
#pragma unroll
      for (int k = 0; k < KEYS / 16; ++k) a_operand<PARTS>(sc + 8 * k, pa[k], pl[k]);
      const int sv = j % vst;
      mbar_wait(v_full0 + 8 * sv, (j / vst) & 1);
      fence_regs<W / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KEYS / 16; ++k) {
        pv_step<PARTS, CH>(o, pa[k], pl[k], base + S.v_off + sv * S.tile + keys + k * 16 * 128);
      }
      wgmma_commit();
      if (PP) {
        // P v done, the next tile's partial (the other warpgroup keeps the
        // tensor cores busy meanwhile), and it goes to the others at once
        wgmma_wait0();
        fence_regs<W / 2>(o);
        mbar_arrive(v_empty0 + 8 * sv);
        if (next) {
          issue_partial<KEYS, PARTS, CH>(sn, base + S.q_off, base + S.k_off + k_stage(u) * S.tile,
                                         k_full0 + 8 * (u % kf), (u / kf) & 1);
          wgmma_wait0();
          fence_regs<NS>(sn);
          mbar_arrive(k_empty0 + 8 * k_stage(u));
          send_partial<NS, PP>(sn, n + 1, gbase, slots, in_full, out_free, s, g0, cs, t);
        }
      } else {
        if (next) {
          // the partial (committed first) is done: to the others once every
          // one of them has read this tile's
          wgmma_wait1();
          fence_regs<NS>(sn);
          mbar_arrive(k_empty0 + 8 * k_stage(u));
          send_partial<NS, PP>(sn, n + 1, gbase, slots, in_full, out_free, s, g0, cs, t);
#pragma unroll
          for (int i = 0; i < NS; ++i) sp[i] = sn[i];
        }
        wgmma_wait0();
        fence_regs<W / 2>(o);
        mbar_arrive(v_empty0 + 8 * sv);
      }
    }

    // merge warpgroup 1's (O_1, m_1, l_1) into warpgroup 0's, then (two key
    // parts) part 1's block into part 0's, as split-K flash attention does
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    consumers_sync();  // both warpgroups are done with the rings and the slots
    if (ck == 2 && part == 0 && threadIdx.x == 0) mbar_arrive_cluster(map_rank(merge_ready, rank + cs));
    float4* stage = reinterpret_cast<float4*>(gbase + S.k_off);        // O_1 (256 W bytes of the rings)
    const float4* other = reinterpret_cast<const float4*>(gbase + S.k_off + 256 * W);  // part 1's O
    float* stat = reinterpret_cast<float*>(gbase + S.xch_off);                          // [row]: m_1, l_1
    const float4* other_stat = reinterpret_cast<const float4*>(gbase + S.xch_off + 512);  // [thread]: part 1's
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < W / 8; ++i) stage[i * 128 + t] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
      if (lane % 4 == 0) {
        stat[2 * row_lo] = m_lo;
        stat[2 * row_lo + 1] = l_lo;
        stat[2 * (row_lo + 8)] = m_hi;
        stat[2 * (row_lo + 8) + 1] = l_hi;
      }
    }
    consumers_sync();
    if (wg == 0) {
      const float m1_lo = stat[2 * row_lo], l1_lo = stat[2 * row_lo + 1];
      const float m1_hi = stat[2 * (row_lo + 8)], l1_hi = stat[2 * (row_lo + 8) + 1];
      float mm_lo = fmaxf(m_lo, m1_lo), mm_hi = fmaxf(m_hi, m1_hi);
      const float a0_lo = exp2f(m_lo - mm_lo), a1_lo = exp2f(m1_lo - mm_lo);
      const float a0_hi = exp2f(m_hi - mm_hi), a1_hi = exp2f(m1_hi - mm_hi);
      float ls_lo = l_lo * a0_lo + l1_lo * a1_lo, ls_hi = l_hi * a0_hi + l1_hi * a1_hi;
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        const float4 p = stage[i * 128 + t];
        o[4 * i] = o[4 * i] * a0_lo + p.x * a1_lo;
        o[4 * i + 1] = o[4 * i + 1] * a0_lo + p.y * a1_lo;
        o[4 * i + 2] = o[4 * i + 2] * a0_hi + p.z * a1_hi;
        o[4 * i + 3] = o[4 * i + 3] * a0_hi + p.w * a1_hi;
      }
      if (ck == 2 && part == 1) {
        // to part 0's block of this slice, into its rings once it has freed them
        mbar_wait_cluster(merge_ready, 0);
        const uint32_t dst = map_rank(base + S.k_off + 256 * W, rank - cs), bar = map_rank(merge_full, rank - cs);
#pragma unroll
        for (int i = 0; i < W / 8; ++i) st_async_v4(dst + (i * 128 + t) * 16, o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3], bar);
        st_async_v4(map_rank(base + S.xch_off + 512, rank - cs) + t * 16, mm_lo, ls_lo, mm_hi, ls_hi, bar);
      } else {
        if (ck == 2) {
          if (t == 0) mbar_expect_tx(merge_full, 256 * W + 128 * 16);
          mbar_wait_cluster(merge_full, 0);
          const float4 st = other_stat[t];  // part 1's (m, l) of rows row_lo and row_lo + 8
          const float mx_lo = fmaxf(mm_lo, st.x), mx_hi = fmaxf(mm_hi, st.z);
          const float b0_lo = exp2f(mm_lo - mx_lo), b1_lo = exp2f(st.x - mx_lo);
          const float b0_hi = exp2f(mm_hi - mx_hi), b1_hi = exp2f(st.z - mx_hi);
#pragma unroll
          for (int i = 0; i < W / 8; ++i) {
            const float4 p = other[i * 128 + t];
            o[4 * i] = o[4 * i] * b0_lo + p.x * b1_lo;
            o[4 * i + 1] = o[4 * i + 1] * b0_lo + p.y * b1_lo;
            o[4 * i + 2] = o[4 * i + 2] * b0_hi + p.z * b1_hi;
            o[4 * i + 3] = o[4 * i + 3] * b0_hi + p.w * b1_hi;
          }
          ls_lo = ls_lo * b0_lo + st.y * b1_lo;
          ls_hi = ls_hi * b0_hi + st.w * b1_hi;
          mm_lo = mx_lo;
          mm_hi = mx_hi;
        }
        ls_lo = fmaxf(ls_lo, 1e-20f);  // as the TPU kernel's l_safe
        ls_hi = fmaxf(ls_hi, 1e-20f);
        const float inv_lo = 1.f / ls_lo, inv_hi = 1.f / ls_hi;
        const int r_lo = q0 + row_lo, r_hi = r_lo + 8;
        TO* ob = args.o + b * args.o_b + h * args.o_h + c0;
#pragma unroll
        for (int i = 0; i < W / 8; ++i) {
          const int col = 8 * i + col0;
          if (c0 + col < args.d) {
            if (r_lo < args.lq) store_pair(ob + r_lo * args.o_r + col, o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
            if (r_hi < args.lq) store_pair(ob + r_hi * args.o_r + col, o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
          }
        }
        if (rank == 0 && lane % 4 == 0) {  // every block of the cluster holds the same statistics
          float* lb = args.lse + b * args.l_b + h * args.l_h;
          constexpr float kLn2 = 0.6931471805599453f;
          if (r_lo < args.lq) lb[r_lo * args.l_r] = (mm_lo + log2f(ls_lo)) * kLn2;
          if (r_hi < args.lq) lb[r_hi * args.l_r] = (mm_hi + log2f(ls_hi)) * kLn2;
        }
      }
    }
  }
  cluster.sync();  // no block leaves while another may still arrive on its barriers
}

// ---- host side ------------------------------------------------------------------
// The slice forward (fwd_kernel): a block per (row tile, 128-column slice)
template <int PARTS, typename TO>
static cudaError_t launch_slice_fwd(int tiles, int batch, const CUtensorMap* m, const Args<TO>& a,
                                    cudaStream_t stream) {
  auto kernel = fwd_kernel<PARTS, TO>;
  const uint32_t smem = FwdSmem<PARTS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles * a.slices, a.heads, batch), kThreads, smem, stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

// The cluster forward of plan a (cs, ck, kstages, vstages) with CH-chunk slices
template <int PARTS, int CH, int PP, typename TO>
static cudaError_t launch_cluster_fwd(int tiles, int batch, const CUtensorMap* m, const Args<TO>& a,
                                      cudaStream_t stream) {
  auto kernel = cluster_fwd_kernel<PARTS, CH, PP, TO>;
  const uint32_t smem = ClusterFwdSmem(PARTS, CH, a.cs, a.kstages, a.vstages, PP).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cs * a.ck, a.heads, batch);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs * a.ck;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The forward on plan c (cluster) or the slice kernel (cluster false)
template <int PARTS, typename TO>
static cudaError_t launch_fwd(int tiles, int batch, const CUtensorMap* m, Args<TO> a, bool cluster,
                              const ClusterFwd& c, cudaStream_t stream) {
  if (!cluster) return launch_slice_fwd<PARTS>(tiles, batch, m, a, stream);
  a.cs = c.cs;
  a.ck = c.ck;
  a.kstages = c.kst;
  a.vstages = c.vst;
  // the instantiated kernels: CH kLo and kLo + 1; bf16 with either key sharing, float32 with PP 0
  constexpr int kLo = PARTS == 1 ? 4 : 3, kPp = PARTS == 1 ? 1 : 0;
  if (c.pp && kPp) {
    return c.ch == kLo ? launch_cluster_fwd<PARTS, kLo, kPp>(tiles, batch, m, a, stream)
                       : launch_cluster_fwd<PARTS, kLo + 1, kPp>(tiles, batch, m, a, stream);
  }
  return c.ch == kLo ? launch_cluster_fwd<PARTS, kLo, 0>(tiles, batch, m, a, stream)
                     : launch_cluster_fwd<PARTS, kLo + 1, 0>(tiles, batch, m, a, stream);
}

}  // namespace wide
}  // namespace emox

// Attention forward at head dims above 512 on [batch, heads, L, head_dim]
// operands with element strides, bf16 (dtype 1) or float32 (dtype 0):
// `strides` holds (batch, head, row) for q, k, v, o and lse (15 values), the
// head dim contiguous, rows 16-byte aligned (head_dim a multiple of 8 in
// bf16, of 4 in float32). (cs, ch, ck, kstages, vstages, pp) is the cluster
// plan wide_plan gives (ClusterFwd), cs 0 for the slice kernel; a plan that
// does not fit (cluster_fwd_fits) is refused. Float32 first splits q, k, v
// into q2, k2, v2: bf16 scratch of [batch, heads, lq or lk, 2w] elements,
// contiguous (NULL in bf16), w the columns the kernel's blocks cover: cs * 64
// * ch on a cluster plan, else 128 * ceil(head_dim / 128). Returns a
// cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const long long* strides, int batch, int heads, int lq, int lk, int head_dim,
                                   float scale, int dtype, int cs, int ch, int ck, int kstages, int vstages, int pp,
                                   void* q2, void* k2, void* v2, void* stream) {
  using namespace emox::wide;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 512 ||
      (dtype != 0 && dtype != 1) || head_dim % (dtype == 1 ? 8 : 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool f32 = dtype == 0;
  const int tiles = (lq + kRows - 1) / kRows, chunks = (head_dim + 63) / 64, slices = wide_slices(head_dim);
  const ClusterFwd plan{cs, ch, ck, kstages, vstages, pp};
  const bool cluster = cs != 0;
  if (cluster && !cluster_fwd_fits(f32 ? 2 : 1, head_dim, (lk + 63) / 64, plan)) return (int)cudaErrorInvalidValue;
  const int w = cluster ? plan.cs * 64 * plan.ch : slices * kSlice;
  const void* src[3] = {q, k, v};
  void* parts[3] = {q2, k2, v2};
  const int lens[3] = {lq, lk, lk};
  long long st[9];
  cudaError_t err;
  const int width = operands(src, parts, lens, 3, strides, st, batch, heads, head_dim, w, f32, s, &err);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[3];
  if (!emox::sm90::make_map(&m[0], src[0], batch, heads, lq, width, st, 64) ||
      !emox::sm90::make_map(&m[1], src[1], batch, heads, lk, width, st + 3, 64) ||
      !emox::sm90::make_map(&m[2], src[2], batch, heads, lk, width, st + 6, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* so = strides + 9;
  const long long* sl = strides + 12;
  if (f32) {
    Args<float> a{static_cast<float*>(o), nullptr, nullptr, nullptr, static_cast<float*>(lse), nullptr, nullptr,
                  so[0], so[1], so[2], sl[0], sl[1], sl[2], 0, 0, 0, 0, 0, 0, 0, 0, 0,
                  heads, lq, lk, 0, head_dim, chunks, slices, w, scale, scale * emox::sm90::kLog2e};
    return (int)launch_fwd<2>(tiles, batch, m, a, cluster, plan, s);
  }
  Args<__nv_bfloat16> a{static_cast<__nv_bfloat16*>(o), nullptr, nullptr, nullptr, static_cast<float*>(lse),
                        nullptr, nullptr, so[0], so[1], so[2], sl[0], sl[1], sl[2], 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        heads, lq, lk, 0, head_dim, chunks, slices, 0, scale, scale * emox::sm90::kLog2e};
  return (int)launch_fwd<1>(tiles, batch, m, a, cluster, plan, s);
}
