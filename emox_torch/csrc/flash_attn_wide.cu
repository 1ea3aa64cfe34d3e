// Flash attention at head dims above 512 for Hopper (sm_90a): wgmma + TMA,
// bf16 and float32 (a two-part bf16 split), forward and backward.
//
// Replaces the TPU kernels `_flash_nlc_kernel` (emox/ops/attention.py:409)
// and `_flash_kernel` (:69) forward, and the backward pairs
// `_flash_bwd_nlc_dq_kernel` / `_flash_bwd_nlc_dkv_kernel` (:465, :508) and
// `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` (:118, :160), where the head
// dim is above 512: the reference sends every d % 64 == 0 to its packed
// kernel and any other d to its strided one, with no width limit. No preset
// reaches such a head dim; a VAE of last width 640 or 1024 at L >= 2048
// would. From q, k, v (and dO, lse, delta = sum_d dO*O for the backward) it
// returns softmax(q k^T * scale) v with lse, or dq, dk and dv.
//
// The room is the problem: one fp32 accumulator row of width d is d/2
// registers a thread at 64 rows a warpgroup, and a 64-row operand tile d/8
// KB. The design keeps no tile of full width anywhere:
//   * the head dim is cut into column slices of 128 (kSlice) and a block per
//     (64-row tile, slice, head, batch) owns only its slice of the outputs:
//     O = P v[:, slice], dq[:, slice] += dS k[:, slice], dv[:, slice] +=
//     P^T dO[:, slice], dk[:, slice] += dS^T q[:, slice] (64 fp32 registers
//     a thread for each accumulator); slice 0 writes lse;
//   * every block computes the whole S = q k^T (and dP = dO v^T) of its tile,
//     streaming the operands through a two-stage ring of 64-column chunks
//     (TMA, 128-byte swizzle) into [64, 64] (dk/dv: [64, 32]) fp32 wgmma
//     accumulators; every slice's block sums the chunks in the same order, so
//     P, lse and dS are the same bits in every slice;
//   * no cluster, no exchange, no atomics, no width limit; the price is
//     (d / 128) times the S and dP products, and Q (K, V in dk/dv) re-read
//     from L2 for every tile;
//   * one consumer warpgroup and one producer warp (in a warpgroup of its
//     own): 256 threads, so a thread may hold 255 registers without setmaxnreg;
//   * the dq and dk/dv kernels write only their own rows: the same bits from
//     run to run.
// Float32 (PARTS = 2): q, k, v (and dO) are first split into bf16 scratch
// [B, H, L, 2W] (split.cuh: hi in columns [0, W), lo in [W, 2W), W the head
// dim padded to the slices), every product a b runs as a_hi b_hi + a_hi b_lo
// + a_lo b_hi with fp32 accumulation, and P and dS are split in registers.
// bf16 reads the caller's operands directly: the columns past d of the last
// chunk and slice arrive zero-filled (TMA out-of-bounds fill), as do keys
// past Lk (masked: P = 0) and rows past Lq (P = 0 through lse = +inf in the
// dk/dv kernel, whose lse and delta come as [B, H, Lq_pad], Lq_pad the next
// multiple of 64, padded with +inf and 0).
// What bounds it on the H100: the function is 4 (forward) or 10 (backward)
// N*H*Lq*Lk*d flops on the tensor cores; this design issues
// 2 (d / 128 + 1) (forward) and 2 (4 d / 128 + 3) (backward) of them, three
// times over on float32's parts, at one consumer warpgroup a block: at d 640,
// N 1 x 4096 its bf16 forward and backward take 3.7x and 4.4x the time of
// the products they issue.
#include "split.cuh"

namespace emox {
namespace wide {

using namespace emox::sm90;

constexpr int kSlice = 128;        // head-dim columns a block owns
constexpr int kRows = 64;          // query rows (forward, dq) or keys (dk/dv) a block owns
constexpr int kThreads = 256;      // warpgroup 0: consumer; 1: producer (its first thread)
constexpr int STAGES = 2;          // chunks in flight
constexpr int kLqPad = 64;         // lse and delta come padded to a multiple of this
constexpr int BQ = 32;             // query rows a tile of the dk/dv kernel
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

// ---- forward: a block per (64 query rows, slice) ------------------------------------
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

// One [64, 128] accumulator (acc[4i + e]: row r0 (e < 2) or r0 + 8, column
// 8i + col0 + e % 2 of the slice), times `mul`, to a strided output whose
// slice starts at `out`; rows at or past `nrows`, columns at or past `ncols`
// dropped.
template <typename TO>
__device__ __forceinline__ void store_slice(TO* out, long long stride, const float* acc, int r0, int nrows, int col0,
                                            int ncols, float mul) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + col0;
    if (col < ncols) {
      if (r0 < nrows) store_pair(out + r0 * stride + col, acc[4 * i] * mul, acc[4 * i + 1] * mul);
      if (r0 + 8 < nrows) store_pair(out + (r0 + 8) * stride + col, acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
  }
}

// ---- dq: a block per (64 query rows, slice) ------------------------------------------
// ring stage: Q, K, dO, V chunks (hi, then the lo ones); K slice: 2 boxes a part
template <int PARTS>
struct DqSmem {
  static constexpr uint32_t stage = 4 * PARTS * kBox;
  static constexpr uint32_t ring_off = 0;
  static constexpr uint32_t k_off = ring_off + STAGES * stage;
  static constexpr uint32_t bar_off = k_off + 2 * PARTS * kBox;
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DqSmem<PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + S::bar_off, empty0 = full0 + 8 * STAGES;
  const uint32_t k_full = empty0 + 8 * STAGES, k_empty = k_full + 8;
  const int slice = blockIdx.x % args.slices, q0 = (blockIdx.x / args.slices) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (args.lk + 63) / 64, chunks = args.chunks;

  if (threadIdx.x == 0) {
    init_ring(full0, empty0);
    mbar_init(k_full, 1);
    mbar_init(k_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      int it = 0;
      for (int j = 0; j < tiles; ++j) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
          mbar_expect_tx(full, S::stage);
          for (int p = 0; p < PARTS; ++p) {  // box 4p + (0 Q, 1 K, 2 dO, 3 V)
            const int col = column(p, c, args.lo);
            tma_load_4d(st + (4 * p) * kBox, &tq, full, col, q0, h, b);
            tma_load_4d(st + (4 * p + 1) * kBox, &tk, full, col, j * 64, h, b);
            tma_load_4d(st + (4 * p + 2) * kBox, &tdo, full, col, q0, h, b);
            tma_load_4d(st + (4 * p + 3) * kBox, &tv, full, col, j * 64, h, b);
          }
        }
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        mbar_expect_tx(k_full, 2 * PARTS * kBox);
        for (int p = 0; p < PARTS; ++p) {
          for (int i = 0; i < 2; ++i) {
            tma_load_4d(base + S::k_off + (2 * p + i) * kBox, &tk, k_full, column(p, 2 * slice + i, args.lo),
                        j * 64, h, b);
          }
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row_lo = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int r_lo = q0 + row_lo;  // < lq_pad: the grid covers ceil(lq / 64) tiles
  const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
  const float lse_lo = args.lse_in[vec + r_lo] * kLog2e, lse_hi = args.lse_in[vec + r_lo + 8] * kLog2e;
  const float dl_lo = args.delta[vec + r_lo], dl_hi = args.delta[vec + r_lo + 8];
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t st = base + S::ring_off + s * S::stage;
      wgmma_fence();
      product<64, 1, PARTS>(sc, st, 4 * kBox, st + kBox, 4 * kBox, c > 0);  // lo boxes 4 boxes on
      product<64, 1, PARTS>(dp, st + 2 * kBox, 4 * kBox, st + 3 * kBox, 4 * kBox, c > 0);
      wgmma_commit();
      wgmma_wait0();
      mbar_arrive(empty0 + 8 * s);
    }
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    // P and dS = P (dP - delta); keys past Lk get P = 0
    const bool ragged = (j + 1) * 64 > args.lk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lo = (i % 4) < 2;
      float p = prob(sc[i], args.scale_log2, lo ? lse_lo : lse_hi);
      if (ragged && j * 64 + 8 * (i / 4) + col0 + (i % 2) >= args.lk) p = 0.f;
      dp[i] = p * (dp[i] - (lo ? dl_lo : dl_hi));
    }
    uint32_t da[4][4], dl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a_operand<PARTS>(dp + 8 * k, da[k], dl[k]);
    mbar_wait(k_full, j & 1);
    fence_regs<64>(dq);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) rs_product<kSlice, 2, PARTS>(dq, da[k], dl[k], base + S::k_off + k * 16 * 128, kBox);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<64>(dq);
    mbar_arrive(k_empty);
  }
  const int c_base = slice * kSlice;
  store_slice(args.dq + b * args.dq_b + h * args.dq_h + c_base, args.dq_r, dq, r_lo, args.lq, col0, args.d - c_base,
              args.scale);
}

// ---- dk, dv: a block per (64 keys, slice); 32-row query tiles ----------------------------
// ring stage: K, V chunks (64 rows), Q, dO chunks (32 rows), hi then lo;
// the tile: Q and dO slices (2 boxes of 32 rows a part each), its lse and delta
template <int PARTS>
struct DkvSmem {
  static constexpr uint32_t qbox = BQ * 128;  // one 32-row box
  static constexpr uint32_t stage = PARTS * (2 * kBox + 2 * qbox);
  static constexpr uint32_t ring_off = 0;
  static constexpr uint32_t q_off = ring_off + STAGES * stage;  // Q slice, then dO slice
  static constexpr uint32_t vec_off = q_off + 4 * PARTS * qbox;  // lse, delta: BQ fp32 each
  static constexpr uint32_t bar_off = vec_off + 2 * BQ * 4;
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
  static_assert(kLqPad % BQ == 0, "a query tile never reads past the lse padding");
};

template <int PARTS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args<TO> args) {
  using S = DkvSmem<PARTS>;
  constexpr uint32_t qbox = S::qbox;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  const uint32_t full0 = base + S::bar_off, empty0 = full0 + 8 * STAGES;
  const uint32_t t_full = empty0 + 8 * STAGES, t_empty = t_full + 8;
  const int slice = blockIdx.x % args.slices, k0 = (blockIdx.x / args.slices) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (args.lq + BQ - 1) / BQ, chunks = args.chunks;  // tiles <= lq_pad / BQ

  if (threadIdx.x == 0) {
    init_ring(full0, empty0);
    mbar_init(t_full, 1);
    mbar_init(t_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a stage: part p's K box at 2p kBox + 2p qbox, V after it, then Q and dO (32 rows)
  constexpr uint32_t part_bytes = 2 * kBox + 2 * qbox;
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      const size_t vec = ((size_t)b * args.heads + h) * args.lq_pad;
      int it = 0;
      for (int i = 0; i < tiles; ++i) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t full = full0 + 8 * s, st = base + S::ring_off + s * S::stage;
          mbar_expect_tx(full, S::stage);
          for (int p = 0; p < PARTS; ++p) {
            const int col = column(p, c, args.lo);
            const uint32_t pb = st + p * part_bytes;
            tma_load_4d(pb, &tk, full, col, k0, h, b);
            tma_load_4d(pb + kBox, &tv, full, col, k0, h, b);
            tma_load_4d(pb + 2 * kBox, &tq, full, col, i * BQ, h, b);
            tma_load_4d(pb + 2 * kBox + qbox, &tdo, full, col, i * BQ, h, b);
          }
        }
        if (i > 0) mbar_wait(t_empty, (i - 1) & 1);
        mbar_expect_tx(t_full, 4 * PARTS * qbox + 2 * BQ * 4);
        for (int p = 0; p < PARTS; ++p) {  // Q slice boxes 2p, 2p + 1; dO slice 2 PARTS boxes on
          for (int x = 0; x < 2; ++x) {
            const int col = column(p, 2 * slice + x, args.lo);
            tma_load_4d(base + S::q_off + (2 * p + x) * qbox, &tq, t_full, col, i * BQ, h, b);
            tma_load_4d(base + S::q_off + (2 * PARTS + 2 * p + x) * qbox, &tdo, t_full, col, i * BQ, h, b);
          }
        }
        bulk_load(base + S::vec_off, args.lse_in + vec + i * BQ, BQ * 4, t_full);
        bulk_load(base + S::vec_off + BQ * 4, args.delta + vec + i * BQ, BQ * 4, t_full);
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int row_lo = warp * 16 + lane / 4;  // this thread's keys: row_lo and row_lo + 8
  const int col0 = 2 * (lane % 4);          // and query rows col0, col0 + 1 of every 8
  const float* lse = reinterpret_cast<const float*>(gbase + S::vec_off);
  const float* delta = lse + BQ;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  int it = 0;
  for (int i = 0; i < tiles; ++i) {
    // S^T = K Q^T and dP^T = V dO^T over every chunk: keys on rows, the tile's query rows on columns
    float st[16], dpt[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) st[e] = dpt[e] = 0.f;
    fence_regs<16>(st);
    fence_regs<16>(dpt);
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t sb = base + S::ring_off + s * S::stage;
      wgmma_fence();
      product<BQ, 1, PARTS>(st, sb, part_bytes, sb + 2 * kBox, part_bytes, c > 0);  // lo: a part on
      product<BQ, 1, PARTS>(dpt, sb + kBox, part_bytes, sb + 2 * kBox + qbox, part_bytes, c > 0);
      wgmma_commit();
      wgmma_wait0();
      mbar_arrive(empty0 + 8 * s);
    }
    fence_regs<16>(st);
    fence_regs<16>(dpt);

    // P^T and dS^T = P^T (dP^T - delta) with each column's (query row's) lse
    // and delta; rows past Lq have lse = +inf, so P = 0. Keys past Lk need
    // no mask: their rows of dk and dv are not stored.
    mbar_wait(t_full, i & 1);
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int col = 8 * (e / 4) + col0;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + col);
      st[e] = prob(st[e], args.scale_log2, l2.x * kLog2e);
      st[e + 1] = prob(st[e + 1], args.scale_log2, l2.y * kLog2e);
      dpt[e] = st[e] * (dpt[e] - d2.x);
      dpt[e + 1] = st[e + 1] * (dpt[e + 1] - d2.y);
    }
    uint32_t pa[2][4], pl[2][4], sa[2][4], sl[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      a_operand<PARTS>(st + 8 * k, pa[k], pl[k]);
      a_operand<PARTS>(dpt + 8 * k, sa[k], sl[k]);
    }
    // dV += P^T dO[:, slice] and dK += dS^T Q[:, slice]: the tile's query rows
    // are the depth; the slices are MN-major B operands (boxes qbox apart)
    fence_regs<64>(dv);
    fence_regs<64>(dk);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      rs_product<kSlice, 2, PARTS>(dv, pa[k], pl[k], base + S::q_off + 2 * PARTS * qbox + k * 16 * 128, qbox);
      rs_product<kSlice, 2, PARTS>(dk, sa[k], sl[k], base + S::q_off + k * 16 * 128, qbox);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<64>(dv);
    fence_regs<64>(dk);
    mbar_arrive(t_empty);
  }
  const int r_lo = k0 + row_lo, c_base = slice * kSlice;
  store_slice(args.dk + b * args.dk_b + h * args.dk_h + c_base, args.dk_r, dk, r_lo, args.lk, col0, args.d - c_base,
              args.scale);
  store_slice(args.dv + b * args.dv_b + h * args.dv_h + c_base, args.dv_r, dv, r_lo, args.lk, col0, args.d - c_base,
              1.f);
}

// ---- host side ------------------------------------------------------------------
// A backward kernel (four maps) over `tiles` row tiles, each slice a block
template <typename Kernel, typename TO>
static cudaError_t launch(Kernel kernel, uint32_t smem, int tiles, int batch, const CUtensorMap* m,
                          const Args<TO>& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles * a.slices, a.heads, batch), kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int PARTS, typename TO>
static cudaError_t launch_fwd(int tiles, int batch, const CUtensorMap* m, const Args<TO>& a, cudaStream_t stream) {
  auto kernel = fwd_kernel<PARTS, TO>;
  const uint32_t smem = FwdSmem<PARTS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles * a.slices, a.heads, batch), kThreads, smem, stream>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
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

// Attention forward at head dims above 512 on [batch, heads, L, head_dim]
// operands with element strides, bf16 (dtype 1) or float32 (dtype 0):
// `strides` holds (batch, head, row) for q, k, v, o and lse (15 values), the
// head dim contiguous, rows 16-byte aligned (head_dim a multiple of 8 in
// bf16, of 4 in float32). Float32 first splits q, k, v into q2, k2, v2: bf16
// scratch of [batch, heads, lq or lk, 2w] elements, contiguous, w = 128 *
// ceil(head_dim / 128) (NULL in bf16). Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const long long* strides, int batch, int heads, int lq, int lk, int head_dim,
                                   float scale, int dtype, void* q2, void* k2, void* v2, void* stream) {
  using namespace emox::wide;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 512 ||
      (dtype != 0 && dtype != 1) || head_dim % (dtype == 1 ? 8 : 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool f32 = dtype == 0;
  const int slices = wide_slices(head_dim), w = slices * kSlice;
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
  const int tiles = (lq + kRows - 1) / kRows, chunks = (head_dim + 63) / 64;
  if (f32) {
    Args<float> a{static_cast<float*>(o), nullptr, nullptr, nullptr, static_cast<float*>(lse), nullptr, nullptr,
                  so[0], so[1], so[2], sl[0], sl[1], sl[2], 0, 0, 0, 0, 0, 0, 0, 0, 0,
                  heads, lq, lk, 0, head_dim, chunks, slices, w, scale, scale * emox::sm90::kLog2e};
    return (int)launch_fwd<2>(tiles, batch, m, a, s);
  }
  Args<__nv_bfloat16> a{static_cast<__nv_bfloat16*>(o), nullptr, nullptr, nullptr, static_cast<float*>(lse),
                        nullptr, nullptr, so[0], so[1], so[2], sl[0], sl[1], sl[2], 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        heads, lq, lk, 0, head_dim, chunks, slices, 0, scale, scale * emox::sm90::kLog2e};
  return (int)launch_fwd<1>(tiles, batch, m, a, s);
}

// Attention backward at head dims above 512, as emox_flash_fwd_wide's
// operands: `strides` holds (batch, head, row) for q, k, v, dout, dq, dk and
// dv (21 values; those of an output not asked for are ignored). lse and
// delta: [batch, heads, lq_pad] float32, contiguous, 16-byte aligned, lq_pad
// a multiple of 64 with lq <= lq_pad < lq + 64, padded with lse = +inf and
// delta = 0. dq == NULL skips the dq kernel; dk and dv are both given (the
// dk/dv kernel runs) or both NULL. Float32 splits q, k, v, dout first into
// q2, k2, v2, do2 (as the forward's scratch). Returns a cudaError_t.
extern "C" int emox_flash_bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk, void* dv, const long long* strides,
                                   int batch, int heads, int lq, int lk, int lq_pad, int head_dim, float scale,
                                   int dtype, void* q2, void* k2, void* v2, void* do2, void* stream) {
  using namespace emox::wide;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 512 ||
      (dtype != 0 && dtype != 1) || head_dim % (dtype == 1 ? 8 : 4) || lq_pad < lq || lq_pad % kLqPad ||
      lq_pad >= lq + kLqPad || (dk == nullptr) != (dv == nullptr) || reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const bool f32 = dtype == 0;
  const int slices = wide_slices(head_dim), w = slices * kSlice;
  const void* src[4] = {q, k, v, dout};
  void* parts[4] = {q2, k2, v2, do2};
  const int lens[4] = {lq, lk, lk, lq};
  long long st[12];
  cudaError_t err;
  const int width = operands(src, parts, lens, 4, strides, st, batch, heads, head_dim, w, f32, s, &err);
  if (err != cudaSuccess) return (int)err;
  const long long* so = strides + 12;
  const int chunks = (head_dim + 63) / 64;
  // dq: q and dO in 64-row boxes; dk/dv: q and dO in 32-row boxes; k and v 64 rows in both
  CUtensorMap m[4];
  auto maps = [&](int q_rows) {
    return emox::sm90::make_map(&m[0], src[0], batch, heads, lq, width, st, q_rows) &&
           emox::sm90::make_map(&m[1], src[3], batch, heads, lq, width, st + 9, q_rows) &&
           emox::sm90::make_map(&m[2], src[1], batch, heads, lk, width, st + 3, 64) &&
           emox::sm90::make_map(&m[3], src[2], batch, heads, lk, width, st + 6, 64);
  };
  auto run = [&](auto a, auto dq_kernel_, auto dkv_kernel_, uint32_t dq_smem, uint32_t dkv_smem) -> cudaError_t {
    if (dq != nullptr) {
      if (!maps(64)) return cudaErrorInvalidValue;
      const cudaError_t e = launch(dq_kernel_, dq_smem, (lq + kRows - 1) / kRows, batch, m, a, s);
      if (e != cudaSuccess) return e;
    }
    if (dk == nullptr) return cudaSuccess;
    if (!maps(BQ)) return cudaErrorInvalidValue;
    return launch(dkv_kernel_, dkv_smem, (lk + kRows - 1) / kRows, batch, m, a, s);
  };
  if (f32) {
    Args<float> a{nullptr, static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), nullptr,
                  static_cast<const float*>(lse), static_cast<const float*>(delta), 0, 0, 0, 0, 0, 0,
                  so[0], so[1], so[2], so[3], so[4], so[5], so[6], so[7], so[8],
                  heads, lq, lk, lq_pad, head_dim, chunks, slices, w, scale, scale * emox::sm90::kLog2e};
    return (int)run(a, dq_kernel<2, float>, dkv_kernel<2, float>, DqSmem<2>::bytes, DkvSmem<2>::bytes);
  }
  using B16 = __nv_bfloat16;
  Args<B16> a{nullptr, static_cast<B16*>(dq), static_cast<B16*>(dk), static_cast<B16*>(dv), nullptr,
              static_cast<const float*>(lse), static_cast<const float*>(delta), 0, 0, 0, 0, 0, 0,
              so[0], so[1], so[2], so[3], so[4], so[5], so[6], so[7], so[8],
              heads, lq, lk, lq_pad, head_dim, chunks, slices, 0, scale, scale * emox::sm90::kLog2e};
  return (int)run(a, dq_kernel<1, B16>, dkv_kernel<1, B16>, DqSmem<1>::bytes, DkvSmem<1>::bytes);
}
