// Flash attention backward at head dims above 512 for Hopper (sm_90a):
// wgmma + TMA, bf16 and float32 (a two-part bf16 split). Past the reach of
// flash_bwd_wide_sm90.cu's clusters (bf16 above 2048, float32 above 1536):
// the reference has no width limit.
//
// Replaces the TPU backward pairs `_flash_bwd_nlc_dq_kernel` /
// `_flash_bwd_nlc_dkv_kernel` (emox/ops/attention.py:465, :508) and
// `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` (:118, :160) where the
// head dim is above 512: from q, k, v, dO, lse and delta = sum_d dO*O it
// returns dq, dk and dv (wide.cuh: the room, the split).
//
// A block per (64-row tile, 128-column slice), S and dP over the whole head
// dim in every block:
//   * dq[:, slice] += dS k[:, slice], dv[:, slice] += P^T dO[:, slice],
//     dk[:, slice] += dS^T q[:, slice];
//   * S = q k^T (and dP = dO v^T) streamed through a two-stage ring of
//     64-column chunks (TMA, 128-byte swizzle) into [64, 64] (dk/dv: [64, 32])
//     fp32 wgmma accumulators, summed in the same order in every slice's
//     block, so P, lse and dS are the same bits in every slice;
//   * no cluster, no exchange, no atomics, no width limit; the price is
//     (d / 128) times the S and dP products, and Q (K, V in dk/dv) re-read
//     from L2 for every tile;
//   * one consumer warpgroup and one producer warp (in a warpgroup of its
//     own): 256 threads, so a thread may hold 255 registers without setmaxnreg;
//   * the dq and dk/dv kernels write only their own rows: the same bits from
//     run to run.
// What bounds it on the H100: the function is 10 N*H*Lq*Lk*d flops on the
// tensor cores, three times over on float32's parts; these kernels issue
// 2 (4 d / 128 + 3) units: at d 640, N 1 x 4096 the bf16 backward takes 4.4x
// the time of the products it issues.
#include "wide.cuh"

namespace emox {
namespace wide {

constexpr int kLqPad = 64;         // lse and delta come padded to a multiple of this
constexpr int BQ = 32;             // query rows a tile of the dk/dv kernel

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

}  // namespace wide
}  // namespace emox

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
