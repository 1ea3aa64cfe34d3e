// Fused LayerNorm + bias-free q/k/v projections for Hopper (sm_90a): in bf16
// LN in the prologue of one wgmma + TMA GEMM; in float32 (at the end of the
// file) an LN + split pass, then a streamed GEMM on the two-part split.
//
//   xn = LN(x) rounded to x's type;  q = xn Wq^T,  k = xn Wk^T,  v = xn Wv^T
//
// Replaces the TPU kernel `_ln_qkv_kernel` (emox/ops/ff.py:353, called at
// :373). In bf16 one read of x feeds the three projections, and the
// normalised tokens never reach device memory.
//
// What bounds it on the H100: at level 0 of a 256^2 request under CFG (M
// 32768, C 320, inner 320) it does 2*M*C*3*inner = 20 GFLOP against 21 MB
// of x and 63 MB of q/k/v: device memory bounds it (25 us; 20 us of
// tensor-core work). At levels 2 and mid (C 1280, M 2048 and 512) the
// operations bound it, and the rows are few: 8-32 row tiles for 132 SMs.
//
// The design (the producer / consumer layout of ff_sm90.cu and
// flash_fwd_sm90.cu; one producer warp, two consumer warpgroups that take
// the registers the producer gives up with setmaxnreg):
//   * a block owns BM rows of x and a run of `per` column tiles of BN
//     output columns; each column tile lies in one of q, k and v (a tile
//     runs past `inner` only as zeros: TMA fills rows of W past `inner`
//     with zeros and the epilogue stores what lies inside). The wrapper
//     picks `per` so that the grid fills the card: at level 0 a block
//     takes all six tiles of its rows, at mid every tile is a block;
//   * the producer TMA-loads the block's whole x tile [BM, C] (64-row x
//     64-column boxes, 128-byte swizzle: the layout wgmma reads A in; an
//     mbarrier per 64 rows, so LN starts on the first rows while the rest
//     arrive), then streams the weight tiles [BN, 64] of its column tiles
//     through a ring;
//   * LN in the prologue: the consumer warps take 2 or 4 rows at a time, 8
//     or 16 lanes a row, read them from shared memory into registers, compute the fp32 mean and then the mean
//     of squared deviations (two passes, as ln_qkv_xla), and write xn,
//     rounded to bf16, over x in place. In the swizzled tile the 16-byte
//     unit p of row r in a 64-column chunk holds the logical unit p ^ (r %
//     8): `unit_channel` recovers each element's channel for ln_w and ln_b
//     (a Python twin in emox_torch/ops/ln_qkv.py is tested on the CPU).
//     Then fence.proxy.async, so that wgmma sees the generic stores;
//   * per column tile, the K loop runs wgmma over the resident A chunks and
//     the ring's B stages (fp32 accumulators), one group in flight; the
//     epilogue rounds each accumulator once to bf16, and the 4 lanes of a
//     quad swap pairs so that each stores 16 contiguous bytes of a row.
//     (Staging the tile in shared memory for TMA stores, in the tile's last
//     ring stage, measured slower on the H100: each staged piece waited for
//     the store to read it before the next.)
// Tiles by C (x tile + ring within the 227 KB of shared memory); the weight
// tiles are read again for every row tile, from L2, so the rows a block
// holds set how often:
//   C <= 320:  BM 256, BN 160 (each consumer warpgroup 128 rows x 160: two
//              m64n160 wgmmas a step), 3 stages;
//   C <= 640:  BM 128, BN 128 (64 rows x 128), 4 stages;
//   C <= 1280: BM 64,  BN 128 (the two warpgroups split the columns: 64 x 64), 4 stages.
// C and inner must be multiples of 8 (16-byte rows); columns past C are
// zeros in the tile, skipped by the statistics and left zero by LN.
// What bounds it as built (an in-kernel %globaltimer trace on the H100): at
// C 320 the epilogue's stores (the device's write rate while no products
// run) and the x load with LN; at C 640 and 1280 the products from L2-fed
// weight tiles at 64-128 rows a block, and the grid's partly empty last
// wave. Not yet done: a persistent grid, LN on the producer's warps too,
// overlapping a tile's stores with the next tile's products.
#include "gemm_sm90.cuh"

namespace emox {
namespace ln_qkv_sm90 {

using namespace emox::sm90;

constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kBK = 64;        // columns of x per chunk and per k-step (one 128-byte box)

template <int BM, int BN, int STAGES, int CHUNKS>
struct Tiles {
  static constexpr int kWgRows = BM >= 128 ? 2 : 1;    // the consumer warpgroups across the rows
  static constexpr int kMSub = BM / 64 / kWgRows;      // 64-row wgmma blocks per warpgroup: 2 or 1
  static constexpr int kWgCols = 2 / kWgRows;          // the consumer warpgroups across the columns
  static constexpr int kN = BN / kWgCols;              // one warpgroup's wgmma width
  static constexpr int kRowLanes = CHUNKS <= 5 ? 4 : (CHUNKS <= 10 ? 8 : 16);  // LN: lanes per row
  static constexpr int kUnits = (CHUNKS * 8 + kRowLanes - 1) / kRowLanes;       // 16-byte units of a row per lane
  static constexpr uint32_t a_chunk = BM * 128;        // one 64-column chunk of the x tile
  static constexpr uint32_t b_stage = BN * 128;
  static constexpr int kGroups = BM / 64;              // 64-row groups of the x tile, an mbarrier each
  static uint32_t bytes(int chunks) { return chunks * a_chunk + STAGES * b_stage + 8 * (2 * STAGES + 4) + 1024; }
};

struct Args {
  const __nv_bfloat16* ln_w;
  const __nv_bfloat16* ln_b;
  __nv_bfloat16* q;
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  int m, c, inner, chunks, tiles_per_out, col_tiles, per;
  float eps;
};

// The first channel of the 16-byte unit at physical position p of row r in
// x chunk k: the 128-byte swizzle stores logical unit p ^ (r % 8)
// there (the tile is 1024-byte aligned and rows are 128 bytes).
__device__ __forceinline__ int unit_channel(int k, int r, int p) { return kBK * k + 8 * (p ^ (r & 7)); }

// The sum over the LANES lanes of a row's group (LANES a power of two).
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LN of the tile's BM rows in place: each of the 8 consumer warps takes
// 32 / kRowLanes rows at a time, kRowLanes lanes a row and kUnits 16-byte
// units a lane (its x and its ln_w, ln_b loaded up front).
template <int BM, int BN, int STAGES, int CHUNKS>
__device__ __forceinline__ void layer_norm_tile(uint8_t* tile, const Args& a, uint32_t xfull) {
  using S = Tiles<BM, BN, STAGES, CHUNKS>;
  constexpr int L = S::kRowLanes, RPW = 32 / L, U = S::kUnits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, sub = lane % L;
  const int units = a.chunks * 8;
  const float inv_c = 1.f / a.c;
  for (int r = warp * RPW + lane / L; r < BM; r += 8 * RPW) {
    uint4 u[U], wv[U], bv[U];
    bool on[U];
    float sp[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums: shorter dependency chains
#pragma unroll
    for (int i = 0; i < U; ++i) {  // ln_w and ln_b first: their loads overlap the wait for x
      const int unit = sub + L * i, k = unit / 8, p = unit % 8, ch = unit_channel(k, r, p);
      on[i] = unit < units && ch < a.c;
      u[i] = wv[i] = bv[i] = make_uint4(0, 0, 0, 0);
      if (on[i]) {
        wv[i] = __ldg(reinterpret_cast<const uint4*>(a.ln_w + ch));
        bv[i] = __ldg(reinterpret_cast<const uint4*>(a.ln_b + ch));
      }
    }
    mbar_wait(xfull + 8 * (r / 64), 0);  // the row's 64-row group has arrived
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int unit = sub + L * i, k = unit / 8, p = unit % 8;
      if (on[i]) u[i] = *reinterpret_cast<const uint4*>(tile + k * S::a_chunk + r * 128 + p * 16);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[j % 4] += __bfloat162float(e[j]);  // zeros where off
    }
    const float mu = group_sum<L>((sp[0] + sp[1]) + (sp[2] + sp[3])) * inv_c;
#pragma unroll
    for (int j = 0; j < 4; ++j) sp[j] = 0.f;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (on[i]) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = __bfloat162float(e[j]) - mu;
          sp[j % 4] += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum<L>((sp[0] + sp[1]) + (sp[2] + sp[3])) * inv_c + a.eps);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int unit = sub + L * i, k = unit / 8, p = unit % 8;
      if (unit >= units) continue;
      uint4 o = make_uint4(0, 0, 0, 0);  // columns past C stay zero
      if (on[i]) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u[i]);
        const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&wv[i]);
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&bv[i]);
        uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y0 = (__bfloat162float(e[2 * j]) - mu) * rstd * __bfloat162float(w[2 * j]) +
                           __bfloat162float(b[2 * j]);
          const float y1 = (__bfloat162float(e[2 * j + 1]) - mu) * rstd * __bfloat162float(w[2 * j + 1]) +
                           __bfloat162float(b[2 * j + 1]);
          op[j] = pack_bf16(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(tile + k * S::a_chunk + r * 128 + p * 16) = o;
    }
  }
}

// The 4 lanes of a quad hold, for one row, the 4-byte column pairs q = lane
// % 4 of four 8-column groups (w[0..3]); afterwards lane q holds the whole
// group q (columns 8q .. 8q + 7 of the four), for one 16-byte store.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int q) {
  uint32_t out[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int send = q ^ s;  // the partner lane q ^ s needs my pair of its group
    const uint32_t mine = send == 0 ? w[0] : (send == 1 ? w[1] : (send == 2 ? w[2] : w[3]));
    const uint32_t got = __shfl_xor_sync(0xffffffffu, mine, s);
    // got is lane (q ^ s)'s pair q ^ s of my group q
    if (s == 0) out[0] = got;
    if (s == 1) out[1] = got;
    if (s == 2) out[2] = got;
    if (s == 3) out[3] = got;
  }
  // out[s] is column pair (q ^ s) of group q: put it at position q ^ s
  uint4 r;
  r.x = q == 0 ? out[0] : (q == 1 ? out[1] : (q == 2 ? out[2] : out[3]));
  r.y = q == 1 ? out[0] : (q == 0 ? out[1] : (q == 3 ? out[2] : out[3]));
  r.z = q == 2 ? out[0] : (q == 3 ? out[1] : (q == 0 ? out[2] : out[3]));
  r.w = q == 3 ? out[0] : (q == 2 ? out[1] : (q == 1 ? out[2] : out[3]));
  return r;
}

template <int BM, int BN, int STAGES, int CHUNKS>
__global__ void __launch_bounds__(kThreads, 1)
    ln_qkv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args a) {
  using S = Tiles<BM, BN, STAGES, CHUNKS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle reads address bits 4-9
  uint8_t* tile = smem_raw + (base - raw);
  const uint32_t ring = base + a.chunks * S::a_chunk;
  const uint32_t full0 = ring + STAGES * S::b_stage, empty0 = full0 + 8 * STAGES, xfull = empty0 + 8 * STAGES;
  // xfull + 8g: the x tile's 64-row group g has arrived
  const int m0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * a.per, t1 = min(a.col_tiles, t0 + a.per);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    for (int g = 0; g < S::kGroups; ++g) mbar_init(xfull + 8 * g, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int g = 0; g < S::kGroups; ++g) {
        mbar_expect_tx(xfull + 8 * g, a.chunks * 64 * 128);
        for (int k = 0; k < a.chunks; ++k) {
          tma_load_2d(base + k * S::a_chunk + g * 64 * 128, &tx, xfull + 8 * g, k * kBK, m0 + 64 * g);
        }
      }
      int j = 0;
      for (int t = t0; t < t1; ++t) {
        const int o = t / a.tiles_per_out, n0 = (t % a.tiles_per_out) * BN;
        const CUtensorMap* tb = o == 0 ? &tq : (o == 1 ? &tk : &tv);
        for (int k = 0; k < a.chunks; ++k, ++j) {
          const int s = j % STAGES;
          if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, S::b_stage);
          tma_load_2d(ring + s * S::b_stage, tb, full0 + 8 * s, k * kBK, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  layer_norm_tile<BM, BN, STAGES, CHUNKS>(tile, a, xfull);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // xn, written by st.shared, read by wgmma
  asm volatile("bar.sync 1, 256;\n" ::: "memory");                // every row normalised

  const int wrow = wg % S::kWgRows, wcol = wg / S::kWgRows;
  const int t_ = threadIdx.x % 128, lane = t_ % 32;
  float acc[S::kMSub][S::kN / 2];
#pragma unroll
  for (int ms = 0; ms < S::kMSub; ++ms) {
#pragma unroll
    for (int i = 0; i < S::kN / 2; ++i) acc[ms][i] = 0.f;
  }
  int j = 0;
  for (int t = t0; t < t1; ++t) {
    for (int k = 0; k < a.chunks; ++k, ++j) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t pa = base + k * S::a_chunk + wrow * S::kMSub * 64 * 128;
      const uint32_t pb = ring + s * S::b_stage + wcol * S::kN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ms = 0; ms < S::kMSub; ++ms) {
          Wgmma<S::kN>::ss(acc[ms], smem_desc(pa + ms * 64 * 128 + kk * 32, 16, 1024),
                           smem_desc(pb + kk * 32, 16, 1024), k + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait1();
      if (k > 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
    }
    wgmma_wait0();
#pragma unroll
    for (int ms = 0; ms < S::kMSub; ++ms) fence_regs<S::kN / 2>(acc[ms]);

    mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));

    // acc[ms][4i + e] is row lane / 4 (+ 8 for e >= 2) of the warp's 16 in
    // 64-row block ms, column n0 + 8i + 2 (lane % 4) + e % 2. Per four
    // 8-column groups a quad swaps pairs, and each lane stores one group's
    // 16 bytes.
    const int o = t / a.tiles_per_out, n0 = (t % a.tiles_per_out) * BN + wcol * S::kN;
    __nv_bfloat16* out = o == 0 ? a.q : (o == 1 ? a.k : a.v);
    const int q = lane % 4;
#pragma unroll
    for (int ms = 0; ms < S::kMSub; ++ms) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wrow * S::kMSub + ms) * 64 + (t_ / 32) * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int g = 0; g < S::kN / 32; ++g) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = pack_bf16(acc[ms][4 * (4 * g + i) + 2 * h], acc[ms][4 * (4 * g + i) + 2 * h + 1]);
          }
          const uint4 v16 = quad_transpose(w, q);
          const int col = n0 + 8 * (4 * g + q);
          if (row < a.m && col < a.inner) {  // inner % 8 == 0: the 8 columns lie inside
            *reinterpret_cast<uint4*>(out + (size_t)row * a.inner + col) = v16;
          }
        }
      }
    }
  }
}

template <int BM, int BN, int STAGES, int CHUNKS>
static cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* const* w, Args a, cudaStream_t stream) {
  using S = Tiles<BM, BN, STAGES, CHUNKS>;
  const int m_tiles = (a.m + BM - 1) / BM;
  a.tiles_per_out = (a.inner + BN - 1) / BN;
  a.col_tiles = 3 * a.tiles_per_out;
  if (a.per < 1 || a.per > a.col_tiles || m_tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tx, tq, tk, tv;
  if (!make_map_2d(&tx, x, a.m, a.c, 64) || !make_map_2d(&tq, w[0], a.inner, a.c, BN) ||
      !make_map_2d(&tk, w[1], a.inner, a.c, BN) || !make_map_2d(&tv, w[2], a.inner, a.c, BN)) {
    return cudaErrorInvalidValue;
  }
  const uint32_t bytes = S::bytes(a.chunks);
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel<BM, BN, STAGES, CHUNKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.col_tiles + a.per - 1) / a.per, m_tiles);
  ln_qkv_kernel<BM, BN, STAGES, CHUNKS><<<grid, kThreads, bytes, stream>>>(tx, tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace ln_qkv_sm90
}  // namespace emox

// bf16 LN + q/k/v: x [m, c]; ln_w, ln_b [c]; wq, wk, wv [inner, c] (PyTorch
// Linear layout); q, k, v [m, inner]. Contiguous, 16-byte aligned, c % 8 == 0,
// c <= 1280, inner % 8 == 0. `per`: column tiles per block (1 to 3 * the
// tiles of one output; the wrapper's plan). Returns a cudaError_t (0 = launched).
extern "C" int emox_ln_qkv_sm90(const void* x, const void* ln_w, const void* ln_b, const void* wq, const void* wk,
                                const void* wv, void* q, void* k, void* v, int m, int c, int inner, int per,
                                float eps, void* stream) {
  using namespace emox::ln_qkv_sm90;
  using T = __nv_bfloat16;
  if (m <= 0 || c <= 0 || c % 8 || c > 1280 || inner <= 0 || inner % 8) return (int)cudaErrorInvalidValue;
  const int chunks = (c + kBK - 1) / kBK;
  const T* w[3] = {static_cast<const T*>(wq), static_cast<const T*>(wk), static_cast<const T*>(wv)};
  Args a{static_cast<const T*>(ln_w), static_cast<const T*>(ln_b), static_cast<T*>(q), static_cast<T*>(k),
         static_cast<T*>(v), m, c, inner, chunks, 0, 0, per, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  if (chunks <= 5) return (int)launch<256, 160, 3, 5>(xp, w, a, s);
  if (chunks <= 10) return (int)launch<128, 128, 4, 10>(xp, w, a, s);
  return (int)launch<64, 128, 4, 20>(xp, w, a, s);
}

// ---- float32: LN + split, then one streamed GEMM over the split -------------------
// The bf16 design keeps the block's whole x tile resident; float32's two
// parts double its bytes, and 64 rows x 1280 columns of parts would need
// 320 KB. So xn goes through device memory: gemm_sm90.cuh's ln_rows_kernel
// writes its parts [M, 2w] (w: C padded to 64, zeros past C; xn is not
// rounded), one split launch writes Wq's, Wk's and Wv's parts into one
// scratch [3 inner, 2w] (at every call: an optimizer step updates the
// weights in place), and a streamed wgmma + TMA GEMM (gemm_sm90.cuh's ring,
// PARTS 2: A_hi B_hi + A_hi B_lo + A_lo B_hi with fp32 accumulation) runs
// over tiles of 128 rows x 160 output columns, each column tile inside one
// of q, k, v: one tensor map covers the three weights' parts, and a tile's
// rows past its weight's `inner` (the next weight's, or TMA's zeros past the
// last) feed only columns the epilogue drops. Its epilogue writes float32
// pairs. Any C is taken (the contraction streams), C and
// inner multiples of 4. What bounds it on the H100 at the float32 step's
// level 0 (M 4096, C 320, inner 320): the issued bf16 products, 3 x
// 6*M*C*inner = 7.5 GFLOP (0.0076 ms at 989 TFLOP/s), and the 21 MB of x
// read and q, k, v written (0.006 ms at 3.35 TB/s); at M 2048, C 1280 the
// products (0.031 ms).
namespace emox {
namespace ln_qkv_f32 {

using namespace emox::sm90;
using namespace emox::gemm_sm90;

constexpr int kBN = 160;  // output columns per block
constexpr int kStages = 3;
using R = Ring<kBN, kStages, 2>;

struct Args {
  float* out[3];  // q, k, v [m, inner]
  int m, inner, ksteps, tiles_per_out, w;
};

__global__ void __launch_bounds__(kThreads, 1)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle reads address bits 4-9
  const int o = blockIdx.x / a.tiles_per_out, n0 = (blockIdx.x % a.tiles_per_out) * kBN, m0 = blockIdx.y * kBM;
  init_ring(base + R::bar_off, base + R::bar_off + 8 * kStages, kStages);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    // B's rows from output o's first row in the parts of all three weights
    if (threadIdx.x == 256) produce<kBN, kStages, 2>(base, &ta, &tb, &tb, 1, m0, o * a.inner + n0, 0, a.ksteps, a.w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  float acc[kBN / 2];
  consume<kBN, kStages, 2>(acc, base, wg, a.ksteps);

  // acc[4i + e] is row r_lo (e < 2) or r_lo + 8, column n0 + 8i + col0 + e % 2
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = m0 + wg * 64 + (t / 32) * 16 + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
  float* out = o == 0 ? a.out[0] : (o == 1 ? a.out[1] : a.out[2]);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int col = n0 + 8 * i + col0;
    if (col < a.inner) {  // inner even and col even: col + 1 < inner too
      if (r_lo < a.m) store_pair<float>(out + (size_t)r_lo * a.inner + col, acc[4 * i], acc[4 * i + 1]);
      if (r_hi < a.m) store_pair<float>(out + (size_t)r_hi * a.inner + col, acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

}  // namespace ln_qkv_f32
}  // namespace emox

// float32 LN + q/k/v on the two-part split: x [m, c]; ln_w, ln_b [c]; wq, wk,
// wv [inner, c]; q, k, v [m, inner]. Scratch from the caller, bf16 (w: c
// padded to a multiple of 64): xp [m, 2w] (xn's parts), wp [3 inner, 2w] (the
// weights' parts). Contiguous, 16-byte aligned, c % 4 == 0, inner % 4 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int emox_ln_qkv_f32_sm90(const void* x, const void* ln_w, const void* ln_b, const void* wq, const void* wk,
                                    const void* wv, void* q, void* k, void* v, void* xp, void* wp, int m, int c,
                                    int inner, float eps, void* stream) {
  using namespace emox::ln_qkv_f32;
  using B = __nv_bfloat16;
  const int m_tiles = (m + kBM - 1) / kBM;
  if (m <= 0 || c <= 0 || c % 4 || inner <= 0 || inner % 4 || m_tiles > 65535 || xp == nullptr || wp == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = split_width(c);
  B* xs = static_cast<B*>(xp);
  B* ws = static_cast<B*>(wp);
  const size_t per = (size_t)inner * 2 * w;  // one weight's parts
  cudaError_t err = ln_rows(static_cast<const float*>(x), static_cast<const float*>(ln_w),
                             static_cast<const float*>(ln_b), xs, m, c, w, eps, s);
  if (err != cudaSuccess) return (int)err;
  const SplitJobs jobs{{{static_cast<const float*>(wq), ws, inner, c, w},
                        {static_cast<const float*>(wk), ws + per, inner, c, w},
                        {static_cast<const float*>(wv), ws + 2 * per, inner, c, w}},
                       3};
  if ((err = split_matrices(jobs, s)) != cudaSuccess) return (int)err;
  CUtensorMap ta, tb;
  if (!make_map_2d(&ta, xs, m, 2 * w, kBM) || !make_map_2d(&tb, ws, 3 * inner, 2 * w, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = smem_attr(qkv_gemm_kernel, R::bytes)) != cudaSuccess) return (int)err;
  const int tiles = (inner + kBN - 1) / kBN;
  const Args a{{static_cast<float*>(q), static_cast<float*>(k), static_cast<float*>(v)}, m, inner, w / kBK, tiles, w};
  qkv_gemm_kernel<<<dim3(3 * tiles, m_tiles), kThreads, R::bytes, s>>>(ta, tb, a);
  return (int)cudaGetLastError();
}
