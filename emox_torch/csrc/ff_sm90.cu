// The GEGLU feed-forward for Hopper (sm_90a) in bf16: wgmma + TMA GEMMs.
//
//   y = [x +] W2 (a * gelu(g)) + b2,   [a | g] = [LN](x) W1 + b1
//
// Replaces the TPU kernels `_ln_ff_kernel` and `_ln_ff_wide_kernel`
// (emox/ops/ff.py:102,120: LayerNorm, the gated FF and the residual; every
// FF sub-layer of the model) and `_ff_kernel` (:455: the gated FF alone,
// behind `fused_geglu_ff`). float32 stays on the WMMA body of geglu_ff.cuh
// (ln_geglu_ff.cu, geglu_ff.cu).
//
// What bounds it on the H100: at level 0 of a 256^2 request (M 32768 rows,
// C 320, F 1280) the function does 6*M*C*F = 80.5 GFLOP against 42 MB of x
// and y: the tensor cores bound it (0.081 ms at 989 TFLOP/s). The WMMA
// kernel it replaces ran 20-320x off that bound: a 16-64-row tile was one
// 256-thread block that walked all of F alone through shared-memory WMMA
// fragments, re-reading the weights from L2 with no overlap of load and
// compute, and at C 1280 the grid had fewer blocks than the card has SMs.
//
// The design here is three kernels in one launch entry, sharing the
// producer / consumer layout of flash_fwd_sm90.cu (one producer warp issues
// TMA loads into a ring of stages guarded by mbarriers; two consumer
// warpgroups of 64 rows each run wgmma on what has arrived, setmaxnreg
// moving registers to them):
//   1. LN (with LN only): one warp per row writes xn [M, C] in bf16 from fp32
//      statistics with a two-pass variance, the reference's rounding point.
//      It costs one read of x and one write of xn (42 MB at level 0);
//      folding LN into GEMM 1's A operand is later work.
//   2. GEMM 1 with a GEGLU epilogue: the grid runs over (F tiles x M tiles),
//      so F is split across blocks. A block takes 128 rows and 128 hidden
//      features: W1's value rows [f0, f0 + 128) and gate rows
//      [F + f0, F + f0 + 128) arrive as two TMA boxes that lie one after
//      the other in shared memory, so one m64n256k16 wgmma per 16-deep step
//      gives a warpgroup both its value and its gate accumulators (128 fp32
//      registers a thread). The epilogue adds b1 in fp32 and writes
//      h = a * gelu_erf(g), rounded to bf16, into an [M, F] scratch.
//   3. GEMM 2 with a bias + residual epilogue: y = h W2^T + b2 (+ x in fp32),
//      tiles of 128 rows x 160 columns (C 320, 640 and 1280 are 2, 4 and 8
//      such tiles), each block taking the whole F contraction. Where that
//      grid has fewer than half as many blocks as the card has SMs (the mid
//      block, M 512 at C 1280) the caller asks for a split of F: each split
//      writes its fp32 partial sum, and a fourth kernel adds the partials in
//      a fixed order with b2 and x. No atomics: the result is the same bits
//      from run to run.
// Every operand is K-major, like Q K^T in flash_fwd_sm90.cu: xn and h as
// [M, K], W1 as PyTorch's [2F, C], W2 as [C, F]; the TMA boxes are 64 columns
// (128 bytes, the 128-byte swizzle wgmma's descriptors name) by the tile's
// rows. Ragged edges: rows past M, columns past C or F and depth past the
// contraction arrive as zeros (TMA's out-of-bounds fill) and the epilogues
// store only what lies inside, so any M, and C and F that keep rows 16-byte
// aligned (multiples of 8), are taken. Each consumer keeps one wgmma group
// in flight and hands a stage back once the group that read it is done.
// Not yet done: LN folded into GEMM 1, a persistent grid whose
// epilogue overlaps the next tile's loads, TMA stores, keeping h on chip.
#include "sm90.cuh"

namespace emox {
namespace ff_sm90 {

using namespace emox::sm90;

constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kBM = 128;       // rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;        // contraction depth per stage (one 128-byte box)
constexpr int kBF = 128;       // GEMM 1: hidden features per block
constexpr int kBC = 160;       // GEMM 2: output columns per block
constexpr int kStages1 = 4;
constexpr int kStages2 = 5;
constexpr int kLnWarps = 8;    // LN: rows per 256-thread block

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- 1. LayerNorm rows: xn = (x - mean) * rstd * w + b, rounded to bf16 ----------
__global__ void __launch_bounds__(32 * kLnWarps)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ xn, int m, int c, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * c);  // 8 values a vector
  const int vecs = c / 8;
  float s = 0.f;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 u = xr[v];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float mu = warp_sum(s) / c;
  float ss = 0.f;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 u = xr[v];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mu;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / c + eps);
  uint4* out = reinterpret_cast<uint4*>(xn + (size_t)row * c);
  for (int v = lane; v < vecs; v += 32) {
    const uint4 u = xr[v];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * v + 2 * i;
      const float y0 = (__bfloat162float(e[2 * i]) - mu) * rstd * bf(w, j) + bf(b, j);
      const float y1 = (__bfloat162float(e[2 * i + 1]) - mu) * rstd * bf(w, j + 1) + bf(b, j + 1);
      op[i] = pack_bf16(y0, y1);
    }
    out[v] = o;
  }
}

// ---- the GEMMs' shared main loop --------------------------------------------------------
// A stage holds the A tile [kBM rows, kBK] and the B tile [BN rows, kBK], both
// K-major and 128-byte swizzled; full[s]: the stage's bytes arrived; empty[s]:
// both consumer warpgroups are done with it.
template <int BN, int STAGES>
struct Ring {
  static constexpr uint32_t a_bytes = kBM * 128;
  static constexpr uint32_t b_bytes = BN * 128;
  static constexpr uint32_t stage = a_bytes + b_bytes;  // a multiple of 1024
  static constexpr uint32_t bar_off = STAGES * stage;
  static constexpr uint32_t bytes = bar_off + 16 * STAGES + 1024;  // + alignment slack
};

// The producer's thread: k-steps [k0, k1) of A (rows m0..) and of B, whose
// boxes come from `nb` maps at rows n0 and lie one after the other.
template <int BN, int STAGES>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* ta, const CUtensorMap* tb0,
                                        const CUtensorMap* tb1, int nb, int m0, int n0, int k0, int k1) {
  using R = Ring<BN, STAGES>;
  const uint32_t full0 = base + R::bar_off, empty0 = full0 + 8 * STAGES;
  for (int j = 0; j < k1 - k0; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
    const uint32_t full = full0 + 8 * s, st = base + s * R::stage;
    mbar_expect_tx(full, R::stage);
    const int kc = (k0 + j) * kBK;
    tma_load_2d(st, ta, full, kc, m0);
    tma_load_2d(st + R::a_bytes, tb0, full, kc, n0);
    if (nb == 2) tma_load_2d(st + R::a_bytes + R::b_bytes / 2, tb1, full, kc, n0);
  }
}

// A consumer warpgroup: acc[BN / 2] = its 64 rows of A times B over `steps`
// k-steps; one wgmma group stays in flight, and a stage is handed back once
// the group that read it has completed.
template <int BN, int STAGES>
__device__ __forceinline__ void consume(float* acc, uint32_t base, int wg, int steps) {
  using R = Ring<BN, STAGES>;
  const uint32_t full0 = base + R::bar_off, empty0 = full0 + 8 * STAGES;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs<BN / 2>(acc);
  for (int j = 0; j < steps; ++j) {
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const uint32_t a = base + s * R::stage + wg * 64 * 128, b = base + s * R::stage + R::a_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<BN>::ss(acc, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024), j + kk > 0);
    }
    wgmma_commit();
    wgmma_wait1();
    if (j > 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
  }
  wgmma_wait0();
  fence_regs<BN / 2>(acc);
}

__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- 2. GEMM 1 + GEGLU: h = (xn W1v^T + b1v) * gelu(xn W1g^T + b1g) ------------------
struct Geglu {
  __nv_bfloat16* h;
  const __nv_bfloat16* b1;
  int m, f, ksteps;
};

__global__ void __launch_bounds__(kThreads, 1)
    geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg, const Geglu args) {
  using R = Ring<2 * kBF, kStages1>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle reads address bits 4-9
  const int n0 = blockIdx.x * kBF, m0 = blockIdx.y * kBM;
  init_ring(base + R::bar_off, base + R::bar_off + 8 * kStages1, kStages1);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) produce<2 * kBF, kStages1>(base, &ta, &tv, &tg, 2, m0, n0, 0, args.ksteps);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  float acc[kBF];  // [0, 64): value columns, [64, 128): the same columns of the gate
  consume<2 * kBF, kStages1>(acc, base, wg, args.ksteps);

  // acc[4i + e] is row r_lo (e < 2) or r_lo + 8, feature n0 + 8i + col0 + e % 2
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = m0 + wg * 64 + (t / 32) * 16 + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kBF / 8; ++i) {
    const int col = n0 + 8 * i + col0;
    if (col < args.f) {  // f % 8 == 0 and col even: col + 1 < f too
      const float av0 = bf(args.b1, col), av1 = bf(args.b1, col + 1);
      const float gv0 = bf(args.b1, args.f + col), gv1 = bf(args.b1, args.f + col + 1);
      if (r_lo < args.m) {
        *reinterpret_cast<uint32_t*>(args.h + (size_t)r_lo * args.f + col) =
            pack_bf16((acc[4 * i] + av0) * gelu_erf(acc[64 + 4 * i] + gv0),
                      (acc[4 * i + 1] + av1) * gelu_erf(acc[64 + 4 * i + 1] + gv1));
      }
      if (r_hi < args.m) {
        *reinterpret_cast<uint32_t*>(args.h + (size_t)r_hi * args.f + col) =
            pack_bf16((acc[4 * i + 2] + av0) * gelu_erf(acc[64 + 4 * i + 2] + gv0),
                      (acc[4 * i + 3] + av1) * gelu_erf(acc[64 + 4 * i + 3] + gv1));
      }
    }
  }
}

// ---- 3. GEMM 2: y = h W2^T + b2 (+ x), or one split's fp32 partial ---------------------
struct Out {
  __nv_bfloat16* y;
  float* ws;                    // [splits, M, C] partials (splits > 1)
  const __nv_bfloat16* x;       // residual, or nullptr
  const __nv_bfloat16* b2;
  int m, c, ksteps, per_split;  // k-steps in all and per split
};

__device__ __forceinline__ uint32_t out_pair(float v0, float v1, const Out& a, int row, int col) {
  v0 += bf(a.b2, col);
  v1 += bf(a.b2, col + 1);
  if (a.x != nullptr) {
    const size_t g = (size_t)row * a.c + col;
    v0 += bf(a.x, g);
    v1 += bf(a.x, g + 1);
  }
  return pack_bf16(v0, v1);
}

__global__ void __launch_bounds__(kThreads, 1)
    out_gemm_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                    const Out args) {
  using R = Ring<kBC, kStages2>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n0 = blockIdx.x * kBC, m0 = blockIdx.y * kBM, split = blockIdx.z;
  const int k0 = split * args.per_split, k1 = min(args.ksteps, k0 + args.per_split);
  init_ring(base + R::bar_off, base + R::bar_off + 8 * kStages2, kStages2);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) produce<kBC, kStages2>(base, &th, &tw, &tw, 1, m0, n0, k0, k1);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  float acc[kBC / 2];
  consume<kBC, kStages2>(acc, base, wg, k1 - k0);

  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = m0 + wg * 64 + (t / 32) * 16 + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
  const bool whole = gridDim.z == 1;
  float* part = args.ws + (size_t)split * args.m * args.c;
#pragma unroll
  for (int i = 0; i < kBC / 8; ++i) {
    const int col = n0 + 8 * i + col0;
    if (col < args.c) {  // c % 8 == 0 and col even: col + 1 < c too
      if (r_lo < args.m) {
        if (whole) {
          *reinterpret_cast<uint32_t*>(args.y + (size_t)r_lo * args.c + col) =
              out_pair(acc[4 * i], acc[4 * i + 1], args, r_lo, col);
        } else {
          *reinterpret_cast<float2*>(part + (size_t)r_lo * args.c + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
        }
      }
      if (r_hi < args.m) {
        if (whole) {
          *reinterpret_cast<uint32_t*>(args.y + (size_t)r_hi * args.c + col) =
              out_pair(acc[4 * i + 2], acc[4 * i + 3], args, r_hi, col);
        } else {
          *reinterpret_cast<float2*>(part + (size_t)r_hi * args.c + col) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        }
      }
    }
  }
}

// ---- 4. the split partials, added in a fixed order, with b2 and x ---------------------
__global__ void __launch_bounds__(256) split_sum_kernel(const Out args, int splits) {
  const size_t pairs = (size_t)args.m * args.c / 2;
  for (size_t p = blockIdx.x * (size_t)blockDim.x + threadIdx.x; p < pairs; p += (size_t)gridDim.x * blockDim.x) {
    const size_t g = 2 * p;
    float2 s = *reinterpret_cast<const float2*>(args.ws + g);
    for (int z = 1; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(args.ws + (size_t)z * args.m * args.c + g);
      s.x += v.x;
      s.y += v.y;
    }
    const int row = (int)(g / args.c), col = (int)(g % args.c);
    *reinterpret_cast<uint32_t*>(args.y + g) = out_pair(s.x, s.y, args, row, col);
  }
}

// ---- host side ------------------------------------------------------------------
template <typename Kernel>
static cudaError_t smem_attr(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* ln_w, const __nv_bfloat16* ln_b,
                       const __nv_bfloat16* w1, const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                       const __nv_bfloat16* b2, __nv_bfloat16* xn, __nv_bfloat16* h, float* ws, __nv_bfloat16* y,
                       int m, int c, int f, int splits, float eps, cudaStream_t stream) {
  const bool ln = ln_w != nullptr;
  const int m_tiles = (m + kBM - 1) / kBM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  const __nv_bfloat16* a = x;
  cudaError_t err;
  if (ln) {
    ln_rows_kernel<<<(m + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(x, ln_w, ln_b, xn, m, c, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    a = xn;
  }
  CUtensorMap ta, tv, tg, th, tw;
  if (!make_map_2d(&ta, a, m, c, kBM) || !make_map_2d(&tv, w1, f, c, kBF) ||
      !make_map_2d(&tg, w1 + (size_t)f * c, f, c, kBF) || !make_map_2d(&th, h, m, f, kBM) ||
      !make_map_2d(&tw, w2, c, f, kBC)) {
    return cudaErrorInvalidValue;
  }
  using R1 = Ring<2 * kBF, kStages1>;
  if ((err = smem_attr(geglu_gemm_kernel, R1::bytes)) != cudaSuccess) return err;
  const Geglu g1{h, b1, m, f, (c + kBK - 1) / kBK};
  geglu_gemm_kernel<<<dim3((f + kBF - 1) / kBF, m_tiles), kThreads, R1::bytes, stream>>>(ta, tv, tg, g1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int ksteps = (f + kBK - 1) / kBK;
  const int per_split = (ksteps + splits - 1) / splits;
  splits = (ksteps + per_split - 1) / per_split;  // no empty split
  using R2 = Ring<kBC, kStages2>;
  if ((err = smem_attr(out_gemm_kernel, R2::bytes)) != cudaSuccess) return err;
  const Out o{y, ws, ln ? x : nullptr, b2, m, c, ksteps, per_split};
  out_gemm_kernel<<<dim3((c + kBC - 1) / kBC, m_tiles, splits), kThreads, R2::bytes, stream>>>(th, tw, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const size_t pairs = (size_t)m * c / 2;
    const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
    split_sum_kernel<<<blocks, 256, 0, stream>>>(o, splits);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace ff_sm90
}  // namespace emox

// bf16 GEGLU feed-forward: x and y [m, c]; w1 [2f, c] and b1 [2f] (PyTorch
// Linear layout, value rows first, then gate rows); w2 [c, f]; b2 [c]. With
// ln_w and ln_b ([c]) the LayerNorm of x (eps) feeds W1 and x is added to the
// output; with ln_w null neither (K6). Scratch from the caller: xn [m, c]
// bf16 (with LN; else unused), h [m, f] bf16, and with splits > 1 ws
// [splits, m, c] fp32 (GEMM 2 splits F into that many parts, at most
// ceil(f / 64)). Contiguous, 16-byte aligned, c % 8 == 0, f % 8 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int emox_ff_sm90(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* xn, void* h, void* ws, void* y, int m, int c,
                            int f, int splits, float eps, void* stream) {
  using namespace emox::ff_sm90;
  using T = __nv_bfloat16;
  if (m <= 0 || c <= 0 || f <= 0 || c % 8 || f % 8 || splits < 1 || splits > (f + kBK - 1) / kBK ||
      (ln_w != nullptr && (ln_b == nullptr || xn == nullptr)) || (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run(static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
                  static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
                  static_cast<const T*>(b2), static_cast<T*>(xn), static_cast<T*>(h), static_cast<float*>(ws),
                  static_cast<T*>(y), m, c, f, splits, eps, static_cast<cudaStream_t>(stream));
}
