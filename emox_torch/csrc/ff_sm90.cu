// The GEGLU feed-forward for Hopper (sm_90a): wgmma + TMA GEMMs, in bf16 and,
// on the two-part split, in float32.
//
//   y = [x +] W2 (a * gelu(g)) + b2,   [a | g] = [LN](x) W1 + b1
//
// Replaces the TPU kernels `_ln_ff_kernel` and `_ln_ff_wide_kernel`
// (emox/ops/ff.py:102,120: LayerNorm, the gated FF and the residual; every
// FF sub-layer of the model) and `_ff_kernel` (:455: the gated FF alone,
// behind `fused_geglu_ff`), in both types: bf16 (emox_ff_sm90) and float32
// (emox_ff_f32_sm90).
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
// rows; the main loop is gemm_sm90.cuh's. Ragged edges: rows past M,
// columns past C or F and depth past the contraction arrive as zeros (TMA's
// out-of-bounds fill) and the epilogues store only what lies inside, so any
// M, and C and F that keep rows 16-byte aligned (multiples of 8 in bf16, of
// 4 in float32), are taken. Each consumer keeps one wgmma group in flight
// and hands a stage back once the group that read it is done.
//
// Float32 (PARTS 2) runs the same kernels on bf16 wgmma over the two-part
// split: every operand becomes bf16 scratch [rows, 2w], hi in columns
// [0, w) and lo in [w, 2w), w the contraction padded to 64 with zeros (a hi
// box never reads the lo part), and every product runs as a_hi b_hi + a_hi
// b_lo + a_lo b_hi with fp32 accumulation (about 16 of float32's 24 bits of
// each operand; 3xTF32 kept about 21). The LN pass (gemm_sm90.cuh's
// ln_rows_kernel) writes xn's parts; without LN x is split instead, in the
// one launch that splits W1 and W2 at every call (no cache: an optimizer
// step updates the weights in place). GEMM 1's epilogue writes h's parts
// from its fp32 registers (h is not rounded in float32), zero past F;
// GEMM 2 adds b2 and x in fp32 and writes y in float32. A stage holds both
// parts of A and of B, twice bf16's bytes, so the rings are shorter: GEMM 1
// 2 stages of 96 KB, GEMM 2 3 of 72 KB. What bounds it on the H100 at the
// float32 step's level 0 (M 4096, C 320, F 1280): the three products a
// step issue 3 x 6*M*C*F = 30 GFLOP of bf16 work (0.031 ms at 989
// TFLOP/s), float32 on the CUDA cores would take 0.150 ms (67 TFLOP/s).
// Not yet done: LN folded into GEMM 1, a persistent grid whose
// epilogue overlaps the next tile's loads, TMA stores, keeping h on chip.
#include "gemm_sm90.cuh"

namespace emox {
namespace ff_sm90 {

using namespace emox::sm90;
using namespace emox::gemm_sm90;

constexpr int kBF = 128;  // GEMM 1: hidden features per block
constexpr int kBC = 160;  // GEMM 2: output columns per block

// The rings' stages: a float32 stage (PARTS 2) holds both parts
template <int PARTS>
struct Stages {
  static constexpr int gemm1 = PARTS == 1 ? 4 : 2;
  static constexpr int gemm2 = PARTS == 1 ? 5 : 3;
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

// 1. LayerNorm rows: gemm_sm90.cuh's ln_rows_kernel (bf16: xn rounded to bf16;
// float32: xn's parts)

// ---- 2. GEMM 1 + GEGLU: h = (xn W1v^T + b1v) * gelu(xn W1g^T + b1g) ------------------
template <typename T>
struct Geglu {
  __nv_bfloat16* h;  // bf16: [M, F]; float32: h's parts [M, 2 wh]
  const T* b1;
  int m, f, ksteps;
  int w, wh;  // float32: the lo parts' column in A and W1, and h's part width
};

// One pair of h's columns (col, col + 1) of one row: bf16 rounded, or its
// two parts in float32 (PARTS 2)
template <int PARTS>
__device__ __forceinline__ void store_h(__nv_bfloat16* h, int f, int wh, int row, int col, float v0, float v1) {
  if constexpr (PARTS == 1) {
    *reinterpret_cast<uint32_t*>(h + (size_t)row * f + col) = pack_bf16(v0, v1);
  } else {
    uint32_t hi, lo;
    split_pair(v0, v1, hi, lo);
    __nv_bfloat16* p = h + (size_t)row * 2 * wh + col;
    *reinterpret_cast<uint32_t*>(p) = hi;
    *reinterpret_cast<uint32_t*>(p + wh) = lo;
  }
}

template <int PARTS, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg, const Geglu<T> args) {
  constexpr int STAGES = Stages<PARTS>::gemm1;
  using R = Ring<2 * kBF, STAGES, PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle reads address bits 4-9
  const int n0 = blockIdx.x * kBF, m0 = blockIdx.y * kBM;
  init_ring(base + R::bar_off, base + R::bar_off + 8 * STAGES, STAGES);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) produce<2 * kBF, STAGES, PARTS>(base, &ta, &tv, &tg, 2, m0, n0, 0, args.ksteps, args.w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  float acc[kBF];  // [0, 64): value columns, [64, 128): the same columns of the gate
  consume<2 * kBF, STAGES, PARTS>(acc, base, wg, args.ksteps);

  // acc[4i + e] is row r_lo (e < 2) or r_lo + 8, feature n0 + 8i + col0 + e % 2.
  // Float32 writes h's parts up to their padded width wh: past F the
  // accumulators hold TMA's zero fill, and with no bias there h is 0.
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = m0 + wg * 64 + (t / 32) * 16 + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
  const int cols = PARTS == 1 ? args.f : args.wh;
#pragma unroll
  for (int i = 0; i < kBF / 8; ++i) {
    const int col = n0 + 8 * i + col0;
    if (col < cols) {  // f % 8 == 0 (bf16) or % 4 (float32) and col even: col + 1 < f too where col < f
      const bool in = PARTS == 1 || col < args.f;
      const float av0 = in ? ld(args.b1, col) : 0.f, av1 = in ? ld(args.b1, col + 1) : 0.f;
      const float gv0 = in ? ld(args.b1, args.f + col) : 0.f, gv1 = in ? ld(args.b1, args.f + col + 1) : 0.f;
      if (r_lo < args.m) {
        store_h<PARTS>(args.h, args.f, args.wh, r_lo, col, (acc[4 * i] + av0) * gelu_erf(acc[64 + 4 * i] + gv0),
                       (acc[4 * i + 1] + av1) * gelu_erf(acc[64 + 4 * i + 1] + gv1));
      }
      if (r_hi < args.m) {
        store_h<PARTS>(args.h, args.f, args.wh, r_hi, col, (acc[4 * i + 2] + av0) * gelu_erf(acc[64 + 4 * i + 2] + gv0),
                       (acc[4 * i + 3] + av1) * gelu_erf(acc[64 + 4 * i + 3] + gv1));
      }
    }
  }
}

// ---- 3. GEMM 2: y = h W2^T + b2 (+ x), or one split's fp32 partial ---------------------
template <typename T>
struct Out {
  T* y;
  float* ws;                    // [splits, M, C] partials (splits > 1)
  const T* x;                   // residual, or nullptr
  const T* b2;
  int m, c, ksteps, per_split;  // k-steps in all and per split
};

template <typename T>
__device__ __forceinline__ void out_pair(float v0, float v1, const Out<T>& a, int row, int col) {
  const size_t g = (size_t)row * a.c + col;
  v0 += ld(a.b2, col);
  v1 += ld(a.b2, col + 1);
  if (a.x != nullptr) {
    v0 += ld(a.x, g);
    v1 += ld(a.x, g + 1);
  }
  store_pair<T>(a.y + g, v0, v1);
}

template <int PARTS, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    out_gemm_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                    const Out<T> args, int w) {  // w: float32's lo parts' column in h and W2
  constexpr int STAGES = Stages<PARTS>::gemm2;
  using R = Ring<kBC, STAGES, PARTS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n0 = blockIdx.x * kBC, m0 = blockIdx.y * kBM, split = blockIdx.z;
  const int k0 = split * args.per_split, k1 = min(args.ksteps, k0 + args.per_split);
  init_ring(base + R::bar_off, base + R::bar_off + 8 * STAGES, STAGES);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) produce<kBC, STAGES, PARTS>(base, &th, &tw, &tw, 1, m0, n0, k0, k1, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  float acc[kBC / 2];
  consume<kBC, STAGES, PARTS>(acc, base, wg, k1 - k0);

  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = m0 + wg * 64 + (t / 32) * 16 + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
  const bool whole = gridDim.z == 1;
  float* part = args.ws + (size_t)split * args.m * args.c;
#pragma unroll
  for (int i = 0; i < kBC / 8; ++i) {
    const int col = n0 + 8 * i + col0;
    if (col < args.c) {  // c even and col even: col + 1 < c too
      if (r_lo < args.m) {
        if (whole) {
          out_pair(acc[4 * i], acc[4 * i + 1], args, r_lo, col);
        } else {
          *reinterpret_cast<float2*>(part + (size_t)r_lo * args.c + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
        }
      }
      if (r_hi < args.m) {
        if (whole) {
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
template <typename T>
__global__ void __launch_bounds__(256) split_sum_kernel(const Out<T> args, int splits) {
  const size_t pairs = (size_t)args.m * args.c / 2;
  for (size_t p = blockIdx.x * (size_t)blockDim.x + threadIdx.x; p < pairs; p += (size_t)gridDim.x * blockDim.x) {
    const size_t g = 2 * p;
    float2 s = *reinterpret_cast<const float2*>(args.ws + g);
    for (int z = 1; z < splits; ++z) {
      const float2 v = *reinterpret_cast<const float2*>(args.ws + (size_t)z * args.m * args.c + g);
      s.x += v.x;
      s.y += v.y;
    }
    out_pair(s.x, s.y, args, (int)(g / args.c), (int)(g % args.c));
  }
}

// ---- host side ------------------------------------------------------------------
// The caller's scratch: bf16 xn [M, C] (with LN), h [M, F] and fp32 ws
// [splits, M, C] (splits > 1); float32 adds the parts of W1 and W2 and holds
// x's or xn's parts in xn [M, 2wc] and h's in h [M, 2wf].
struct Scratch {
  __nv_bfloat16 *xn, *w1, *w2, *h;
  float* ws;
};

template <int PARTS, typename T>
static cudaError_t run(const T* x, const T* ln_w, const T* ln_b, const T* w1, const T* b1, const T* w2, const T* b2,
                       const Scratch& s, T* y, int m, int c, int f, int splits, float eps, cudaStream_t stream) {
  const bool ln = ln_w != nullptr;
  const int m_tiles = (m + kBM - 1) / kBM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err;
  CUtensorMap ta, tv, tg, th, tw;
  int wc = 0, wf = 0;  // float32: the parts' widths of the contractions over C and F
  if constexpr (PARTS == 1) {
    const __nv_bfloat16* a = x;
    if (ln) {
      if ((err = ln_rows(x, ln_w, ln_b, s.xn, m, c, c, eps, stream)) != cudaSuccess) return err;
      a = s.xn;
    }
    if (!make_map_2d(&ta, a, m, c, kBM) || !make_map_2d(&tv, w1, f, c, kBF) ||
        !make_map_2d(&tg, w1 + (size_t)f * c, f, c, kBF) || !make_map_2d(&th, s.h, m, f, kBM) ||
        !make_map_2d(&tw, w2, c, f, kBC)) {
      return cudaErrorInvalidValue;
    }
  } else {
    wc = split_width(c);
    wf = split_width(f);
    SplitJobs jobs{{{w1, s.w1, 2 * f, c, wc}, {w2, s.w2, c, f, wf}}, 2};
    if (ln) {
      if ((err = ln_rows(x, ln_w, ln_b, s.xn, m, c, wc, eps, stream)) != cudaSuccess) return err;
    } else {
      jobs.job[jobs.count++] = SplitJob{x, s.xn, m, c, wc};
    }
    if ((err = split_matrices(jobs, stream)) != cudaSuccess) return err;
    if (!make_map_2d(&ta, s.xn, m, 2 * wc, kBM) || !make_map_2d(&tv, s.w1, f, 2 * wc, kBF) ||
        !make_map_2d(&tg, s.w1 + (size_t)f * 2 * wc, f, 2 * wc, kBF) || !make_map_2d(&th, s.h, m, 2 * wf, kBM) ||
        !make_map_2d(&tw, s.w2, c, 2 * wf, kBC)) {
      return cudaErrorInvalidValue;
    }
  }
  using R1 = Ring<2 * kBF, Stages<PARTS>::gemm1, PARTS>;
  if ((err = smem_attr(geglu_gemm_kernel<PARTS, T>, R1::bytes)) != cudaSuccess) return err;
  const Geglu<T> g1{s.h, b1, m, f, (c + kBK - 1) / kBK, wc, wf};
  geglu_gemm_kernel<PARTS, T><<<dim3((f + kBF - 1) / kBF, m_tiles), kThreads, R1::bytes, stream>>>(ta, tv, tg, g1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int ksteps = (f + kBK - 1) / kBK;
  const int per_split = (ksteps + splits - 1) / splits;
  splits = (ksteps + per_split - 1) / per_split;  // no empty split
  using R2 = Ring<kBC, Stages<PARTS>::gemm2, PARTS>;
  if ((err = smem_attr(out_gemm_kernel<PARTS, T>, R2::bytes)) != cudaSuccess) return err;
  const Out<T> o{y, s.ws, ln ? x : nullptr, b2, m, c, ksteps, per_split};
  out_gemm_kernel<PARTS, T><<<dim3((c + kBC - 1) / kBC, m_tiles, splits), kThreads, R2::bytes, stream>>>(th, tw, o,
                                                                                                        wf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const size_t pairs = (size_t)m * c / 2;
    const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
    split_sum_kernel<T><<<blocks, 256, 0, stream>>>(o, splits);
    err = cudaGetLastError();
  }
  return err;
}

static bool bad_shape(const void* ln_w, const void* ln_b, const void* xn, const void* ws, int m, int c, int f,
                      int splits, int mult) {
  return m <= 0 || c <= 0 || f <= 0 || c % mult || f % mult || splits < 1 || splits > (f + kBK - 1) / kBK ||
         (ln_w != nullptr && (ln_b == nullptr || xn == nullptr)) || (splits > 1 && ws == nullptr);
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
  if (bad_shape(ln_w, ln_b, xn, ws, m, c, f, splits, 8)) return (int)cudaErrorInvalidValue;
  const Scratch s{static_cast<T*>(xn), nullptr, nullptr, static_cast<T*>(h), static_cast<float*>(ws)};
  return (int)run<1>(static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
                     static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
                     static_cast<const T*>(b2), s, static_cast<T*>(y), m, c, f, splits, eps,
                     static_cast<cudaStream_t>(stream));
}

// float32 GEGLU feed-forward on the two-part split: the operands as
// emox_ff_sm90's, in float32. Scratch from the caller, bf16 (wc and wf: c and
// f padded to multiples of 64): xp [m, 2wc] (x's parts, or with LN xn's),
// w1p [2f, 2wc], w2p [c, 2wf], hp [m, 2wf], and with splits > 1 ws [splits,
// m, c] fp32. Contiguous, 16-byte aligned, c % 4 == 0, f % 4 == 0.
extern "C" int emox_ff_f32_sm90(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* xp, void* w1p, void* w2p, void* hp, void* ws,
                                void* y, int m, int c, int f, int splits, float eps, void* stream) {
  using namespace emox::ff_sm90;
  using B = __nv_bfloat16;
  using T = float;
  if (bad_shape(ln_w, ln_b, xp, ws, m, c, f, splits, 4) || xp == nullptr || w1p == nullptr || w2p == nullptr ||
      hp == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Scratch s{static_cast<B*>(xp), static_cast<B*>(w1p), static_cast<B*>(w2p), static_cast<B*>(hp),
                  static_cast<float*>(ws)};
  return (int)run<2>(static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(ln_b),
                     static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
                     static_cast<const T*>(b2), s, static_cast<T*>(y), m, c, f, splits, eps,
                     static_cast<cudaStream_t>(stream));
}
