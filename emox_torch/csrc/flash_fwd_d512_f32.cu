// Flash-attention forward at head dim 512 in float32 for Hopper (sm_90a):
// bf16 wgmma on an error-compensated split, TMA, the head dim split over a
// cluster of two blocks.
//
// Replaces the TPU kernel `_flash_nlc_kernel` (emox/ops/attention.py:409,
// called at :629) where the head dim is 512 and the type float32:
// softmax(q k^T * scale) v with the per-row log-sum-exp lse in fp32. The
// model reaches it at the float32 VAE's single-head mid-attention (the
// vae512 and train_step_vae checks hold the card against the CPU there).
// bf16 at head dim 512 runs on flash_fwd_sm90.cu's fwd_wide_kernel.
//
// Float32 on the tensor cores: every operand x is split into two bf16
// parts, x_hi = bf16(x) and x_lo = bf16(x - x_hi), which hold 16 of float32's
// 24 mantissa bits, and every product a b runs as a_hi b_hi + a_hi b_lo +
// a_lo b_hi on bf16 wgmma with fp32 accumulation. The dropped a_lo b_lo and
// the split's remainder are each about 2^-18 of |a b|, well below the
// 2e-4-of-the-largest-output bar (tests/test_torch_d512_sm90.py holds a
// numpy twin of the split against fp64 at L 1024). split.cuh's split launch
// writes q, k and v into [B, H, L, 1024] bf16 scratch (hi in columns 0-511,
// lo in 512-1023) before the attention kernel runs; P is split in registers.
//
// What bounds it on the H100: at N 1, L 4096 the function is 4*N*L*L*d =
// 34.4 GFLOP, 0.513 ms at the CUDA cores' 67 TFLOP/s (float32 without the
// tensor cores); the three bf16 products this kernel issues for each are
// 103 GFLOP, 0.104 ms at 989 TFLOP/s. The room: at float32 a 64-row Q tile
// of width 512 alone is 128 KB, and its two bf16 parts are as large. The
// design, shaped like fwd_wide_kernel (flash_fwd_sm90.cu) and like the dq
// kernel of flash_bwd_d512_sm90.cu:
//   * a cluster of two blocks per 64 query rows, each owning one 256-column
//     half of the head dim: it loads only its half of Q, K and V (both parts,
//     TMA, 64-column boxes), computes its half's partial S (m64n32 wgmma,
//     three products), sends it to the other block's shared memory and adds
//     the other's (a + b == b + a: both blocks hold the same bits of S, so
//     the same softmax), and owns its half of O;
//   * one producer warp streams 64-key K and V tiles (both parts: 64 KB
//     each, one stage each, K refilled once both S products of a tile are
//     done, V once both P v are); consumer warpgroup w takes keys
//     32w..32w+31 of every tile, with its own online softmax (max and sum per
//     row) and its own O_w [64, 256] fp32 (128 registers): three m64n256
//     products per 16 keys, P split in registers as the register A operand;
//   * at the end warpgroup 1 hands (O_1, m_1, l_1) through shared memory and
//     warpgroup 0 merges them as split-K flash attention does,
//     O = (O_0 2^(m_0 - m) + O_1 2^(m_1 - m)) / (l_0 2^(m_0 - m) + l_1 2^(m_1 - m)),
//     stores its block's half of O and (rank 0) lse;
//   * keys past Lk of the ragged last tile arrive zero-filled and get P = 0;
//     rows past Lq are not stored.
// Not yet done: more than one K/V stage (no room), overlap of the exchange
// with the products.
#include <cooperative_groups.h>

#include "split.cuh"

namespace emox {
namespace fwd_d512_f32 {

using namespace emox::sm90;
namespace coop = cooperative_groups;

constexpr int kHalf = 256;                // head-dim columns a block of the pair owns
constexpr int kThreads = 384;             // warpgroups 0, 1: consumers; 2: producer
constexpr float kNegInf = -1e30f;         // the TPU kernel's _NEG_INF
constexpr uint32_t kBox = 64 * 128;       // one 64-row x 64-column bf16 box
constexpr uint32_t kPart = 4 * 128 * 16;  // one warpgroup's [64, 32] fp32 partial, in fragment order

struct Smem {
  static constexpr uint32_t q_off = 0;         // Q: 4 boxes of hi (this half), then 4 of lo
  static constexpr uint32_t k_off = 8 * kBox;  // one K tile of 64 keys, hi then lo
  static constexpr uint32_t v_off = 16 * kBox; // one V tile
  static constexpr uint32_t xch_off = 24 * kBox;  // [warpgroup] the peer's S partial
  static constexpr uint32_t bar_off = xch_off + 2 * kPart;
  // q_full, k_full, k_empty, v_full, v_empty, in_full[2], out_free[2]
  static constexpr uint32_t bytes = bar_off + 8 * 9 + 1024;  // + alignment slack
  static_assert(128 * 32 * 16 <= 16 * kBox, "O_1 staging fits the K and V tiles");
  static_assert(bytes <= 232448, "shared memory of a block");
};

struct Out {
  float* o;
  float* lse;
  long long o_b, o_h, o_r;  // element strides of o (batch, head, row)
  long long l_b, l_h, l_r;  // element strides of lse
  int lq, lk;
  float scale_log2;         // scale * log2(e): the softmax runs in base 2
};

__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Out args) {
  using S = Smem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));  // `base` as a generic pointer
  const uint32_t q_full = base + S::bar_off;
  const uint32_t k_full = q_full + 8, k_empty = q_full + 16;  // K arrived / both S products done
  const uint32_t v_full = q_full + 24, v_empty = q_full + 32;  // V arrived / both P v done
  const uint32_t in_full0 = q_full + 40;   // in_full[w]: the peer's warpgroup w sent its partial
  const uint32_t out_free0 = q_full + 56;  // out_free[w]: the peer's warpgroup w read ours
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x >> 1) * 64;
  const int c0 = rank * kHalf;  // this block's head-dim columns (of each part)
  const int tiles = (args.lk + 63) / 64;
  coop::cluster_group cluster = coop::this_cluster();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 2 * 128);
    mbar_init(v_empty, 2 * 128);
    for (int w = 0; w < 2; ++w) {  // armed for the peer's bytes; one arrival frees
      mbar_init(in_full0 + 8 * w, 1);
      mbar_init(out_free0 + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // both blocks' barriers exist before either arrives on the other's

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 8 * kBox);
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(base + S::q_off + c * kBox, &tq, q_full, c0 + 64 * c, q0, h, b);
        tma_load_4d(base + S::q_off + (4 + c) * kBox, &tq, q_full, 512 + c0 + 64 * c, q0, h, b);
      }
      for (int j = 0; j < tiles; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        mbar_expect_tx(k_full, 8 * kBox);
        for (int c = 0; c < 4; ++c) {
          tma_load_4d(base + S::k_off + c * kBox, &tk, k_full, c0 + 64 * c, j * 64, h, b);
          tma_load_4d(base + S::k_off + (4 + c) * kBox, &tk, k_full, 512 + c0 + 64 * c, j * 64, h, b);
        }
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_full, 8 * kBox);
        for (int c = 0; c < 4; ++c) {
          tma_load_4d(base + S::v_off + c * kBox, &tv, v_full, c0 + 64 * c, j * 64, h, b);
          tma_load_4d(base + S::v_off + (4 + c) * kBox, &tv, v_full, 512 + c0 + 64 * c, j * 64, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    const uint32_t keys = wg * 32 * 128;      // this warpgroup's 32 keys within each box
    const uint32_t slot = base + S::xch_off + wg * kPart;
    const uint32_t in_full = in_full0 + 8 * wg, out_free = out_free0 + 8 * wg;
    const uint32_t peer_out_free = map_rank(out_free, peer);
    float o[128];  // O_w: this block's 256 columns, over this warpgroup's keys
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2) of each row
    float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the running sum

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      mbar_wait(k_full, j & 1);
      // partial S = Q K^T over this block's columns: hi hi + hi lo + lo hi
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      fence_regs<16>(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t qh = smem_desc(base + S::q_off + c * kBox + kk * 32, 16, 1024);
          const uint64_t ql = smem_desc(base + S::q_off + (4 + c) * kBox + kk * 32, 16, 1024);
          const uint64_t kh = smem_desc(base + S::k_off + c * kBox + keys + kk * 32, 16, 1024);
          const uint64_t kl = smem_desc(base + S::k_off + (4 + c) * kBox + keys + kk * 32, 16, 1024);
          Wgmma<32>::ss(sc, qh, kh, c + kk > 0);
          Wgmma<32>::ss(sc, qh, kl, 1);
          Wgmma<32>::ss(sc, ql, kh, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<16>(sc);
      mbar_arrive(k_empty);

      // the exchange: our partial into the peer's slot, then theirs from ours
      if (j > 0) mbar_wait_cluster(out_free, (j - 1) & 1);
      if (t == 0) mbar_expect_tx(in_full, kPart);  // the peer's partial of this tile
      send_part<16>(slot, in_full, peer, sc, t);
      mbar_wait_cluster(in_full, j & 1);
      add_part<16>(sc, gbase + (slot - base), t);
      warpgroup_sync(wg);
      if (t == 0) mbar_arrive_cluster(peer_out_free);

      // online softmax in base 2 on this warpgroup's keys: sc[4i + e] is row
      // row_lo (e < 2) or row_lo + 8, key 8i + col0 + e % 2 of its 32
      const bool ragged = (j + 1) * 64 > args.lk;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool masked = ragged && j * 64 + wg * 32 + 8 * (i / 4) + col0 + (i % 2) >= args.lk;
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
      for (int i = 0; i < 16; ++i) {
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
      for (int i = 0; i < 128; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

      // O_w += P V: P's parts are the register A operand (keys 16k..16k+15
      // are sc[8k..8k+7], in pairs); V's parts are MN-major B operands
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) split_pair(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1], ph[k][r], pl[k][r]);
      }
      mbar_wait(v_full, j & 1);
      fence_regs<128>(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint64_t vh = smem_desc(base + S::v_off + keys + k * 16 * 128, kBox, 1024);
        const uint64_t vl = smem_desc(base + S::v_off + 4 * kBox + keys + k * 16 * 128, kBox, 1024);
        WgmmaRS<256>::rs(o, ph[k], vh);
        WgmmaRS<256>::rs(o, ph[k], vl);
        WgmmaRS<256>::rs(o, pl[k], vh);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<128>(o);
      mbar_arrive(v_empty);
    }

    // merge warpgroup 1's (O_1, m_1, l_1) into warpgroup 0's
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    consumers_sync();  // both warpgroups are done with K, V and the exchange slots
    float4* stage = reinterpret_cast<float4*>(gbase + S::k_off);
    float* stat = reinterpret_cast<float*>(gbase + S::xch_off);  // [row]: m_1, l_1
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) stage[i * 128 + t] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
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
      const float mm_lo = fmaxf(m_lo, m1_lo), mm_hi = fmaxf(m_hi, m1_hi);
      const float a0_lo = exp2f(m_lo - mm_lo), a1_lo = exp2f(m1_lo - mm_lo);
      const float a0_hi = exp2f(m_hi - mm_hi), a1_hi = exp2f(m1_hi - mm_hi);
      const float ls_lo = fmaxf(l_lo * a0_lo + l1_lo * a1_lo, 1e-20f);  // as the TPU kernel's l_safe
      const float ls_hi = fmaxf(l_hi * a0_hi + l1_hi * a1_hi, 1e-20f);
      const float inv_lo = 1.f / ls_lo, inv_hi = 1.f / ls_hi;
      const int r_lo = q0 + row_lo, r_hi = r_lo + 8;
      float* ob = args.o + b * args.o_b + h * args.o_h + c0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float4 p = stage[i * 128 + t];
        const int col = 8 * i + col0;
        if (r_lo < args.lq) {
          *reinterpret_cast<float2*>(ob + r_lo * args.o_r + col) =
              make_float2((o[4 * i] * a0_lo + p.x * a1_lo) * inv_lo, (o[4 * i + 1] * a0_lo + p.y * a1_lo) * inv_lo);
        }
        if (r_hi < args.lq) {
          *reinterpret_cast<float2*>(ob + r_hi * args.o_r + col) =
              make_float2((o[4 * i + 2] * a0_hi + p.z * a1_hi) * inv_hi, (o[4 * i + 3] * a0_hi + p.w * a1_hi) * inv_hi);
        }
      }
      if (rank == 0 && lane % 4 == 0) {  // both blocks hold the same statistics
        float* lb = args.lse + b * args.l_b + h * args.l_h;
        constexpr float kLn2 = 0.6931471805599453f;
        if (r_lo < args.lq) lb[r_lo * args.l_r] = (mm_lo + log2f(ls_lo)) * kLn2;
        if (r_hi < args.lq) lb[r_hi * args.l_r] = (mm_hi + log2f(ls_hi)) * kLn2;
      }
    }
  }
  cluster.sync();  // no block leaves while its partner may still arrive on its barriers
}

}  // namespace fwd_d512_f32
}  // namespace emox

// float32 attention forward at head dim 512 on [batch, heads, L, 512]
// operands with element strides: `strides` holds (batch, head, row) for q,
// k, v, o and lse in that order (15 values), the head dim contiguous; q, k,
// v, o with 16-byte aligned base pointers and rows. q2, k2, v2: bf16 scratch
// of [batch, heads, lq or lk, 1024] elements, contiguous, which this call
// fills with the operands' parts before the attention kernel reads them.
// Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_d512_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                       const long long* strides, int batch, int heads, int lq, int lk, float scale,
                                       void* q2, void* k2, void* v2, void* stream) {
  using namespace emox::sm90;
  using namespace emox::fwd_d512_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const void* src[3] = {q, k, v};
  void* parts[3] = {q2, k2, v2};
  const int lens[3] = {lq, lk, lk};
  long long sq[3], skv[3];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = split_operand(src[i], strides + 3 * i, batch, heads, lens[i], 512, 512, parts[i], s);
    if (err != cudaSuccess) return (int)err;
  }
  scratch_strides(sq, heads, lq, 512);
  scratch_strides(skv, heads, lk, 512);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q2, batch, heads, lq, 1024, sq, 64) || !make_map(&tk, k2, batch, heads, lk, 1024, skv, 64) ||
      !make_map(&tv, v2, batch, heads, lk, 1024, skv, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* so = strides + 9;
  const long long* sl = strides + 12;
  const Out out{static_cast<float*>(o), static_cast<float*>(lse), so[0], so[1], so[2], sl[0], sl[1], sl[2], lq, lk,
                scale * kLog2e};
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem::bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((lq + 63) / 64), heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem::bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fwd_kernel, tq, tk, tv, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
