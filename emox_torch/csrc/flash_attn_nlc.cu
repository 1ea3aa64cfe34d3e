// Packed-layout flash-attention forward at head dim 512 for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_nlc_kernel` (emox/ops/attention.py:409,
// called by `_flash_impl_nlc`) where the head dim is 512: softmax(q k^T *
// scale) v on tokens laid out [N, L, H*D], with the per-head log-sum-exp
// written as lse [N, Lq, H] fp32. The model reaches it at the VAE's
// single-head mid-attention (4096 tokens at 512^2). Every head dim up to 256
// runs on flash_fwd_sm90.cu (bfloat16) or flash_attn.cu (float32); at 512
// their layouts would not fit a block's 227 KB of shared memory.
//
// What bounds it on the H100: the 16-frame decode at 512^2 does 4*N*L*L*d = 550 GFLOP against 403 MB of q, k, v
// and o, so the tensor cores bound it as at d 64. What changes is the room:
// a 32-row query tile [32, 512] and the fp32 output accumulator [32, 512]
// already take 99 KB in bf16 (132 KB in float32), so
//   * the query tile is 32 rows and eight warps share it: the S = q k^T
//     fragments of a key tile go one to a warp, each row's online softmax to
//     one warp (a lane per key), and the output's 16x16 fragments are spread
//     over the warps, each rescaling its own fragments by the row's alpha
//     before adding P v;
//   * K and V of a key tile are staged in turn through one buffer (K for S,
//     then V for P v), with 64 keys a tile in bf16 (176 KB in all) and 32 in
//     float32 (203 KB);
//   * one block per (32-row query tile, head, n): 128 blocks at the
//     reference image's encode (N 1), 2048 at the 16-frame decode;
//   * S = q k^T and P v on the tensor cores (WMMA, fp32 accumulation; 3xTF32
//     in float32), an fp32 online softmax with the running max and sum per
//     row, P rounded to the input type, the output divided by the sum at the
//     end; the ragged last K/V tile is zero-filled and its scores masked.
// This is the simple, right version: no TMA, no wgmma, no pipelining of the
// K/V loads (ROADMAP.md, Queue 2).
#include "common.cuh"

namespace emox {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr int kWideD = 512;
constexpr int kWideBQ = 32;
constexpr int kWideThreads = 256;  // 8 warps

template <typename T>
struct WideLayout {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // keys per K/V tile
  static constexpr int LDT = kWideD + Pad<T>::value;   // Q and the K-or-V tile (T)
  static constexpr int LDS = BK + 4;                   // scores (fp32)
  static constexpr int LDP = BK + Pad<T>::value;       // probabilities (T)
  static constexpr int LDO = kWideD + 4;               // output accumulator (fp32)
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = align128(q_off + sizeof(T) * kWideBQ * LDT);
  static constexpr size_t s_off = align128(kv_off + sizeof(T) * BK * LDT);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * kWideBQ * LDS);
  static constexpr size_t o_off = align128(p_off + sizeof(T) * kWideBQ * LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * kWideBQ * LDO);
  static constexpr size_t l_off = m_off + sizeof(float) * kWideBQ;
  static constexpr size_t a_off = l_off + sizeof(float) * kWideBQ;
  static constexpr size_t bytes = align128(a_off + sizeof(float) * kWideBQ);
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_attn_nlc_fwd_d512_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, T* __restrict__ o,
                                   float* __restrict__ lse, int lq, int lk, int heads,
                                   float scale) {
  using Lay = WideLayout<T>;
  using M = Mma<T>;
  constexpr int D = kWideD;
  constexpr int BQ = kWideBQ;
  constexpr int BK = Lay::BK;
  constexpr int WARPS = kWideThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q_off);
  T* KVs = reinterpret_cast<T*>(smem + Lay::kv_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p_off);
  float* Os = reinterpret_cast<float*>(smem + Lay::o_off);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m_off);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l_off);
  float* a_s = reinterpret_cast<float*>(smem + Lay::a_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t c = (size_t)heads * D;  // row stride of the packed layout
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qn = q + (size_t)n * lq * c + (size_t)h * D;
  const T* kn = k + (size_t)n * lk * c + (size_t)h * D;
  const T* vn = v + (size_t)n * lk * c + (size_t)h * D;

  load_rows<T>(Qs, Lay::LDT, qn, c, q0, BQ, lq, D);
  for (int i = threadIdx.x; i < BQ * D; i += kWideThreads) Os[(i / D) * Lay::LDO + i % D] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kWideThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int j0 = 0; j0 < lk; j0 += BK) {
    __syncthreads();  // the previous tile's V is no longer read
    load_rows<T>(KVs, Lay::LDT, kn, c, j0, BK, lk, D);
    __syncthreads();

    // S = q k^T: one 16x16 fragment per warp
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += WARPS) {
      const int mi = t / (BK / 16);
      const int nj = t % (BK / 16);
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 8
      for (int kk = 0; kk < D; kk += M::K) {
        M::template step<wmma::col_major>(acc, Qs + (mi * 16) * Lay::LDT + kk, Lay::LDT,
                                          KVs + (nj * 16) * Lay::LDT + kk, Lay::LDT);
      }
      wmma::store_matrix_sync(Ss + (mi * 16) * Lay::LDS + nj * 16, acc, Lay::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();  // S complete, K no longer read

    // V into the buffer K used, while the warps run the online softmax (a
    // warp per row, a lane per key)
    load_rows<T>(KVs, Lay::LDT, vn, c, j0, BK, lk, D);
    for (int row = warp; row < BQ; row += WARPS) {
      float s[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int col = lane + 32 * e;
        s[e] = j0 + col < lk ? Ss[row * Lay::LDS + col] * scale : kNegInf;
        mx = fmaxf(mx, s[e]);
      }
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const float p = expf(s[e] - m_new);
        Ps[row * Lay::LDP + lane + 32 * e] = from_float<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      __syncwarp();  // every lane has read m_s[row]
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();  // P, alpha and V in place

    // O = alpha * O + P v, fragment by fragment; a warp rescales the
    // fragments it owns before accumulating into them
    for (int t = warp; t < (BQ / 16) * (D / 16); t += WARPS) {
      const int mi = t / (D / 16);
      const int nj = t % (D / 16);
      float* op = Os + (mi * 16) * Lay::LDO + nj * 16;
      for (int i = lane; i < 256; i += 32) op[(i / 16) * Lay::LDO + i % 16] *= a_s[mi * 16 + i / 16];
      __syncwarp();
      typename M::Acc acc;
      wmma::load_matrix_sync(acc, op, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += M::K) {
        M::template step<wmma::row_major>(acc, Ps + (mi * 16) * Lay::LDP + kk, Lay::LDP,
                                          KVs + kk * Lay::LDT + nj * 16, Lay::LDT);
      }
      wmma::store_matrix_sync(op, acc, Lay::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // epilogue (l clamped as the TPU kernel's l_safe)
  for (int i = threadIdx.x; i < BQ * D; i += kWideThreads) {
    const int row = i / D;
    const int col = i % D;
    const int qi = q0 + row;
    if (qi < lq) {
      o[(size_t)n * lq * c + (size_t)qi * c + (size_t)h * D + col] =
          from_float<T>(Os[row * Lay::LDO + col] / fmaxf(l_s[row], 1e-20f));
    }
  }
  for (int row = threadIdx.x; row < BQ; row += kWideThreads) {
    const int qi = q0 + row;
    if (qi < lq) lse[((size_t)n * lq + qi) * heads + h] = m_s[row] + logf(fmaxf(l_s[row], 1e-20f));
  }
}

template <typename T>
static cudaError_t launch_flash_d512(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int n, int lq, int lk, int heads, float scale,
                                     cudaStream_t stream) {
  using Lay = WideLayout<T>;
  auto kernel = flash_attn_nlc_fwd_d512_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kWideBQ - 1) / kWideBQ, heads, n);
  kernel<<<grid, kWideThreads, Lay::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), lq, lk, heads, scale);
  return cudaGetLastError();
}

}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16. q [n, lq, heads*512], k and v
// [n, lk, heads*512], o like q, lse [n, lq, heads] float32; all contiguous,
// 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_attn_nlc_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int n, int lq, int lk, int heads, int head_dim,
                                       float scale, int dtype, void* stream) {
  using namespace emox;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || n > 65535 || heads > 65535 || head_dim != kWideD) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) return (int)launch_flash_d512<__nv_bfloat16>(q, k, v, o, lse, n, lq, lk, heads, scale, s);
  if (dtype == 0) return (int)launch_flash_d512<float>(q, k, v, o, lse, n, lq, lk, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
