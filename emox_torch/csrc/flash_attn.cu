// Float32 flash-attention forward for Hopper (sm_90a), both layouts.
//
// Replaces, in float32, the TPU kernels `_flash_kernel` (emox/ops/
// attention.py:69, [B, H, L, D] operands) and `_flash_nlc_kernel` (:409, the
// packed [N, L, H*D] layout, which reaches this kernel as head-split views):
// softmax(q k^T * scale) v, with the per-row log-sum-exp written as lse
// [B, H, Lq] fp32 for the backward pass. bfloat16 runs on the wgmma + TMA
// kernel in flash_fwd_sm90.cu; this one exists so that a float32 model on the
// card can be held against the same model on the CPU at float32 tolerance
// (its products are 3xTF32 WMMA, common.cuh), and its speed is not a goal.
//
// What bounds it on the H100: at the float32 serving shape of the flagship
// (N 32, H 5, Lq 1024, Lk 2048, d 64) it does 4*N*H*Lq*Lk*d = 86 GFLOP,
// 1.28 ms at the card's float32 rate (67 TFLOP/s), far above the memory's
// time; its three TF32 products per product run on the tensor cores (495
// TFLOP/s in TF32). The design keeps the [Lq, Lk] scores out of device
// memory:
//   * q, k, v and out come with element strides for batch, head and row (the
//     head dim contiguous), so head-split views of packed tokens need no
//     transpose or copy;
//   * the head dim is zero-padded in shared memory to 64, 128, 192 or 256;
//     zero columns change no product, and only the D real columns are
//     written. Above 128 the K/V tiles are 32 rows, to fit shared memory;
//   * one block per (64-row query tile, head, batch) loops over the K/V
//     tiles; S = q k^T on the tensor cores, an fp32 online softmax with the
//     running max and sum per row, P v, the output divided by the sum at the
//     end; the ragged last K/V tile is zero-filled and its scores masked.
// Four warps each own 16 query rows, so the softmax of a tile needs no
// block-wide barrier.
#include "common.cuh"

namespace emox {
namespace flash_fwd {

using T = float;
constexpr int kBQ = 64;   // query rows per block
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF

struct Args {
  Strides3 q, k, v, o;
};

template <int DP>
struct Layout {
  static constexpr int kBK = DP > 128 ? 32 : 64;   // keys per K/V tile
  static constexpr int LDT = DP + Pad<T>::value;   // Q, K, V tiles (T)
  static constexpr int LDS = kBK + 4;              // scores (fp32)
  static constexpr int LDP = kBK + Pad<T>::value;  // probabilities (T)
  static constexpr int LDO = DP + 4;               // output accumulator (fp32)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * kBQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * kBK * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * kBK * LDT);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * kBQ * LDS);
  static constexpr size_t o_off = align128(p_off + sizeof(T) * kBQ * LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * kBQ * LDO);
  static constexpr size_t l_off = m_off + sizeof(float) * kBQ;
  static constexpr size_t a_off = l_off + sizeof(float) * kBQ;
  static constexpr size_t bytes = align128(a_off + sizeof(float) * kBQ);
  static_assert(bytes <= 232448, "shared memory of a block");
};

// D: the head dim; DP: D padded to a multiple of 64
template <int DP>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Args st, int heads, int lq, int lk,
               int D, float scale) {
  using Lay = Layout<DP>;
  constexpr int kBK = Lay::kBK;
  using M = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::q_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p_off);
  float* Os = reinterpret_cast<float*>(smem + Lay::o_off);
  float* m_s = reinterpret_cast<float*>(smem + Lay::m_off);
  float* l_s = reinterpret_cast<float*>(smem + Lay::l_off);
  float* a_s = reinterpret_cast<float*>(smem + Lay::a_off);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's query rows within the tile

  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;

  load_rows_padded<T>(Qs, Lay::LDT, qb, st.q.r, q0, kBQ, lq, D, DP);
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) Os[(i / DP) * Lay::LDO + i % DP] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int j0 = 0; j0 < lk; j0 += kBK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_rows_padded<T>(Ks, Lay::LDT, kb, st.k.r, j0, kBK, lk, D, DP);
    load_rows_padded<T>(Vs, Lay::LDT, vb, st.v.r, j0, kBK, lk, D, DP);
    __syncthreads();

    // S = q k^T for this warp's 16 rows
    {
      typename M::Acc acc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += M::K) {
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          M::template step<wmma::col_major>(acc[j], Qs + r0 * Lay::LDT + kk, Lay::LDT,
                                            Ks + (j * 16) * Lay::LDT + kk, Lay::LDT);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        wmma::store_matrix_sync(Ss + r0 * Lay::LDS + j * 16, acc[j], Lay::LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (kBK / 32 columns a lane)
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float sv[kBK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < kBK / 32; ++e) {
        const int col = lane + 32 * e;
        sv[e] = j0 + col < lk ? Ss[row * Lay::LDS + col] * scale : kNegInf;
        mx = fmaxf(mx, sv[e]);
      }
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < kBK / 32; ++e) {
        const float p = expf(sv[e] - m_new);
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
    __syncwarp();

    // O = alpha * O + P v
    for (int i = lane; i < 16 * DP; i += 32) {
      const int row = r0 + i / DP;
      Os[row * Lay::LDO + i % DP] *= a_s[row];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      typename M::Acc acc;
      wmma::load_matrix_sync(acc, Os + r0 * Lay::LDO + j * 16, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += M::K) {
        M::template step<wmma::row_major>(acc, Ps + r0 * Lay::LDP + kk, Lay::LDP,
                                          Vs + kk * Lay::LDT + j * 16, Lay::LDT);
      }
      wmma::store_matrix_sync(Os + r0 * Lay::LDO + j * 16, acc, Lay::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: each warp writes its own rows, the D real columns (l clamped
  // as the TPU kernel's l_safe)
  T* ob = o + b * st.o.b + h * st.o.h;
  for (int i = lane; i < 16 * D; i += 32) {
    const int row = r0 + i / D;
    const int col = i % D;
    const int qi = q0 + row;
    if (qi < lq) {
      const float l = fmaxf(l_s[row], 1e-20f);
      ob[qi * st.o.r + col] = from_float<T>(Os[row * Lay::LDO + col] / l);
    }
  }
  if (lane < 16) {
    const int row = r0 + lane;
    const int qi = q0 + row;
    if (qi < lq) {
      lse[((size_t)b * heads + h) * lq + qi] = m_s[row] + logf(fmaxf(l_s[row], 1e-20f));
    }
  }
}

template <int DP>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                          const Args& st, int batch, int heads, int lq, int lk, int D, float scale,
                          cudaStream_t stream) {
  using Lay = Layout<DP>;
  auto kernel = fwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, Lay::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), st, heads, lq, lk, D, scale);
  return cudaGetLastError();
}

}  // namespace flash_fwd
}  // namespace emox

// dtype: 0 = float32 (the only type taken). q [batch, heads, lq, head_dim <= 256], k and v
// [batch, heads, lk, head_dim], o like q, each with its head dim contiguous
// and the element strides (batch, head, row) given in `strides` in the order
// q, k, v, o (12 values); lse [batch, heads, lq] float32, contiguous. Every
// row must start 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const long long* strides, int batch, int heads,
                                   int lq, int lk, int head_dim, float scale, int dtype,
                                   void* stream) {
  using namespace emox;
  using namespace emox::flash_fwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args st;
  Strides3* all[4] = {&st.q, &st.k, &st.v, &st.o};
  for (int i = 0; i < 4; ++i) *all[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype != 0 || head_dim <= 0 || head_dim > 256) return (int)cudaErrorInvalidValue;
  if (head_dim <= 64) return (int)launch<64>(q, k, v, o, lse, st, batch, heads, lq, lk, head_dim, scale, s);
  if (head_dim <= 128) return (int)launch<128>(q, k, v, o, lse, st, batch, heads, lq, lk, head_dim, scale, s);
  if (head_dim <= 192) return (int)launch<192>(q, k, v, o, lse, st, batch, heads, lq, lk, head_dim, scale, s);
  return (int)launch<256>(q, k, v, o, lse, st, batch, heads, lq, lk, head_dim, scale, s);
}
