// Strided flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (emox/ops/attention.py, called by
// `_flash_impl`): softmax(q k^T * scale) v on [B, H, L, D] operands, with the
// per-row log-sum-exp written as lse [B, H, Lq] fp32 for the backward pass.
// The model path reaches it where the head dim is not a multiple of 64 and
// Lk >= 2048: with the SD-1.5 head layout (8 heads) that is the reader's
// level-0 self-attention with the reference tokens appended, head dim 40.
//
// What bounds it on the H100: at the serving shape (N 32, H 8, Lq 1024,
// Lk 2048, d 40) it does 4*N*H*Lq*Lk*d = 86 GFLOP against 127 MB of input
// and output, about 680 FLOP per byte: the tensor cores bound it, not the
// memory. The [Lq, Lk] score matrix would be 2.1 GB in fp32 per launch; the
// design keeps it out of device memory, as K1 (flash_attn_nlc.cu) does:
//   * q, k, v and out come with element strides for batch, head and row (the
//     head dim contiguous), so the packed [N, L, H*D] tokens of the nn
//     modules arrive as a head-split view with no transpose or copy; the TPU
//     path pays a transpose and a pad to 128 lanes there;
//   * the head dim is zero-padded in shared memory to a multiple of 16 (the
//     WMMA depth): 40 -> 48, 80 stays; zero columns change no product;
//   * one block per (64-row query tile, head, batch) loops over 64-row K/V
//     tiles; S = q k^T on the tensor cores (WMMA, fp32 accumulation), an fp32
//     online softmax with the running max and sum per row, P rounded to v's
//     type for P v, the output divided by the sum at the end;
//   * the ragged last K/V tile is zero-filled and its scores masked.
// Four warps each own 16 query rows, so the softmax of a tile needs no
// block-wide barrier. This is the simple, right version: no TMA, no wgmma,
// no pipelining of the K/V loads; those belong to the PR that makes it fast.
#include "common.cuh"

namespace emox {
namespace flash_fwd {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per K/V tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF

struct Args {
  Strides3 q, k, v, o;
};

template <typename T, int DP>
struct Layout {
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
};

// D: the head dim; DP: D padded to a multiple of 16
template <typename T, int D, int DP>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Args st, int heads, int lq, int lk,
               float scale) {
  using Lay = Layout<T, DP>;
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

    // online softmax, one row at a time across the warp (two columns a lane)
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float s0 = Ss[row * Lay::LDS + lane] * scale;
      float s1 = Ss[row * Lay::LDS + lane + 32] * scale;
      if (j0 + lane >= lk) s0 = kNegInf;
      if (j0 + lane + 32 >= lk) s1 = kNegInf;
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      Ps[row * Lay::LDP + lane] = from_float<T>(p0);
      Ps[row * Lay::LDP + lane + 32] = from_float<T>(p1);
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

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                          const Args& st, int batch, int heads, int lq, int lk, float scale,
                          cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  using Lay = Layout<T, DP>;
  auto kernel = fwd_kernel<T, D, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, Lay::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), st, heads, lq, lk, scale);
  return cudaGetLastError();
}

}  // namespace flash_fwd
}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16. q [batch, heads, lq, head_dim], k and v
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
  if (dtype == 1 && head_dim == 40)
    return (int)launch<__nv_bfloat16, 40>(q, k, v, o, lse, st, batch, heads, lq, lk, scale, s);
  if (dtype == 1 && head_dim == 80)
    return (int)launch<__nv_bfloat16, 80>(q, k, v, o, lse, st, batch, heads, lq, lk, scale, s);
  if (dtype == 0 && head_dim == 40)
    return (int)launch<float, 40>(q, k, v, o, lse, st, batch, heads, lq, lk, scale, s);
  if (dtype == 0 && head_dim == 80)
    return (int)launch<float, 80>(q, k, v, o, lse, st, batch, heads, lq, lk, scale, s);
  return (int)cudaErrorInvalidValue;
}
