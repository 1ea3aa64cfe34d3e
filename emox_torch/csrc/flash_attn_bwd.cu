// Flash-attention backward on WMMA (sm_90a), float32 (3xTF32) and bf16.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (emox/ops/attention.py, called by `_flash_bwd_impl`) and, on head-split
// views, the packed layout's `_flash_bwd_nlc_dq_kernel` and
// `_flash_bwd_nlc_dkv_kernel`, where flash_bwd_sm90.cu does not: float32 at
// every head dim up to 256 (the float32 model held against the CPU) and
// bf16 at head dims 129-256. From q, k, v on [B, H, L, D] operands, the
// forward's log-sum-exp lse [B, H, Lq] and the output gradient dO, it
// recomputes the probabilities tile by tile and returns dq, dk and dv.
// delta = sum_d dO*O per row, [B, H, Lq] fp32, is computed by the wrapper
// before the launch, as the TPU path computes it outside its kernels.
//
// What bounds it on the H100: in float32 the products run as 3xTF32 on the
// tensor cores (three TF32 products each) against 67 TFLOP/s of float32
// arithmetic for the elementwise steps; in bf16 the tensor cores. The design:
//   * two kernels, and each block owns the output rows it writes, so nothing
//     is reduced across blocks: no atomics, and the result does not depend on
//     the order in which blocks run. The price is that both kernels recompute
//     S = q k^T and dP = dO v^T;
//   * dq kernel: one block per (64-row q tile, head, batch), looping over
//     64-row K/V tiles: S and dP on the tensor cores (WMMA, fp32
//     accumulation), P = exp(S*scale - lse), dS = P (dP - delta) rounded to
//     the input type, dq += dS k in WMMA accumulators held in registers;
//     dq*scale is written at the end;
//   * dkv kernel: one block per (64-row K/V tile, head, batch), looping over q
//     tiles: S^T = k q^T and dP^T = v dO^T, then dv += P^T dO and
//     dk += dS^T q with P and dS rounded to the input type; dk*scale is
//     written at the end (the TPU kernel carries the scale on its pre-scaled
//     q, which is the same product);
//   * every operand comes with element strides for batch, head and row, so
//     head-split views of packed tokens need no copy; the head dim is
//     zero-padded in shared memory to the next of 48, 64, 80, 128, 192 and
//     256 (40 -> 48, 160 -> 192; bf16 only to 192 and 256), which changes no
//     product, and only the D real columns are written. float32 above 128 takes 32-row tiles (two
//     warps) to fit shared memory, and at the widest head dims the dk/dv
//     accumulators spill to local memory: right, not fast;
//   * ragged edges: keys at or past Lk get P = 0, as the TPU kernel's
//     `masked` path; query rows at or past Lq are zero-filled and get P = 0
//     through lse = +inf, so they add nothing;
//   * each warp owns 16 rows of the block's tile, so the elementwise step
//     between the products needs no block barrier.
// No TMA, no wgmma, no pipelining of the tile loads: flash_bwd_sm90.cu has
// them for bf16 up to head dim 128.
#include "common.cuh"

namespace emox {
namespace flash_bwd_strided {

struct Args {
  Strides3 q, k, v, g, dq, dk, dv;  // g: the output gradient dO
};

// +inf as lse of a row past Lq: exp(S - inf) = 0
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

template <typename T, int DP>
struct Layout {
  static constexpr int kB = (sizeof(T) == 4 && DP > 128) ? 32 : 64;  // rows of a q and of a K/V tile
  static constexpr int kThreads = 2 * kB;                             // a warp per 16 rows
  static constexpr int LDT = DP + Pad<T>::value;   // q, dO, k, v tiles (T)
  static constexpr int LDS = kB + 4;               // S and dP (fp32)
  static constexpr int LDP = kB + Pad<T>::value;   // P and dS (T)
  static constexpr int LDO = DP + 4;               // epilogue staging (fp32)
  static constexpr size_t tile = sizeof(T) * kB * LDT;
  static constexpr size_t t0_off = 0;  // dq: q   dkv: k
  static constexpr size_t t1_off = align128(t0_off + tile);  // dq: dO  dkv: v
  static constexpr size_t t2_off = align128(t1_off + tile);  // dq: k   dkv: q
  static constexpr size_t t3_off = align128(t2_off + tile);  // dq: v   dkv: dO
  static constexpr size_t s_off = align128(t3_off + tile);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * kB * LDS);
  static constexpr size_t p_off = align128(dp_off + sizeof(float) * kB * LDS);
  static constexpr size_t ds_off = align128(p_off + sizeof(T) * kB * LDP);
  static constexpr size_t lse_off = align128(ds_off + sizeof(T) * kB * LDP);
  static constexpr size_t delta_off = lse_off + sizeof(float) * kB;
  static constexpr size_t bytes = align128(delta_off + sizeof(float) * kB);
  // the epilogue stages fp32 output rows over the third and fourth tiles
  // (K/V in the dq kernel, q/dO in the dkv kernel), free once the loop ends
  static_assert(sizeof(float) * kB * LDO <= s_off - t2_off, "epilogue staging does not fit");
  static_assert(bytes <= 232448, "shared memory of a block");
};

// out (one warp: 16 rows x 64 columns, fp32, ld LDS) = A (16 x DP, row-major)
// * B^T, where B is a [64, DP] row-major tile: A B^T over the head dim.
template <typename T, int DP>
__device__ __forceinline__ void product_abt(float* out, const T* a, const T* b) {
  using Lay = Layout<T, DP>;
  using M = Mma<T>;
  constexpr int kB = Lay::kB;
  typename M::Acc acc[kB / 16];
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += M::K) {
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      M::template step<wmma::col_major>(acc[j], a + kk, Lay::LDT, b + (j * 16) * Lay::LDT + kk,
                                        Lay::LDT);
    }
  }
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {
    wmma::store_matrix_sync(out + j * 16, acc[j], Lay::LDS, wmma::mem_row_major);
  }
}

// acc[j] (one warp: 16 rows x DP) += A (16 x 64, row-major, ld LDP) * B
// (64 x DP, a row-major tile, ld LDT)
template <typename T, int DP>
__device__ __forceinline__ void accumulate_ab(typename Mma<T>::Acc* acc, const T* a, const T* b) {
  using Lay = Layout<T, DP>;
  using M = Mma<T>;
  constexpr int kB = Lay::kB;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < kB; kk += M::K) {
      M::template step<wmma::row_major>(acc[j], a + kk, Lay::LDP, b + kk * Lay::LDT + j * 16,
                                        Lay::LDT);
    }
  }
}

// Write one warp's 16 x D accumulator rows (of DP), times `mul`, to a
// strided output (rows at or past `nrows` are dropped), staged through fp32
// shared memory at `stage` (the warp's own rows).
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, long long stride,
                                           const typename Mma<T>::Acc* acc, float* stage,
                                           int row0, int nrows, int D, float mul) {
  using Lay = Layout<T, DP>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::store_matrix_sync(stage + j * 16, acc[j], Lay::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D;
    const int col = i % D;
    if (row0 + r < nrows) out[(row0 + r) * stride + col] = from_float<T>(stage[r * Lay::LDO + col] * mul);
  }
  __syncwarp();
}

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<T, DP>::kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Args st, int heads, int lq,
              int lk, int D, float scale) {
  using Lay = Layout<T, DP>;
  using M = Mma<T>;
  constexpr int kB = Lay::kB;
  constexpr int kThreads = Lay::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + Lay::t0_off);
  T* dOs = reinterpret_cast<T*>(smem + Lay::t1_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::t2_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::t3_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* DPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + Lay::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta_off);

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's q rows within the tile
  const size_t row_base = ((size_t)b * heads + h) * lq;  // into lse and delta
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;

  load_rows_padded<T>(Qs, Lay::LDT, q + b * st.q.b + h * st.q.h, st.q.r, q0, kB, lq, D, DP);
  load_rows_padded<T>(dOs, Lay::LDT, dout + b * st.g.b + h * st.g.h, st.g.r, q0, kB, lq, D, DP);
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const int qi = q0 + i;
    lse_s[i] = qi < lq ? lse[row_base + qi] : pos_inf();  // P = 0 on rows past Lq
    delta_s[i] = qi < lq ? delta[row_base + qi] : 0.f;
  }

  typename M::Acc acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int j0 = 0; j0 < lk; j0 += kB) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_rows_padded<T>(Ks, Lay::LDT, kb, st.k.r, j0, kB, lk, D, DP);
    load_rows_padded<T>(Vs, Lay::LDT, vb, st.v.r, j0, kB, lk, D, DP);
    __syncthreads();

    product_abt<T, DP>(Ss + r0 * Lay::LDS, Qs + r0 * Lay::LDT, Ks);    // S = q k^T
    product_abt<T, DP>(DPs + r0 * Lay::LDS, dOs + r0 * Lay::LDT, Vs);  // dP = dO v^T
    __syncwarp();

    // dS = P (dP - delta), one row at a time across the warp (kB / 32 columns a lane)
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int half = 0; half < kB / 32; ++half) {
        const int col = lane + 32 * half;
        float p = expf(Ss[row * Lay::LDS + col] * scale - l);
        if (j0 + col >= lk) p = 0.f;
        dSs[row * Lay::LDP + col] = from_float<T>(p * (DPs[row * Lay::LDS + col] - dl));
      }
    }
    __syncwarp();

    accumulate_ab<T, DP>(acc, dSs + r0 * Lay::LDP, Ks);  // dq += dS k
  }

  __syncthreads();  // every warp is done with K and V before the staging reuses them
  float* stage = reinterpret_cast<float*>(smem + Lay::t2_off) + r0 * Lay::LDO;
  store_rows<T, DP>(dq + b * st.dq.b + h * st.dq.h, st.dq.r, acc, stage, q0 + r0, lq, D, scale);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<T, DP>::kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Args st,
               int heads, int lq, int lk, int D, float scale) {
  using Lay = Layout<T, DP>;
  using M = Mma<T>;
  constexpr int kB = Lay::kB;
  constexpr int kThreads = Lay::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + Lay::t0_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::t1_off);
  T* Qs = reinterpret_cast<T*>(smem + Lay::t2_off);
  T* dOs = reinterpret_cast<T*>(smem + Lay::t3_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* DPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  T* Ps = reinterpret_cast<T*>(smem + Lay::p_off);
  T* dSs = reinterpret_cast<T*>(smem + Lay::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::delta_off);

  const int kv0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's keys within the tile
  const size_t row_base = ((size_t)b * heads + h) * lq;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* gb = dout + b * st.g.b + h * st.g.h;

  load_rows_padded<T>(Ks, Lay::LDT, k + b * st.k.b + h * st.k.h, st.k.r, kv0, kB, lk, D, DP);
  load_rows_padded<T>(Vs, Lay::LDT, v + b * st.v.b + h * st.v.h, st.v.r, kv0, kB, lk, D, DP);

  typename M::Acc acc_dk[DP / 16], acc_dv[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  for (int i0 = 0; i0 < lq; i0 += kB) {
    __syncthreads();  // the previous q tile is no longer read
    load_rows_padded<T>(Qs, Lay::LDT, qb, st.q.r, i0, kB, lq, D, DP);
    load_rows_padded<T>(dOs, Lay::LDT, gb, st.g.r, i0, kB, lq, D, DP);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const int qi = i0 + i;
      lse_s[i] = qi < lq ? lse[row_base + qi] : pos_inf();  // P = 0 on rows past Lq
      delta_s[i] = qi < lq ? delta[row_base + qi] : 0.f;
    }
    __syncthreads();

    product_abt<T, DP>(Ss + r0 * Lay::LDS, Ks + r0 * Lay::LDT, Qs);    // S^T = k q^T
    product_abt<T, DP>(DPs + r0 * Lay::LDS, Vs + r0 * Lay::LDT, dOs);  // dP^T = v dO^T
    __syncwarp();

    // P^T and dS^T = P^T (dP^T - delta), a key row at a time across the warp
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const bool key_in = kv0 + row < lk;
#pragma unroll
      for (int half = 0; half < kB / 32; ++half) {
        const int col = lane + 32 * half;
        const float p = key_in ? expf(Ss[row * Lay::LDS + col] * scale - lse_s[col]) : 0.f;
        Ps[row * Lay::LDP + col] = from_float<T>(p);
        dSs[row * Lay::LDP + col] = from_float<T>(p * (DPs[row * Lay::LDS + col] - delta_s[col]));
      }
    }
    __syncwarp();

    accumulate_ab<T, DP>(acc_dv, Ps + r0 * Lay::LDP, dOs);  // dv += P^T dO
    accumulate_ab<T, DP>(acc_dk, dSs + r0 * Lay::LDP, Qs);  // dk += dS^T q
  }

  __syncthreads();  // every warp is done with q and dO before the staging reuses them
  float* stage = reinterpret_cast<float*>(smem + Lay::t2_off) + r0 * Lay::LDO;
  store_rows<T, DP>(dk + b * st.dk.b + h * st.dk.h, st.dk.r, acc_dk, stage, kv0 + r0, lk, D, scale);
  store_rows<T, DP>(dv + b * st.dv.b + h * st.dv.h, st.dv.r, acc_dv, stage, kv0 + r0, lk, D, 1.f);
}

template <typename T, int DP>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, void* dk, void* dv,
                          const Args& st, int batch, int heads, int lq, int lk, int D, float scale,
                          cudaStream_t stream) {
  using Lay = Layout<T, DP>;
  constexpr int kB = Lay::kB;
  constexpr int kThreads = Lay::kThreads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  cudaError_t err;
  if (dq != nullptr) {
    auto kernel = dq_kernel<T, DP>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((lq + kB - 1) / kB, heads, batch), kThreads, Lay::bytes, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), st, heads, lq, lk, D, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk != nullptr) {
    auto kernel = dkv_kernel<T, DP>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((lk + kB - 1) / kB, heads, batch), kThreads, Lay::bytes, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), st, heads, lq, lk, D, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace flash_bwd_strided
}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16. q, dout [batch, heads, lq, head_dim]; k, v
// [batch, heads, lk, head_dim]; dq like q, dk and dv like k; each with its
// head dim contiguous and the element strides (batch, head, row) given in
// `strides` in the order q, k, v, dout, dq, dk, dv (21 values; those of an
// output not asked for are ignored). lse and delta [batch, heads, lq]
// float32, contiguous. head_dim <= 256, and above 128 in bfloat16 (bf16 up
// to 128 runs on flash_bwd_sm90.cu); every row must start 16-byte aligned.
// dq == NULL skips the dq kernel; dk and dv are both given (the dkv kernel
// runs) or both NULL. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, void* dk,
                                   void* dv, const long long* strides, int batch, int heads,
                                   int lq, int lk, int head_dim, float scale, int dtype,
                                   void* stream) {
  using namespace emox;
  using namespace emox::flash_bwd_strided;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (dk == nullptr) != (dv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args st;
  Strides3* all[7] = {&st.q, &st.k, &st.v, &st.g, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 7; ++i) *all[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (head_dim <= 0 || head_dim > 256 || (dtype != 0 && dtype != 1) || (dtype == 1 && head_dim <= 128)) {
    return (int)cudaErrorInvalidValue;
  }
#define EMOX_LAUNCH(T, DP) \
  launch<T, DP>(q, k, v, dout, lse, delta, dq, dk, dv, st, batch, heads, lq, lk, head_dim, scale, s)
  // the padded head dim: the smallest of these that holds head_dim
  if (dtype == 1) return (int)(head_dim <= 192 ? EMOX_LAUNCH(__nv_bfloat16, 192) : EMOX_LAUNCH(__nv_bfloat16, 256));
  if (head_dim <= 48) return (int)EMOX_LAUNCH(float, 48);
  if (head_dim <= 64) return (int)EMOX_LAUNCH(float, 64);
  if (head_dim <= 80) return (int)EMOX_LAUNCH(float, 80);
  if (head_dim <= 128) return (int)EMOX_LAUNCH(float, 128);
  if (head_dim <= 192) return (int)EMOX_LAUNCH(float, 192);
  return (int)EMOX_LAUNCH(float, 256);
#undef EMOX_LAUNCH
}
