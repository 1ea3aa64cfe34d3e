// Flash-attention backward at head dim 512 on WMMA (sm_90a), float32 (3xTF32).
//
// Replaces the TPU kernels `_flash_bwd_nlc_dq_kernel` and
// `_flash_bwd_nlc_dkv_kernel` (emox/ops/attention.py:465,508) where the head
// dim is 512 and the type float32: the gradient of the float32 VAE's
// single-head mid-attention (the train_step_vae check holds the card against
// the CPU there). bf16 at head dim 512, stage 5's path, runs on
// flash_bwd_d512_sm90.cu (wgmma + TMA). From q, k, v, the output gradient dO,
// the forward's log-sum-exp lse and delta = sum_d dO*O per row (both fp32,
// computed outside the kernels as the TPU path computes delta), it returns
//   P = exp(q k^T * scale - lse),  dv = P^T dO,  dS = P (dO v^T - delta),
//   dq = dS k * scale,             dk = dS^T q * scale.
// The operands are [B, H, L, 512] with element strides (batch, head, row), so
// head-split views of packed tokens [N, L, H*512] need no copy.
//
// What bounds it on the H100: at N 1, L 1024 the function is 10*N*L*L*d =
// 5.4 GFLOP, 0.080 ms at the CUDA cores' 67 TFLOP/s. What makes d 512 hard
// is room, not work: the fp32 accumulator of one gradient tile of width 512
// is 2 KB a row, and one float32 operand tile of width 512 2 KB a row of the
// 227 KB of shared memory a block can have. The design:
//   * two kernels, as the TPU kernels are, each block owning the rows it
//     writes: no atomics, and the same bits from run to run. Both kernels
//     compute S and dP (7 products of N*H*L*L*d multiply-adds, not 5);
//   * dq kernel, a block per (32 query rows, head, batch), 8 warps: the Q and
//     dO tiles stay in shared memory, 16-key K and V tiles stream through it.
//     S = Q K^T and dP = dO V^T (each warp one 16-row strip of one of them,
//     16 keys wide, 512 deep), dS = P (dP - delta), then dQ += dS K with the
//     32 x 512 fp32 accumulator split over the warps (a 16 x 128 strip each:
//     64 registers a thread);
//   * dkv kernel, a block per (16 keys, head, batch), 8 warps: K and V stay,
//     32-row Q and dO tiles stream. S^T = K Q^T and dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q, both fp32 accumulators split over the
//     warps (64 registers a thread);
//   * the tiles are staged by 16-byte cp.async copies and multiplied by WMMA
//     in the 3xTF32 split with fp32 accumulation. Shared memory holds one
//     tile of each operand, so a streamed tile is refilled as soon as its
//     last product is done: in the dq kernel V's next tile loads during the
//     dS step and dQ += dS K, in the dkv kernel Q's next tile during
//     dV += P^T dO; the other tile's load is not overlapped;
//   * lse and delta come as [B, H, Lq_pad] fp32, contiguous, padded to a
//     multiple of 64 rows with lse = +inf and delta = 0: rows past Lq (their
//     q and dO rows are zero-filled) give P = 0 and dS = 0. Keys at or past
//     Lk are zero-filled and masked to P = 0; only rows below Lq (dq) and Lk
//     (dk, dv) are written.
// This is the simple, right version (ROADMAP.md, Queue 2).
#include "common.cuh"

namespace emox {
namespace bwd_d512 {

constexpr int D = 512;         // the head dim
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLqPad = 64;     // lse and delta rows are padded to a multiple of this

struct Args {
  Strides3 q, k, v, g, dq, dk, dv;  // g: the output gradient dO
};

// Copy rows [row0, row0 + rows) of a strided [*, D] operand (row stride
// `stride` elements) into a shared tile of leading dimension `ld` as 16-byte
// cp.async copies, committed as one group; rows at or past `nrows` are
// zero-filled. The copies land after cp_async_wait().
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ld, const T* src, long long stride, int row0, int rows,
                                                int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int vpr = D / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * VEC;
    T* d = dst + r * ld + c;
    if (row0 + r < nrows) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(d)),
                   "l"(src + (long long)(row0 + r) * stride + c)
                   : "memory");
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// WMMA operand fragments of one 8-deep TF32 step; an operand is loaded once
// and may feed several products, split into TF32 high and low parts for the
// 3xTF32 product.
template <typename T>
struct Frag;

template <typename F>
__device__ __forceinline__ void split_tf32(F& hi, F& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float v = hi.x[i];
    const float h = wmma::__float_to_tf32(v);
    lo.x[i] = wmma::__float_to_tf32(v - h);
    hi.x[i] = h;
  }
}

template <>
struct Frag<float> {
  static constexpr int K = 8;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> hi, lo;
  };
  template <typename L>
  struct B {
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, L> hi, lo;
  };
  static __device__ __forceinline__ void load(A& a, const float* p, int ld) {
    wmma::load_matrix_sync(a.hi, p, ld);
    split_tf32(a.hi, a.lo);
  }
  template <typename L>
  static __device__ __forceinline__ void load(B<L>& b, const float* p, int ld) {
    wmma::load_matrix_sync(b.hi, p, ld);
    split_tf32(b.hi, b.lo);
  }
  template <typename L>
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B<L>& b) {
    wmma::mma_sync(c, a.lo, b.hi, c);
    wmma::mma_sync(c, a.hi, b.lo, c);
    wmma::mma_sync(c, a.hi, b.hi, c);
  }
};

// out (fp32, ld `lds`: 16 rows x NB*16 columns) = A B^T over the head dim,
// where A is 16 rows of a [*, D] tile at `a` and B is NB*16 rows of a [*, D]
// tile at `b`, both row-major with leading dimension `ldt`: one warp.
template <typename T, int NB>
__device__ __forceinline__ void product_abt(float* out, int lds, const T* a, const T* b, int ldt) {
  using F = Frag<T>;
  typename F::Acc acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll 4
  for (int kk = 0; kk < D; kk += F::K) {
    typename F::A fa;
    F::load(fa, a + kk, ldt);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      typename F::template B<wmma::col_major> fb;
      F::load(fb, b + j * 16 * ldt + kk, ldt);
      F::mma(acc[j], fa, fb);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) wmma::store_matrix_sync(out + j * 16, acc[j], lds, wmma::mem_row_major);
}

// acc[j] (16 rows x the 16 columns c0 + 16j of a [*, D] result) += A B, where A
// is 16 rows x `depth` (row-major, ld `lda`) and B the [depth, D] row-major
// tile at `b` (ld `ldb`): one warp.
template <typename T, int NC>
__device__ __forceinline__ void accumulate_ab(typename Frag<T>::Acc* acc, const T* a, int lda, const T* b,
                                              int ldb, int c0, int depth) {
  using F = Frag<T>;
  for (int kk = 0; kk < depth; kk += F::K) {
    typename F::A fa;
    F::load(fa, a + kk, lda);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      typename F::template B<wmma::row_major> fb;
      F::load(fb, b + (size_t)kk * ldb + c0 + j * 16, ldb);
      F::mma(acc[j], fa, fb);
    }
  }
}

// Stage the warps' accumulators (warp w: rows 16*(w / per_group), columns
// c0 + 16j) into fp32 shared memory `stage` [rows, D + 4], then write rows
// below `nrows` of the block's tile, times `mul`, to `out` (row stride
// `stride`) in 16-byte vectors. Every thread of the block takes part.
template <typename T, int NC>
__device__ __forceinline__ void store_tile(T* out, long long stride, const typename Frag<T>::Acc* acc,
                                           float* stage, int rows, int row_group, int c0, int row0, int nrows,
                                           float mul) {
  constexpr int LDO = D + 4;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    wmma::store_matrix_sync(stage + row_group * 16 * LDO + c0 + j * 16, acc[j], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int VEC = Vec16<T>::N;
  for (int i = threadIdx.x; i < rows * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC);
    const int c = (i - r * (D / VEC)) * VEC;
    if (row0 + r >= nrows) continue;
    float vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) vals[e] = stage[r * LDO + c + e] * mul;
    Vec16<T>::store(out + (long long)(row0 + r) * stride + c, vals);
  }
}

template <typename T>
struct DqLayout {
  static constexpr int BQ = 32;                        // query rows a block owns
  static constexpr int BK = 16;                        // keys a streamed tile
  static constexpr int NB = 1;                         // key fragments a warp's S or dP strip
  static constexpr int LDT = D + Pad<T>::value;        // q, dO, k, v tiles (T)
  static constexpr int LDS = BK + 4;                   // S and dP (fp32)
  static constexpr int LDP = BK + Pad<T>::value;       // dS (T)
  static constexpr int NC = (D / 16) * (BQ / 16) / kWarps;  // dq column fragments a warp owns
  static constexpr size_t q_off = 0;
  static constexpr size_t g_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t k_off = align128(g_off + sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t ds_off = align128(dp_off + sizeof(float) * BQ * LDS);
  static constexpr size_t lse_off = align128(ds_off + sizeof(T) * BQ * LDP);
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = align128(delta_off + sizeof(float) * BQ);
  // the epilogue stages dq (fp32) over the K and V tiles, free once the loop ends
  static_assert(sizeof(float) * BQ * (D + 4) <= s_off - k_off, "dq staging does not fit");
  static_assert(2 * (BQ / 16) * (BK / 16 / NB) <= kWarps, "one S or dP strip a warp");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Args st, int heads, int lq, int lk, int lq_pad, float scale) {
  using L = DqLayout<T>;
  using F = Frag<T>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = L::NB, NC = L::NC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Gs = reinterpret_cast<T*>(smem + L::g_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* DPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const size_t row_base = ((size_t)b * heads + h) * lq_pad + q0;  // into lse and delta
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;

  load_tile_async<T>(Qs, L::LDT, q + b * st.q.b + h * st.q.h, st.q.r, q0, BQ, lq);
  load_tile_async<T>(Gs, L::LDT, dout + b * st.g.b + h * st.g.h, st.g.r, q0, BQ, lq);
  load_tile_async<T>(Ks, L::LDT, kb, st.k.r, 0, BK, lk);
  load_tile_async<T>(Vs, L::LDT, vb, st.v.r, 0, BK, lk);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    lse_s[i] = lse[row_base + i];  // +inf past Lq: P = 0
    delta_s[i] = delta[row_base + i];
  }
  cp_async_wait();
  __syncthreads();

  // this warp's dq strip: 16 rows x NC*16 columns
  constexpr int warps_per_group = kWarps / (BQ / 16);
  const int row_group = warp / warps_per_group;
  const int c0 = (warp % warps_per_group) * NC * 16;
  typename F::Acc acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) wmma::fill_fragment(acc[j], 0.f);

  // this warp's S or dP strip: 16 rows x NB*16 keys
  constexpr int strips = (BQ / 16) * (BK / 16 / NB);
  const bool strip_on = warp < 2 * strips;
  const bool strip_dp = warp >= strips;
  const int strip = warp % strips;
  const int smi = strip / (BK / 16 / NB);
  const int snj = (strip % (BK / 16 / NB)) * NB;

  for (int j0 = 0; j0 < lk; j0 += BK) {
    const bool more = j0 + BK < lk;
    if (strip_on) {  // S = q k^T, dP = dO v^T
      product_abt<T, NB>((strip_dp ? DPs : Ss) + smi * 16 * L::LDS + snj * 16, L::LDS,
                         (strip_dp ? Gs : Qs) + smi * 16 * L::LDT, (strip_dp ? Vs : Ks) + snj * 16 * L::LDT,
                         L::LDT);
    }
    __syncthreads();  // S and dP are complete, and this tile's V is no longer read
    if (more) load_tile_async<T>(Vs, L::LDT, vb, st.v.r, j0 + BK, BK, lk);

    // dS = P (dP - delta), rounded to T
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK;
      const int c = i - r * BK;
      const float p = j0 + c < lk ? expf(Ss[r * L::LDS + c] * scale - lse_s[r]) : 0.f;
      dSs[r * L::LDP + c] = from_float<T>(p * (DPs[r * L::LDS + c] - delta_s[r]));
    }
    __syncthreads();

    accumulate_ab<T, NC>(acc, dSs + row_group * 16 * L::LDP, L::LDP, Ks, L::LDT, c0, BK);  // dq += dS k
    __syncthreads();  // this tile's K and dS are no longer read
    if (more) {
      load_tile_async<T>(Ks, L::LDT, kb, st.k.r, j0 + BK, BK, lk);
      cp_async_wait();
      __syncthreads();
    }
  }

  // every warp is done with K and V before the staging reuses them
  float* stage = reinterpret_cast<float*>(smem + L::k_off);
  store_tile<T, NC>(dq + b * st.dq.b + h * st.dq.h, st.dq.r, acc, stage, BQ, row_group, c0, q0, lq, scale);
}

template <typename T>
struct DkvLayout {
  static constexpr int BK = 16;                        // keys a block owns
  static constexpr int BQ = 32;                        // query rows a streamed tile
  static constexpr int NB = 1;                         // query fragments a warp's S^T or dP^T strip
  static constexpr int LDT = D + Pad<T>::value;        // k, v, q, dO tiles (T)
  static constexpr int LDS = BQ + 4;                   // S^T and dP^T (fp32)
  static constexpr int LDP = BQ + Pad<T>::value;       // P^T and dS^T (T)
  static constexpr int NC = (D / 16) * (BK / 16) / kWarps;  // dk and dv column fragments a warp owns
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t q_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t g_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t s_off = align128(g_off + sizeof(T) * BQ * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * BK * LDS);
  static constexpr size_t p_off = align128(dp_off + sizeof(float) * BK * LDS);
  static constexpr size_t ds_off = align128(p_off + sizeof(T) * BK * LDP);
  static constexpr size_t lse_off = align128(ds_off + sizeof(T) * BK * LDP);
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = align128(delta_off + sizeof(float) * BQ);
  // the epilogue stages dk over the q tile and dv over the dO tile (fp32)
  static_assert(sizeof(float) * BK * (D + 4) <= g_off - q_off, "dk staging does not fit");
  static_assert(sizeof(float) * BK * (D + 4) <= s_off - g_off, "dv staging does not fit");
  static_assert(2 * (BK / 16) * (BQ / 16 / NB) <= kWarps, "one S^T or dP^T strip a warp");
  static_assert(kLqPad % BQ == 0, "a q tile never reads past the lse padding");
  static_assert(bytes <= 232448, "shared memory of a block");
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Args st, int heads, int lq, int lk, int lq_pad,
               float scale) {
  using L = DkvLayout<T>;
  using F = Frag<T>;
  constexpr int BQ = L::BQ, BK = L::BK, NB = L::NB, NC = L::NC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Gs = reinterpret_cast<T*>(smem + L::g_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* DPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int kv0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const size_t row_base = ((size_t)b * heads + h) * lq_pad;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* gb = dout + b * st.g.b + h * st.g.h;

  load_tile_async<T>(Ks, L::LDT, k + b * st.k.b + h * st.k.h, st.k.r, kv0, BK, lk);
  load_tile_async<T>(Vs, L::LDT, v + b * st.v.b + h * st.v.h, st.v.r, kv0, BK, lk);
  load_tile_async<T>(Qs, L::LDT, qb, st.q.r, 0, BQ, lq);
  load_tile_async<T>(Gs, L::LDT, gb, st.g.r, 0, BQ, lq);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    lse_s[i] = lse[row_base + i];  // +inf past Lq: P = 0
    delta_s[i] = delta[row_base + i];
  }
  cp_async_wait();
  __syncthreads();

  // this warp's dk and dv strips: 16 keys x NC*16 columns
  constexpr int warps_per_group = kWarps / (BK / 16);
  const int row_group = warp / warps_per_group;
  const int c0 = (warp % warps_per_group) * NC * 16;
  typename F::Acc acc_dk[NC], acc_dv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  // this warp's S^T or dP^T strip: 16 keys x NB*16 query rows
  constexpr int strips = (BK / 16) * (BQ / 16 / NB);
  const bool strip_on = warp < 2 * strips;
  const bool strip_dp = warp >= strips;
  const int strip = warp % strips;
  const int smi = strip / (BQ / 16 / NB);
  const int snj = (strip % (BQ / 16 / NB)) * NB;

  for (int i0 = 0; i0 < lq; i0 += BQ) {
    const bool more = i0 + BQ < lq;
    if (strip_on) {  // S^T = k q^T, dP^T = v dO^T
      product_abt<T, NB>((strip_dp ? DPs : Ss) + smi * 16 * L::LDS + snj * 16, L::LDS,
                         (strip_dp ? Vs : Ks) + smi * 16 * L::LDT, (strip_dp ? Gs : Qs) + snj * 16 * L::LDT,
                         L::LDT);
    }
    __syncthreads();

    // P^T and dS^T = P^T (dP^T - delta), rounded to T
    for (int i = threadIdx.x; i < BK * BQ; i += kThreads) {
      const int r = i / BQ;
      const int c = i - r * BQ;
      const float p = kv0 + r < lk ? expf(Ss[r * L::LDS + c] * scale - lse_s[c]) : 0.f;
      Ps[r * L::LDP + c] = from_float<T>(p);
      dSs[r * L::LDP + c] = from_float<T>(p * (DPs[r * L::LDS + c] - delta_s[c]));
    }
    __syncthreads();

    accumulate_ab<T, NC>(acc_dk, dSs + row_group * 16 * L::LDP, L::LDP, Qs, L::LDT, c0, BQ);  // dk += dS^T q
    __syncthreads();  // this tile's q is no longer read
    if (more) load_tile_async<T>(Qs, L::LDT, qb, st.q.r, i0 + BQ, BQ, lq);
    accumulate_ab<T, NC>(acc_dv, Ps + row_group * 16 * L::LDP, L::LDP, Gs, L::LDT, c0, BQ);  // dv += P^T dO
    __syncthreads();  // this tile's dO, P^T, dS^T, lse and delta are no longer read
    if (more) {
      load_tile_async<T>(Gs, L::LDT, gb, st.g.r, i0 + BQ, BQ, lq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        lse_s[i] = lse[row_base + i0 + BQ + i];
        delta_s[i] = delta[row_base + i0 + BQ + i];
      }
      cp_async_wait();
      __syncthreads();
    }
  }

  // every warp is done with q and dO before the staging reuses them
  store_tile<T, NC>(dk + b * st.dk.b + h * st.dk.h, st.dk.r, acc_dk, reinterpret_cast<float*>(smem + L::q_off), BK,
                    row_group, c0, kv0, lk, scale);
  store_tile<T, NC>(dv + b * st.dv.b + h * st.dv.h, st.dv.r, acc_dv, reinterpret_cast<float*>(smem + L::g_off), BK,
                    row_group, c0, kv0, lk, 1.f);
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv, const Args& st, int batch, int heads,
                          int lq, int lk, int lq_pad, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  cudaError_t err;
  if (dq != nullptr) {
    using L = DqLayout<T>;
    auto kernel = dq_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((lq + L::BQ - 1) / L::BQ, heads, batch), kThreads, L::bytes, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), st, heads, lq, lk, lq_pad, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk != nullptr) {
    using L = DkvLayout<T>;
    auto kernel = dkv_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((lk + L::BK - 1) / L::BK, heads, batch), kThreads, L::bytes, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), st, heads, lq, lk, lq_pad, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace bwd_d512
}  // namespace emox

// float32 q, dout [batch, heads, lq, 512]; k, v [batch, heads, lk, 512]; dq
// like q, dk and dv like k; each with its head dim contiguous, every row
// 16-byte aligned, and the element strides (batch, head, row) given in
// `strides` in the order q, k, v, dout, dq, dk, dv (21 values; those of an
// output not asked for are ignored). lse and delta [batch, heads, lq_pad]
// float32, contiguous, lq_pad a multiple of 64 with lq <= lq_pad < lq + 64,
// padded with +inf and 0. dq == NULL skips the dq kernel; dk and dv are both
// given (the dkv kernel runs) or both NULL. Returns a cudaError_t (0 =
// launched).
extern "C" int emox_flash_bwd_d512(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk, void* dv, const long long* strides,
                                   int batch, int heads, int lq, int lk, int lq_pad, float scale, void* stream) {
  using namespace emox;
  using namespace emox::bwd_d512;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || lq_pad < lq ||
      lq_pad % kLqPad || lq_pad >= lq + kLqPad || (dk == nullptr) != (dv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args st;
  Strides3* all[7] = {&st.q, &st.k, &st.v, &st.g, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 7; ++i) *all[i] = Strides3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return (int)launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, st, batch, heads, lq, lk, lq_pad, scale, s);
}
