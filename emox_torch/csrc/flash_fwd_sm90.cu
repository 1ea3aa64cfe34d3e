// Flash-attention forward for Hopper (sm_90a): wgmma + TMA, bf16.
//
// Replaces the TPU kernels `_flash_nlc_kernel` (emox/ops/attention.py:409,
// the packed [N, L, H*D] layout) and `_flash_kernel` (:69, the [B, H, L, D]
// layout): softmax(q k^T * scale) v with the per-row log-sum-exp written in
// fp32 for the backward kernels, as lse [N, Lq, H] (packed) or [B, H, Lq]
// (strided). The two layouts are one function: packed tokens are
// [N, H, L, D] with strides (L*H*D, D, H*D, 1), so one kernel serves both,
// taking element strides for q, k, v, o and lse.
//
// What bounds it on the H100: at the 256^2 serving shape (N 32, Lq 1024,
// Lk 2048, H 5, d 64) it does 4*N*H*Lq*Lk*d = 86 GFLOP against 126 MB of
// input and output, about 680 FLOP per byte: the tensor cores bound it, at
// 0.0869 ms for 989 TFLOP/s. The 512^2 level-0 site (Lq 4096, Lk 8192) is
// 16x that work (1.39 ms), level 1 (C 640, H 10) 0.174 ms.
//
// What the WMMA kernels it replaces (the bf16 paths that flash_attn_nlc.cu
// and flash_attn.cu held before) lost, at 33-48 TFLOP/s, and what this
// design does about it:
//   * they multiplied with WMMA fragments; here S = q k^T runs as wgmma with
//     both operands in shared memory, and O += P v as wgmma with P in
//     registers and V in shared memory (an MN-major operand);
//   * the fp32 scores, the bf16 P and the fp32 output accumulator made a
//     round trip through shared memory on every K/V tile; here the online
//     softmax runs on the wgmma accumulator registers (a thread owns two
//     rows, the four threads of a quad share a row), P is rounded to bf16 in
//     registers in the layout of wgmma's register A operand, and O stays in
//     registers until the epilogue;
//   * the threads copied K/V themselves with no overlap of load and compute;
//     here one producer warp issues TMA loads into a ring of K/V stages
//     guarded by mbarriers (full: the bytes arrived; empty: both consumers
//     are done with the stage), and loads the 128-row Q tile once;
//   * four warps shared a 64-row tile; here two consumer warpgroups own 64
//     query rows each, and setmaxnreg moves registers from the producer
//     warpgroup (24) to them (240): at d 256, O alone is 128 fp32 registers
//     a thread, so d > 128 takes 64-key tiles and d <= 128 128-key tiles.
// TMA does the layout work: the tensor maps are 4-D [d, L, H, B] (innermost
// first) with the caller's strides, boxes of 64 columns (128 bytes, the
// 128-byte swizzle that wgmma's descriptors name) by 128 (Q) or the tile's
// keys (K, V). The d extent is the true head dim, so the padded columns of
// the last box and the keys past Lk of the ragged last tile arrive as zeros
// (out-of-bounds fill); the scores of those keys are masked to -1e30, the
// TPU kernel's _NEG_INF. The head dim pads in shared memory to the swizzle
// atom, a multiple of 64 columns: 40 -> 64, 80 -> 128, 160 -> 192. Zero
// columns change no product, and the scale comes from the true d; the
// padding costs 1.6x the arithmetic at d 40, accepted here (ROADMAP.md).
// Rows whose bytes are not 16-byte aligned (d % 8 != 0) are padded by the
// wrapper before the launch (TMA needs 16-byte global strides).
// Not yet done (later PRs): overlap of one warpgroup's softmax with the
// other's products (ping-pong), intra-warpgroup pipelining of S and P v,
// a persistent grid, a TMA store of O.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace emox {
namespace sm90 {

constexpr int kBM = 128;           // query rows per block: 64 per consumer warpgroup
constexpr int kThreads = 384;      // warpgroups 0, 1: consumers; 2: producer
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// ---- PTX wrappers -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its results land at wgmma_wait0).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
struct Wgmma;
template <int N>
struct WgmmaRS;

template <>
struct Wgmma<64> {
  // d[32] (+)= A(64x16, shared, K-major) * B(16x64, shared, K-major); scale_d 0 overwrites d
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d[64] (+)= A(64x16, shared, K-major) * B(16x128, shared, K-major); scale_d 0 overwrites d
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  // d[32] += A(64x16, registers) * B(16x64, shared, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  // d[64] += A(64x16, registers) * B(16x128, shared, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<192> {
  // d[96] += A(64x16, registers) * B(16x192, shared, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  // d[128] += A(64x16, registers) * B(16x256, shared, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- the kernel -----------------------------------------------------------------
// DP: the head dim padded to a multiple of 64; BN: keys per K/V tile; STAGES:
// K/V tiles in flight.
template <int DP, int BN, int STAGES>
struct Smem {
  static constexpr int CHUNKS = DP / 64;                 // 64-column boxes per row
  static constexpr uint32_t q_chunk = kBM * 128;         // bytes of one Q box
  static constexpr uint32_t kv_chunk = BN * 128;         // bytes of one K or V box
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_off + CHUNKS * q_chunk;
  static constexpr uint32_t stage = CHUNKS * kv_chunk;   // one K (or V) tile
  static constexpr uint32_t v_off = k_off + STAGES * stage;
  static constexpr uint32_t bar_off = v_off + STAGES * stage;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct Out {
  __nv_bfloat16* o;
  float* lse;
  long long o_b, o_h, o_r;    // element strides of o (batch, head, row)
  long long l_b, l_h, l_r;    // element strides of lse
  int lq, lk, d;
  float scale_log2;           // scale * log2(e): the softmax runs in base 2
};

template <int DP, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Out args) {
  using S = Smem<DP, BN, STAGES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle is a function of address bits 4-9
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + S::bar_off;
  const uint32_t full0 = q_full + 8;                 // full[s]: K and V of stage s arrived
  const uint32_t empty0 = full0 + 8 * STAGES;        // empty[s]: both consumers are done with s
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBM;
  const int tiles = (args.lk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, S::CHUNKS * S::q_chunk);
      for (int c = 0; c < S::CHUNKS; ++c) {
        tma_load_4d(base + S::q_off + c * S::q_chunk, &tq, q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * S::stage);
        for (int c = 0; c < S::CHUNKS; ++c) {
          tma_load_4d(base + S::k_off + s * S::stage + c * S::kv_chunk, &tk, full, c * 64, j * BN, h, b);
          tma_load_4d(base + S::v_off + s * S::stage + c * S::kv_chunk, &tv, full, c * 64, j * BN, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row_lo = warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    const int col0 = 2 * (lane % 4);          // and columns col0, col0 + 1 of every 8
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;  // running max (base 2) of each row
    float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the running sum
    const uint32_t q_tile = base + S::q_off + wg * 64 * 128;

    mbar_wait(q_full, 0);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t k_tile = base + S::k_off + s * S::stage;
      const uint32_t v_tile = base + S::v_off + s * S::stage;

      // S = q k^T over the padded head dim: 16 columns a step, 4 steps a box
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      fence_regs<BN / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<BN>::ss(sc, smem_desc(q_tile + c * S::q_chunk + kk * 32, 16, 1024),
                        smem_desc(k_tile + c * S::kv_chunk + kk * 32, 16, 1024), c + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<BN / 2>(sc);

      // online softmax in base 2 on the accumulator: sc[4i + e] is row
      // row_lo (e < 2) or row_lo + 8 (e >= 2), column 8i + col0 + e % 2
      const bool ragged = (j + 1) * BN > args.lk;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float v = (ragged && j * BN + 8 * (i / 4) + col0 + (i % 2) >= args.lk) ? kNegInf
                                                                                     : sc[i] * args.scale_log2;
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
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i % 4) < 2;
        const float p = exp2f(sc[i] - (lo ? mn_lo : mn_hi));
        sc[i] = p;
        if (lo) sum_lo += p;
        else sum_hi += p;
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= ((i % 4) < 2) ? a_lo : a_hi;

      // O += P v: P (bf16) is wgmma's register A operand, whose layout is the
      // accumulator's: keys 16k..16k+15 are sc[8k..8k+7], in pairs
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[k][r] = pack_bf16(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1]);
      }
      fence_regs<DP / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
        // V: keys (the product's depth) on rows, head dim (N) contiguous:
        // MN-major, 64-column boxes BN rows apart, 8-row groups 1024 bytes apart
        WgmmaRS<DP>::rs(o, pa[k], smem_desc(v_tile + k * 16 * 128, S::kv_chunk, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DP / 2>(o);
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O / l in bf16 and lse = (m + log2 l) * ln 2, through the strides
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    l_lo = fmaxf(l_lo, 1e-20f);  // as the TPU kernel's l_safe
    l_hi = fmaxf(l_hi, 1e-20f);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const int r_lo = q0 + wg * 64 + row_lo, r_hi = r_lo + 8;
    __nv_bfloat16* ob = args.o + b * args.o_b + h * args.o_h;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + col0;
      if (col < args.d) {
        if (r_lo < args.lq) {
          *reinterpret_cast<uint32_t*>(ob + r_lo * args.o_r + col) =
              pack_bf16(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
        }
        if (r_hi < args.lq) {
          *reinterpret_cast<uint32_t*>(ob + r_hi * args.o_r + col) =
              pack_bf16(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
        }
      }
    }
    if (lane % 4 == 0) {
      float* lb = args.lse + b * args.l_b + h * args.l_h;
      constexpr float kLn2 = 0.6931471805599453f;
      if (r_lo < args.lq) lb[r_lo * args.l_r] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < args.lq) lb[r_hi * args.l_r] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// ---- host side ------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver PyTorch has loaded (no -lcuda needed)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A [B, H, L, d] bf16 operand with element strides (b, h, r) and a contiguous
// head dim, as 4-D [d, L, H, B] with boxes of 64 columns x `rows` rows.
static bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads, int len, int d,
                     const long long* st, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BN, int STAGES>
static cudaError_t launch(const void* q, const void* k, const void* v, const long long* st, const Out& out,
                          int batch, int heads, cudaStream_t stream) {
  using S = Smem<DP, BN, STAGES>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, heads, out.lq, out.d, st, kBM) ||
      !make_map(&tk, k, batch, heads, out.lk, out.d, st + 3, BN) ||
      !make_map(&tv, v, batch, heads, out.lk, out.d, st + 6, BN)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = fwd_kernel<DP, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((out.lq + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, S::bytes, stream>>>(tq, tk, tv, out);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace emox

// bf16 attention forward on [batch, heads, L, head_dim] operands with element
// strides: `strides` holds (batch, head, row) for q, k, v, o and lse in that
// order (15 values), the head dim contiguous. q, k, v: 16-byte aligned base
// pointers and 16-byte multiples for every stride in bytes; head_dim <= 256
// and even. lse float32. Returns a cudaError_t (0 = launched).
extern "C" int emox_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const long long* strides, int batch, int heads, int lq, int lk,
                                   int head_dim, float scale, void* stream) {
  using namespace emox::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      head_dim <= 0 || head_dim > 256 || head_dim % 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* so = strides + 9;
  const long long* sl = strides + 12;
  const Out out{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), so[0], so[1], so[2], sl[0], sl[1],
                sl[2], lq, lk, head_dim, scale * kLog2e};
  if (head_dim <= 64) return (int)launch<64, 128, 3>(q, k, v, strides, out, batch, heads, s);
  if (head_dim <= 128) return (int)launch<128, 128, 2>(q, k, v, strides, out, batch, heads, s);
  if (head_dim <= 192) return (int)launch<192, 64, 2>(q, k, v, strides, out, batch, heads, s);
  return (int)launch<256, 64, 2>(q, k, v, strides, out, batch, heads, s);
}
