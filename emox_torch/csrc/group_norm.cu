// GroupNorm(+SiLU) and its statistics for Hopper (sm_90a), on x [N, L, C]
// (NHWC feature maps with H*W folded into L), C split into `groups` runs
// of C / groups adjacent channels.
//
// Replaces two TPU kernels (emox/ops/groupnorm.py):
//   * `_gn_kernel` (K8a): statistics and apply in one pass over a sample's
//     [L, C] slab held in VMEM. Here: emox_group_norm launches the
//     statistics kernel, the finalize kernel (group mean and 1/std per
//     channel) and the apply kernel, y = (x - mean) * inv * gamma + beta in
//     fp32, then SiLU, then one rounding to x's type: the TPU kernel's
//     formula and rounding points.
//   * `_gn_stats_kernel` (K8b): per-channel fp32 sum and sum of squares,
//     [N, C] each. Here: emox_group_norm_stats, the statistics kernel and
//     the finalize kernel.
//
// What bounds them on the H100: both are streaming passes with a handful
// of flops per element, so device memory bounds them (UNet level 0 under
// CFG: [32, 1024, 320] bf16, 21 MB each way; the VAE's full-resolution
// decode: [16, 65536, 128] bf16, 268 MB). A sample's slab is far beyond one
// block's shared memory, and N is 1-32, so the TPU's one-sample-per-step
// grid does not carry over. The design:
//   * grid (chunks, N) over row chunks of each sample, chunks chosen by the
//     wrapper so that the grid holds a few blocks per SM;
//   * thread t of a block owns the 16-byte column vector t % (C / VEC) of
//     every (256 / (C / VEC))-th row of the chunk (several vectors per row
//     when a row is wider than 256 vectors): every warp reads whole 16-byte
//     vectors of consecutive addresses, and the per-channel constants of the
//     apply stay in registers;
//   * statistics: per-thread fp32 sums over its rows, a fixed-order tree
//     over the threads that share a column in shared memory, one partial
//     per (sample, chunk, channel) in device memory, then a second small
//     pass (one block per sample) that sums the partials in chunk order and
//     folds channels into groups. No float atomics: a run repeats bit for
//     bit. The folding replaces the TPU kernel's 0/1 `agg` matmuls.
// K8a reads x twice (statistics, then apply): at the UNet's widths the
// second read mostly hits the 50 MB L2. No TMA, no persistence: those
// belong to the PR that makes it fast.
#include "common.cuh"

namespace emox {

constexpr int kGNThreads = 256;

// Which rows and 16-byte column vectors of a chunk this thread owns.
struct RowSplit {
  int vpr;      // vectors per row
  int rpp;      // rows per pass of the block
  int r0;       // this thread's first row of the chunk
  int cv0;      // its first column vector
  int cv_step;  // stride between its column vectors
  bool active;  // false for the threads left over when 256 % vpr != 0

  __device__ RowSplit(int c, int vec) {
    vpr = c / vec;
    if (vpr <= kGNThreads) {
      rpp = kGNThreads / vpr;
      r0 = threadIdx.x / vpr;
      cv0 = threadIdx.x % vpr;
      cv_step = vpr;
      active = r0 < rpp;
    } else {
      rpp = 1;
      r0 = 0;
      cv0 = threadIdx.x;
      cv_step = kGNThreads;
      active = true;
    }
  }
};

// part: [2, N, chunks, C] fp32, sums then sums of squares over the chunk's rows.
template <typename T>
__global__ void __launch_bounds__(kGNThreads)
    gn_stats_kernel(const T* __restrict__ x, int l, int c, int rows_per_chunk,
                    float* __restrict__ part) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float red[];  // [2, rpp, C]
  const RowSplit sp(c, V);
  const int n = blockIdx.y;
  const int chunks = gridDim.x;
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(l, row_begin + rows_per_chunk);
  const T* xs = x + (size_t)n * l * c;
  float* rs = red;
  float* rss = red + sp.rpp * c;
  if (sp.active) {
    for (int cv = sp.cv0; cv < sp.vpr; cv += sp.cv_step) {
      float s[V] = {};
      float ss[V] = {};
      for (int r = row_begin + sp.r0; r < row_end; r += sp.rpp) {
        float v[V];
        Vec16<T>::load(xs + (size_t)r * c + cv * V, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[i];
          ss[i] += v[i] * v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        rs[sp.r0 * c + cv * V + i] = s[i];
        rss[sp.r0 * c + cv * V + i] = ss[i];
      }
    }
  }
  __syncthreads();
  // fixed-order tree over the rpp rows of partial sums
  for (int width = sp.rpp; width > 1;) {
    const int half = (width + 1) / 2;
    for (int i = threadIdx.x; i < (width - half) * c; i += kGNThreads) {
      rs[i] += rs[i + half * c];
      rss[i] += rss[i + half * c];
    }
    width = half;
    __syncthreads();
  }
  const size_t plane = (size_t)gridDim.y * chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    const size_t o = ((size_t)n * chunks + blockIdx.x) * c + ch;
    part[o] = rs[ch];
    part[plane + o] = rss[ch];
  }
}

// One block per sample: the chunk partials summed in chunk order. Writes
// sums [2, N, C] (per-channel sum and sum of squares) when non-null, and
// mean_inv [2, N, C] (each channel's group mean and 1/sqrt(var + eps)) when
// non-null.
__global__ void __launch_bounds__(kGNThreads)
    gn_finalize_kernel(const float* __restrict__ part, int chunks, int c, int groups, int l,
                       float eps, float* __restrict__ sums, float* __restrict__ mean_inv) {
  extern __shared__ float tot[];  // [2, C]
  const int n = blockIdx.x;
  const size_t plane_in = (size_t)gridDim.x * chunks * c;
  const size_t plane_out = (size_t)gridDim.x * c;
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    float s = 0.f;
    float ss = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const size_t o = ((size_t)n * chunks + k) * c + ch;
      s += part[o];
      ss += part[plane_in + o];
    }
    if (sums != nullptr) {
      sums[(size_t)n * c + ch] = s;
      sums[plane_out + (size_t)n * c + ch] = ss;
    }
    tot[ch] = s;
    tot[c + ch] = ss;
  }
  if (mean_inv == nullptr) return;
  __syncthreads();
  const int cg = c / groups;
  const float cnt = (float)(l * cg);
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    const int g0 = (ch / cg) * cg;
    float sg = 0.f;
    float ssg = 0.f;
    for (int j = 0; j < cg; ++j) {
      sg += tot[g0 + j];
      ssg += tot[c + g0 + j];
    }
    const float mean = sg / cnt;
    const float var = ssg / cnt - mean * mean;
    mean_inv[(size_t)n * c + ch] = mean;
    mean_inv[plane_out + (size_t)n * c + ch] = rsqrtf(var + eps);
  }
}

// y = (x - mean) * inv * gamma + beta in fp32, SiLU when asked, rounded to T.
template <typename T>
__global__ void __launch_bounds__(kGNThreads)
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, const float* __restrict__ mean_inv,
                    T* __restrict__ y, int l, int c, int rows_per_chunk, int silu) {
  constexpr int V = Vec16<T>::N;
  const RowSplit sp(c, V);
  if (!sp.active) return;
  const int n = blockIdx.y;
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(l, row_begin + rows_per_chunk);
  const float* mean = mean_inv + (size_t)n * c;
  const float* inv = mean_inv + ((size_t)gridDim.y + n) * c;
  const size_t base = (size_t)n * l * c;
  for (int cv = sp.cv0; cv < sp.vpr; cv += sp.cv_step) {
    float mu[V], iv[V], g[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int ch = cv * V + i;
      mu[i] = mean[ch];
      iv[i] = inv[ch];
      g[i] = to_float(gamma[ch]);
      b[i] = to_float(beta[ch]);
    }
#pragma unroll 4
    for (int r = row_begin + sp.r0; r < row_end; r += sp.rpp) {
      const size_t o = base + (size_t)r * c + cv * V;
      float v[V];
      Vec16<T>::load(x + o, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = (v[i] - mu[i]) * iv[i] * g[i] + b[i];
        if (silu) t = t * (1.f / (1.f + expf(-t)));
        v[i] = t;
      }
      Vec16<T>::store(y + o, v);
    }
  }
}

constexpr size_t kStaticSmemMax = 48 * 1024;

static size_t stats_smem(int c, int vec) {
  const int vpr = c / vec;
  const int rpp = vpr <= kGNThreads ? kGNThreads / vpr : 1;
  return sizeof(float) * 2 * (size_t)rpp * c;
}

template <typename T>
static cudaError_t launch_stats(const void* x, float* part, float* sums, float* mean_inv, int n,
                                int l, int c, int groups, int chunks, float eps,
                                cudaStream_t stream) {
  const size_t smem = stats_smem(c, Vec16<T>::N);
  const size_t fin_smem = sizeof(float) * 2 * (size_t)c;
  if (smem > kStaticSmemMax || fin_smem > kStaticSmemMax) return cudaErrorInvalidValue;
  const int rows_per_chunk = (l + chunks - 1) / chunks;
  gn_stats_kernel<T><<<dim3(chunks, n), kGNThreads, smem, stream>>>(
      static_cast<const T*>(x), l, c, rows_per_chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<n, kGNThreads, fin_smem, stream>>>(part, chunks, c, groups, l, eps, sums,
                                                          mean_inv);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                                    float* part, float* mean_inv, int n, int l, int c,
                                    int groups, int chunks, float eps, int silu,
                                    cudaStream_t stream) {
  cudaError_t err = launch_stats<T>(x, part, nullptr, mean_inv, n, l, c, groups, chunks, eps,
                                    stream);
  if (err != cudaSuccess) return err;
  const int rows_per_chunk = (l + chunks - 1) / chunks;
  gn_apply_kernel<T><<<dim3(chunks, n), kGNThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      mean_inv, static_cast<T*>(y), l, c, rows_per_chunk, silu);
  return cudaGetLastError();
}

static bool bad_shape(int n, int l, int c, int groups, int chunks, int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  return n <= 0 || n > 65535 || l <= 0 || c <= 0 || c % vec != 0 || groups <= 0 ||
         c % groups != 0 || chunks <= 0 || (dtype != 0 && dtype != 1);
}

}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16, the type of x, gamma, beta and y.
// x and y [n, l, c] contiguous and 16-byte aligned, c % (16 / sizeof) == 0;
// gamma, beta [c]. Scratch: part [2, n, chunks, c] and mean_inv [2, n, c]
// fp32. Returns a cudaError_t (0 = launched).
extern "C" int emox_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                               void* part, void* mean_inv, int n, int l, int c, int groups,
                               int chunks, float eps, int silu, int dtype, void* stream) {
  using namespace emox;
  if (bad_shape(n, l, c, groups, chunks, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* mi = static_cast<float*>(mean_inv);
  if (dtype == 1)
    return (int)launch_group_norm<__nv_bfloat16>(x, gamma, beta, y, p, mi, n, l, c, groups,
                                                 chunks, eps, silu, s);
  return (int)launch_group_norm<float>(x, gamma, beta, y, p, mi, n, l, c, groups, chunks, eps,
                                       silu, s);
}

// Per-channel fp32 sum and sum of squares of x [n, l, c] over l: sums
// [2, n, c]. Scratch part [2, n, chunks, c] fp32. Returns a cudaError_t.
extern "C" int emox_group_norm_stats(const void* x, void* part, void* sums, int n, int l, int c,
                                     int chunks, int dtype, void* stream) {
  using namespace emox;
  if (bad_shape(n, l, c, 1, chunks, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(sums);
  if (dtype == 1)
    return (int)launch_stats<__nv_bfloat16>(x, p, out, nullptr, n, l, c, 1, chunks, 0.f, s);
  return (int)launch_stats<float>(x, p, out, nullptr, n, l, c, 1, chunks, 0.f, s);
}
