// GroupNorm(+SiLU) and its statistics for Hopper (sm_90a), on x [N, L, C]
// (NHWC feature maps with H*W folded into L), C split into `groups` runs
// of C / groups adjacent channels; float32 and bfloat16.
//
// Replaces two TPU kernels (emox/ops/groupnorm.py):
//   * `_gn_kernel` (K8a, :184, called at :215): statistics and apply in one
//     pass over a sample's [L, C] slab held in VMEM:
//     y = (x - mean) * inv * gamma + beta in fp32, then SiLU, then one
//     rounding to x's type;
//   * `_gn_stats_kernel` (K8b, :74, called at :115): per-channel fp32 sum
//     and sum of squares, [N, C] each.
//
// What bounds them on the H100: both are streaming passes with a handful
// of flops per element, so device memory bounds them: x read once (and y
// written once, K8a). UNet level 0 under CFG: [32, 1024, 320] bf16, 21 MB
// each way (12.5 us); the VAE's full-resolution decode: [16, 65536, 128]
// bf16, 268 MB each way (160 us).
//
// The design, chosen per shape by the wrapper's plan (gn_plan in
// emox_torch/ops/groupnorm.py, which follows the regimes' times on the H100):
//   * "cluster": a sample's slab fits the shared memory of a thread-block
//     cluster (up to 16 blocks) at two blocks an SM (the UNet's GroupNorms
//     at 256^2 and at 512^2 but level 0, in bf16). One launch, one cluster
//     per sample; block r of the
//     cluster owns rows [r * rows, (r + 1) * rows). K8a: the block copies
//     its rows into shared memory with bulk async copies (one mbarrier),
//     forms per-channel fp32 partials there, the blocks exchange partials
//     through distributed shared memory (each sums all of them in rank
//     order, so every block holds the same bits), fold channels into
//     groups, and apply from shared memory: x is read once and y written
//     once. K8b: each block streams its rows from device memory, and after
//     the exchange block r writes its share of the channels' sums. A
//     cluster.sync() after the exchange keeps every block's shared memory
//     alive until the last remote read is done.
//   * "two launches": a larger slab (the VAE's full-resolution maps, 512^2
//     level 0, float32 slabs past a cluster's shared memory; where a
//     cluster would hold one block an SM, its load and apply phases cannot
//     overlap, and two launches measured faster). The statistics kernel
//     writes per-(sample, row chunk) partials, grid (chunks, N); then K8a's
//     apply kernel sums its sample's partials in chunk order in its prologue
//     and applies to its chunk, walking the chunks in reverse so that it
//     first reads the rows the statistics read last (the likeliest still in
//     the 50 MB L2); K8b's finalize kernel sums the partials per channel.
// Within a block, thread t owns the 16-byte column vector t % (C / VEC) of
// every (256 / (C / VEC))-th row (several vectors per row when a row is
// wider than 256 vectors), and a fixed-order tree over the threads that
// share a column sums their partials. No float atomics anywhere: a run
// repeats bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace emox {

namespace coop = cooperative_groups;

constexpr int kGNThreads = 256;
constexpr int kMaxCluster = 16;
constexpr size_t kSmemMax = 232448;      // the 227 KB a block may use
constexpr uint32_t kBulkPiece = 32768;  // bytes per bulk copy, at most
constexpr int kMaxPieces = 16;          // bulk copies (each with its mbarrier) per block

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Which rows and 16-byte column vectors of a run of rows this thread owns.
struct RowSplit {
  int vpr;      // vectors per row
  int rpp;      // rows per pass of the block
  int r0;       // this thread's first row
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

__host__ __device__ inline int rows_per_pass(int c, int itemsize) {
  const int vpr = c * itemsize / 16;
  return vpr <= kGNThreads ? kGNThreads / vpr : 1;
}

// Shared memory of a cluster block: its rows (K8a only), the tree
// [2, rpp, C], the totals [2, C] and the group statistics [2, groups] in
// fp32, and the pieces' mbarriers. gn_smem in emox_torch/ops/groupnorm.py
// is the same sum.
__host__ __device__ inline size_t cluster_smem(int rows, int c, int groups, int itemsize, bool apply) {
  const size_t slab = apply ? align16((size_t)rows * c * itemsize) : 0;
  const size_t floats = 2 * (size_t)rows_per_pass(c, itemsize) * c + 2 * (size_t)c + 2 * (size_t)groups;
  return slab + align16(4 * floats) + 8 * kMaxPieces;
}

// Rows per bulk copy of a block's `rows` rows: at most kBulkPiece bytes, and
// at most kMaxPieces copies.
__host__ __device__ inline int piece_rows(int rows, int c, int itemsize) {
  const int by_bytes = (int)(kBulkPiece / ((uint32_t)c * itemsize));
  const int by_count = (rows + kMaxPieces - 1) / kMaxPieces;
  return by_bytes > by_count ? (by_bytes > 1 ? by_bytes : 1) : (by_count > 1 ? by_count : 1);
}

// Per-channel fp32 sum and sum of squares of `rows` rows of src (row stride
// c) into red[ch] and red[rpp * c + ch], by per-thread sums and a
// fixed-order tree over the rpp threads of each column. Ends synchronised.
// With bars (src in shared memory, arriving in pieces of `pr` rows), a
// thread waits for each piece before its first row of it.
template <typename T>
__device__ void block_sums(const T* src, int rows, int c, float* red, uint32_t bars = 0, int pr = 1) {
  constexpr int V = Vec16<T>::N;
  const RowSplit sp(c, V);
  float* rs = red;
  float* rss = red + sp.rpp * c;
  if (sp.active) {
    int ready = 0;  // pieces this thread has waited for
    for (int cv = sp.cv0; cv < sp.vpr; cv += sp.cv_step) {
      float s[V] = {};
      float ss[V] = {};
      for (int r = sp.r0; r < rows; r += sp.rpp) {
        if (bars != 0) {
          for (; ready <= r / pr; ++ready) sm90::mbar_wait(bars + 8 * ready, 0);
        }
        float v[V];
        Vec16<T>::load(src + (size_t)r * c + cv * V, v);
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
  for (int width = sp.rpp; width > 1;) {
    const int half = (width + 1) / 2;
    for (int i = threadIdx.x; i < (width - half) * c; i += kGNThreads) {
      rs[i] += rs[i + half * c];
      rss[i] += rss[i + half * c];
    }
    width = half;
    __syncthreads();
  }
}

// Group mean and 1/sqrt(var + eps) from per-channel totals tot [2, C] into
// gst [2, groups]: the TPU kernel's E[x^2] - mean^2 over L * C / groups.
__device__ void fold_groups(const float* tot, float* gst, int l, int c, int groups, float eps) {
  const int cg = c / groups;
  const float cnt = (float)l * (float)cg;
  for (int g = threadIdx.x; g < groups; g += kGNThreads) {
    float sg = 0.f;
    float ssg = 0.f;
    for (int j = 0; j < cg; ++j) {
      sg += tot[g * cg + j];
      ssg += tot[c + g * cg + j];
    }
    const float mean = sg / cnt;
    gst[g] = mean;
    gst[groups + g] = rsqrtf(ssg / cnt - mean * mean + eps);
  }
  __syncthreads();
}

// y = (x - mean) * inv * gamma + beta in fp32, SiLU when asked, rounded to
// T, for `rows` rows of src (shared or device memory) into dst.
template <typename T>
__device__ void apply_rows(const T* src, T* dst, int rows, int c, int groups, const float* gst,
                           const T* __restrict__ gamma, const T* __restrict__ beta, int silu) {
  constexpr int V = Vec16<T>::N;
  const RowSplit sp(c, V);
  if (!sp.active) return;
  const int cg = c / groups;
  for (int cv = sp.cv0; cv < sp.vpr; cv += sp.cv_step) {
    float mu[V], iv[V], g[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int ch = cv * V + i;
      mu[i] = gst[ch / cg];
      iv[i] = gst[groups + ch / cg];
      g[i] = to_float(gamma[ch]);
      b[i] = to_float(beta[ch]);
    }
#pragma unroll 4
    for (int r = sp.r0; r < rows; r += sp.rpp) {
      const size_t o = (size_t)r * c + cv * V;
      float v[V];
      Vec16<T>::load(src + o, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = (v[i] - mu[i]) * iv[i] * g[i] + b[i];
        if (silu) t = __fdividef(t, 1.f + __expf(-t));
        v[i] = t;
      }
      Vec16<T>::store(dst + o, v);
    }
  }
}

// ---- one launch: a cluster per sample --------------------------------------------
// APPLY (K8a): the block's rows copied into shared memory in pieces (a bulk
// copy and an mbarrier each, so the sums start on the first piece), then y
// applied from there: x read once. Else (K8b): the block's rows streamed
// from device memory, and sums [2, N, C] written, each block its share of
// the channels.
template <typename T, bool APPLY>
__global__ void __launch_bounds__(kGNThreads)
    gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
                      T* __restrict__ y, float* __restrict__ sums, int l, int c, int groups, int rows_per_block,
                      float eps, int silu) {
  extern __shared__ __align__(16) uint8_t smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int k = (int)cluster.num_blocks();
  const int n = blockIdx.y;
  const int r_begin = min(l, rank * rows_per_block);
  const int rows = min(l, r_begin + rows_per_block) - r_begin;
  const int rpp = rows_per_pass(c, sizeof(T));
  const T* xs = x + ((size_t)n * l + r_begin) * c;
  const size_t slab = APPLY ? align16((size_t)rows_per_block * c * sizeof(T)) : 0;
  float* red = reinterpret_cast<float*>(smem + slab);
  float* tot = red + 2 * rpp * c;
  float* gst = tot + 2 * c;
  const T* src = xs;
  uint32_t bars = 0;
  int pr = 1;
  if constexpr (APPLY) {
    bars = sm90::smem_u32(smem + slab + align16(4 * (2 * (size_t)rpp * c + 2 * c + 2 * groups)));
    pr = piece_rows(rows_per_block, c, sizeof(T));
    const int pieces = (rows + pr - 1) / pr;
    if (threadIdx.x == 0) {
      for (int p = 0; p < pieces; ++p) sm90::mbar_init(bars + 8 * p, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int p = 0; p < pieces; ++p) {
        const uint32_t bytes = (uint32_t)(min(rows, (p + 1) * pr) - p * pr) * c * sizeof(T);
        const uint32_t off = (uint32_t)p * pr * c * sizeof(T);
        sm90::mbar_expect_tx(bars + 8 * p, bytes);
        sm90::bulk_load(sm90::smem_u32(smem) + off, reinterpret_cast<const uint8_t*>(xs) + off, bytes, bars + 8 * p);
      }
    }
    src = reinterpret_cast<const T*>(smem);
  }
  block_sums<T>(src, rows, c, red, bars, pr);
  cluster.sync();  // every block's partials written and visible to the cluster
  if constexpr (APPLY) {
    for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
      float s = 0.f;
      float ss = 0.f;
      for (int r = 0; r < k; ++r) {
        const float* remote = cluster.map_shared_rank(red, r);
        s += remote[ch];
        ss += remote[rpp * c + ch];
      }
      tot[ch] = s;
      tot[c + ch] = ss;
    }
  } else {
    const int share = (c + k - 1) / k;
    const int c1 = min(c, (rank + 1) * share);
    const size_t plane = (size_t)gridDim.y * c;
    for (int ch = rank * share + threadIdx.x; ch < c1; ch += kGNThreads) {
      float s = 0.f;
      float ss = 0.f;
      for (int r = 0; r < k; ++r) {
        const float* remote = cluster.map_shared_rank(red, r);
        s += remote[ch];
        ss += remote[rpp * c + ch];
      }
      sums[(size_t)n * c + ch] = s;
      sums[plane + (size_t)n * c + ch] = ss;
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
  if constexpr (!APPLY) return;
  fold_groups(tot, gst, l, c, groups, eps);
  apply_rows<T>(src, y + ((size_t)n * l + r_begin) * c, rows, c, groups, gst, gamma, beta, silu);
}

// ---- two launches: chunk partials, then apply or finalize -------------------------
// part: [2, N, chunks, C] fp32, sums then sums of squares over the chunk's rows.
template <typename T>
__global__ void __launch_bounds__(kGNThreads)
    gn_stats_kernel(const T* __restrict__ x, int l, int c, int rows_per_chunk, float* __restrict__ part) {
  extern __shared__ float red[];  // [2, rpp, C]
  const int n = blockIdx.y;
  const int chunks = gridDim.x;
  const int row_begin = min(l, blockIdx.x * rows_per_chunk);
  const int rows = min(l, row_begin + rows_per_chunk) - row_begin;
  block_sums<T>(x + ((size_t)n * l + row_begin) * c, rows, c, red);
  const int rpp = rows_per_pass(c, sizeof(T));
  const size_t plane = (size_t)gridDim.y * chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    const size_t o = ((size_t)n * chunks + blockIdx.x) * c + ch;
    part[o] = red[ch];
    part[plane + o] = red[rpp * c + ch];
  }
}

// K8a's apply: the sample's chunk partials summed in chunk order, folded into
// groups, then applied to one chunk. Chunks and samples run in reverse.
template <typename T>
__global__ void __launch_bounds__(kGNThreads)
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
                    const float* __restrict__ part, T* __restrict__ y, int l, int c, int groups,
                    int rows_per_chunk, float eps, int silu) {
  extern __shared__ float tot[];  // [2, C], then the group statistics [2, groups]
  float* gst = tot + 2 * c;
  const int chunks = gridDim.x;
  const int chunk = chunks - 1 - blockIdx.x;
  const int n = gridDim.y - 1 - blockIdx.y;
  const size_t plane = (size_t)gridDim.y * chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    float s = 0.f;
    float ss = 0.f;
    const float* p = part + (size_t)n * chunks * c + ch;
#pragma unroll 8
    for (int j = 0; j < chunks; ++j) {
      s += p[(size_t)j * c];
      ss += p[plane + (size_t)j * c];
    }
    tot[ch] = s;
    tot[c + ch] = ss;
  }
  __syncthreads();
  fold_groups(tot, gst, l, c, groups, eps);
  const int row_begin = min(l, chunk * rows_per_chunk);
  const int rows = min(l, row_begin + rows_per_chunk) - row_begin;
  const size_t o = ((size_t)n * l + row_begin) * c;
  apply_rows<T>(x + o, y + o, rows, c, groups, gst, gamma, beta, silu);
}

// K8b's finalize: one block per sample, the chunk partials summed in chunk
// order into sums [2, N, C].
__global__ void __launch_bounds__(kGNThreads)
    gn_finalize_kernel(const float* __restrict__ part, int chunks, int c, float* __restrict__ sums) {
  const int n = blockIdx.x;
  const size_t plane_in = (size_t)gridDim.x * chunks * c;
  const size_t plane_out = (size_t)gridDim.x * c;
  for (int ch = threadIdx.x; ch < c; ch += kGNThreads) {
    float s = 0.f;
    float ss = 0.f;
    for (int j = 0; j < chunks; ++j) {
      const size_t o = ((size_t)n * chunks + j) * c + ch;
      s += part[o];
      ss += part[plane_in + o];
    }
    sums[(size_t)n * c + ch] = s;
    sums[plane_out + (size_t)n * c + ch] = ss;
  }
}

// ---- host side ------------------------------------------------------------------
template <typename T, bool APPLY>
static cudaError_t launch_cluster(const void* x, const void* gamma, const void* beta, void* y, float* sums, int n,
                                  int l, int c, int groups, int cluster, float eps, int silu, cudaStream_t stream) {
  const int rows = (l + cluster - 1) / cluster;
  const size_t smem = cluster_smem(rows, c, groups, sizeof(T), APPLY);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = gn_cluster_kernel<T, APPLY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8 && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
                         cudaSuccess) {
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n);
  cfg.blockDim = dim3(kGNThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(gamma),
                           static_cast<const T*>(beta), static_cast<T*>(y), sums, l, c, groups, rows, eps, silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_stats(const void* x, float* part, int n, int l, int c, int chunks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)rows_per_pass(c, sizeof(T)) * c;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gn_stats_kernel<T><<<dim3(chunks, n), kGNThreads, smem, stream>>>(static_cast<const T*>(x), l, c,
                                                                     (l + chunks - 1) / chunks, part);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_group_norm(const void* x, const void* gamma, const void* beta, void* y, float* part, int n,
                                     int l, int c, int groups, int cluster, int chunks, float eps, int silu,
                                     cudaStream_t stream) {
  if (cluster > 0) {
    return launch_cluster<T, true>(x, gamma, beta, y, nullptr, n, l, c, groups, cluster, eps, silu, stream);
  }
  cudaError_t err = launch_stats<T>(x, part, n, l, c, chunks, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * (size_t)c + 2 * (size_t)groups);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gn_apply_kernel<T><<<dim3(chunks, n), kGNThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta), part,
      static_cast<T*>(y), l, c, groups, (l + chunks - 1) / chunks, eps, silu);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_sums(const void* x, float* part, float* sums, int n, int l, int c, int cluster, int chunks,
                               cudaStream_t stream) {
  if (cluster > 0) return launch_cluster<T, false>(x, nullptr, nullptr, nullptr, sums, n, l, c, 1, cluster, 0.f, 0,
                                                   stream);
  cudaError_t err = launch_stats<T>(x, part, n, l, c, chunks, stream);
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<n, kGNThreads, 0, stream>>>(part, chunks, c, sums);
  return cudaGetLastError();
}

// How many clusters of `cluster` K8a blocks (each holding `rows` rows of C
// channels) the card holds at once, or a negative cudaError_t.
template <typename T>
static int max_clusters(int cluster, int rows, int c, int groups) {
  const size_t smem = cluster_smem(rows, c, groups, sizeof(T), true);
  if (smem > kSmemMax) return 0;
  auto kernel = gn_cluster_kernel<T, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kGNThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int num = 0;
  err = cudaOccupancyMaxActiveClusters(&num, kernel, &cfg);
  return err == cudaSuccess ? num : -(int)err;
}

static bool bad_shape(int n, int l, int c, int groups, int cluster, int chunks, int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  return n <= 0 || n > 65535 || l <= 0 || c <= 0 || c % vec != 0 || groups <= 0 || c % groups != 0 ||
         cluster < 0 || cluster > kMaxCluster || (cluster == 0 && chunks <= 0) || (dtype != 0 && dtype != 1);
}

}  // namespace emox

// dtype: 0 = float32, 1 = bfloat16, the type of x, gamma, beta and y.
// x and y [n, l, c] contiguous and 16-byte aligned, c % (16 / sizeof) == 0;
// gamma, beta [c]. cluster 1-16: one launch, a cluster of that many blocks
// per sample, each holding ceil(l / cluster) rows in shared memory (part
// unused). cluster 0: two launches over `chunks` row chunks per sample,
// with scratch part [2, n, chunks, c] fp32. Returns a cudaError_t (0 = launched).
extern "C" int emox_group_norm(const void* x, const void* gamma, const void* beta, void* y, void* part, int n, int l,
                               int c, int groups, int cluster, int chunks, float eps, int silu, int dtype,
                               void* stream) {
  using namespace emox;
  if (bad_shape(n, l, c, groups, cluster, chunks, dtype) || (cluster == 0 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return (int)launch_group_norm<__nv_bfloat16>(x, gamma, beta, y, p, n, l, c, groups, cluster, chunks, eps, silu, s);
  return (int)launch_group_norm<float>(x, gamma, beta, y, p, n, l, c, groups, cluster, chunks, eps, silu, s);
}

// Per-channel fp32 sum and sum of squares of x [n, l, c] over l: sums
// [2, n, c]. cluster 1-16: one launch (part unused); cluster 0: two, with
// scratch part [2, n, chunks, c] fp32. Returns a cudaError_t.
extern "C" int emox_group_norm_stats(const void* x, void* part, void* sums, int n, int l, int c, int cluster,
                                     int chunks, int dtype, void* stream) {
  using namespace emox;
  if (bad_shape(n, l, c, 1, cluster, chunks, dtype) || (cluster == 0 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(sums);
  if (dtype == 1) return (int)launch_sums<__nv_bfloat16>(x, p, out, n, l, c, cluster, chunks, s);
  return (int)launch_sums<float>(x, p, out, n, l, c, cluster, chunks, s);
}

// How many clusters of `cluster` K8a blocks of `rows` rows x c channels the
// card holds at once (cudaOccupancyMaxActiveClusters; the planner picks a
// cluster size that puts every sample in one wave), or a negative cudaError_t.
extern "C" int emox_group_norm_clusters(int cluster, int rows, int c, int groups, int dtype) {
  using namespace emox;
  if (cluster < 1 || cluster > kMaxCluster || rows < 1 || c <= 0 || groups <= 0 || (dtype != 0 && dtype != 1)) {
    return -(int)cudaErrorInvalidValue;
  }
  return dtype == 1 ? max_clusters<__nv_bfloat16>(cluster, rows, c, groups) : max_clusters<float>(cluster, rows, c, groups);
}
