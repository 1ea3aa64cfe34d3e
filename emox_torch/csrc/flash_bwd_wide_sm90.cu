// Flash-attention backward at head dims above 512 for Hopper (sm_90a):
// wgmma + TMA, bf16 and float32 (a two-part bf16 split), the head dim split
// over a cluster of blocks that compute S and dP once a tile.
//
// Replaces the TPU kernels `_flash_bwd_nlc_dq_kernel` /
// `_flash_bwd_nlc_dkv_kernel` (emox/ops/attention.py:465, :508) and
// `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` (:118, :160) where the
// head dim is above 512, within the plan's reach (bf16 up to 2048, float32
// up to 1536; wider heads keep flash_attn_wide.cu's slice kernels): from q,
// k, v, dO, lse and delta = sum_d dO*O it returns
//   P = exp(q k^T * scale - lse),  dv = P^T dO,  dS = P (dO v^T - delta),
//   dq = dS k * scale,             dk = dS^T q * scale.
//
// What bounds it on the H100: 10 N*H*Lq*Lk*d flops on the tensor cores
// (three times over on float32's parts); the kernels issue 7 of those units
// over the slices' padded width, S and dP once in each kernel. The slice
// kernels they replace (flash_attn_wide.cu) issued 2 (4 d / 128 + 3) units,
// S and dP once for every 128-column slice: 4.6x the work at d 640.
//
// The design is flash_bwd_d512_sm90.cu's pair, generalised
// (flash_bwd_cluster.cuh with CLUSTER 0): a cluster of cs blocks per 64-row
// tile (dq: query rows; dk/dv: keys), each owning a slice of HALF columns of
// every operand and gradient, its S and dP partials summed over the cluster
// in log2(cs) butterfly rounds through distributed shared memory (the same
// bits in every rank). The plan (wide_plan in emox_torch/ops/attention.py)
// picks the slices, their width and the ring's stages; this entry only
// checks it (cluster_bwd_fits). The instances:
//   * bf16: HALF 320 (a pair at d <= 640; one ring stage, two do not fit),
//     HALF 192 and 256 (four or eight slices; two stages);
//   * float32: HALF 192 (four or eight slices; one stage) and 128 (eight;
//     two stages): a HALF 256 float32 block does not fit, and a cluster of
//     five has no butterfly, so d 640 takes four slices of 192 (768 columns,
//     zero-padded in the split scratch).
// Where that takes fewer waves of the clusters the card holds at once (the
// float32 VAE's N 1 x 1024: 16 row tiles), the plan splits the streamed
// dimension (keys in dq, query rows in dk/dv) over two halves of the
// cluster (cs slices x 2 parts <= 8 blocks), merged at the end through
// distributed shared memory. The dq kernel runs on a second stream beside
// the dk/dv kernel (forked from and joined to the caller's by events), so
// the two grids fill the card together: on the H100 the 16 clusters of 8 of
// one float32 kernel are one more than it holds.
#include "flash_bwd_cluster.cuh"

namespace emox {
namespace bwd_wide_sm90 {

using namespace emox::bwd_d512_sm90;

// The cluster backward's plan for a head dim: slices cs of HALF columns,
// ring stages, and the parts (1 or 2) of the streamed dimension of the dq
// and dk/dv kernels
struct ClusterBwd {
  int cs, half, stages, dq_parts, dkv_parts;
};

// Whether plan p can run head dim d with q_tiles 64-row query tiles and
// k_tiles key tiles (wide_plan chooses it; this only checks it): an
// instantiated (type, slice width, stages), 2, 4 or 8 slices that cover d,
// and each kernel's streamed dimension in one part, or in two where both
// have tiles and the cluster stays within the portable 8 blocks. Each
// instance's shared memory is checked where it is compiled.
static bool cluster_bwd_fits(int parts, int d, int q_tiles, int k_tiles, const ClusterBwd& p) {
  const bool inst = parts == 1 ? ((p.half == 192 || p.half == 256) && p.stages == 2) || (p.half == 320 && p.stages == 1)
                               : (p.half == 128 && p.stages == 2) || (p.half == 192 && p.stages == 1);
  if (!inst || (p.cs != 2 && p.cs != 4 && p.cs != 8) || p.cs * p.half < d) return false;
  const int split[2] = {p.dq_parts, p.dkv_parts}, streamed[2] = {k_tiles, q_tiles};
  for (int i = 0; i < 2; ++i) {
    if (split[i] < 1 || split[i] > 2 || p.cs * split[i] > 8 || (split[i] == 2 && streamed[i] < 2)) return false;
  }
  return true;
}

// The current device's second stream and fork / join events, made at its
// first call and kept for the process
static cudaError_t side_stream(Fork* out) {
  static Fork forks[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Fork& f = forks[dev];
  if (f.stream == nullptr) {
    if ((err = cudaEventCreateWithFlags(&f.fork, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&f.join, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaStreamCreateWithFlags(&f.stream, cudaStreamNonBlocking)) != cudaSuccess) {
      return err;
    }
  }
  *out = f;
  return cudaSuccess;
}

template <int PARTS, typename TO>
static cudaError_t run(const ClusterBwd& p, const void* q, const void* k, const void* v, const void* dout,
                       const long long* st, int width, const Args<TO>& a, int batch, cudaStream_t s) {
  Fork side;
  const cudaError_t err = side_stream(&side);
  if (err != cudaSuccess) return err;
  if constexpr (PARTS == 1) {
    if (p.half == 320) return launch<320, 1, 0, 1>(q, k, v, dout, st, width, a, batch, s, side);
    if (p.half == 192) return launch<192, 1, 0, 2>(q, k, v, dout, st, width, a, batch, s, side);
    return launch<256, 1, 0, 2>(q, k, v, dout, st, width, a, batch, s, side);
  } else {
    if (p.half == 192) return launch<192, 2, 0, 1>(q, k, v, dout, st, width, a, batch, s, side);
    return launch<128, 2, 0, 2>(q, k, v, dout, st, width, a, batch, s, side);
  }
}

// How many clusters of `cluster` blocks of an instance's dq (or dk/dv)
// kernel the card holds at once, or a negative cudaError_t
template <int HALF, int PARTS, int STAGES, typename TO>
static int held(int cluster, bool dkv) {
  const void* kernel = dkv ? reinterpret_cast<const void*>(dkv_kernel<HALF, PARTS, 0, STAGES, TO>)
                           : reinterpret_cast<const void*>(dq_kernel<HALF, PARTS, 0, STAGES, TO>);
  const uint32_t smem = dkv ? DkvSmem<HALF, PARTS, 0, STAGES>::bytes : DqSmem<HALF, PARTS, 0, STAGES>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
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

}  // namespace bwd_wide_sm90
}  // namespace emox

// Attention backward at head dims above 512 on [batch, heads, L, head_dim]
// operands with element strides, bf16 (dtype 1) or float32 (dtype 0):
// `strides` holds (batch, head, row) for q, k, v, dout, dq, dk and dv (21
// values; those of an output not asked for are ignored), the head dim
// contiguous, rows 16-byte aligned (head_dim a multiple of 8 in bf16, of 4
// in float32). lse and delta: [batch, heads, lq_pad] float32, contiguous,
// 16-byte aligned, lq_pad a multiple of 64 with lq <= lq_pad < lq + 64,
// padded with lse = +inf and delta = 0. dq == NULL skips the dq kernel; dk
// and dv are both given (the dk/dv kernel runs) or both NULL. (cs, half,
// stages, dq_parts, dkv_parts) is the plan wide_plan gives (ClusterBwd); a
// plan the kernels cannot run (cluster_bwd_fits) is refused. Float32 first
// splits q, k, v and dout into q2, k2, v2, do2: bf16 scratch of [batch,
// heads, lq or lk, 2 cs half] elements, contiguous (NULL in bf16). Returns
// a cudaError_t (0 = launched).
extern "C" int emox_flash_bwd_wide_sm90(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                        const long long* strides, int batch, int heads, int lq, int lk, int lq_pad,
                                        int head_dim, float scale, int dtype, int cs, int half, int stages,
                                        int dq_parts, int dkv_parts, void* q2, void* k2, void* v2, void* do2,
                                        void* stream) {
  using namespace emox::bwd_wide_sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ClusterBwd plan{cs, half, stages, dq_parts, dkv_parts};
  if (bad_args(batch, heads, lq, lk, lq_pad, lse, delta, dk, dv) || head_dim <= 512 || (dtype != 0 && dtype != 1) ||
      head_dim % (dtype == 1 ? 8 : 4) || !cluster_bwd_fits(dtype == 1 ? 1 : 2, head_dim, (lq + 63) / 64,
                                                            (lk + 63) / 64, plan)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    auto a = make_args<__nv_bfloat16>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
    a.cs = cs;
    a.dq_parts = dq_parts;
    a.dkv_parts = dkv_parts;
    return (int)run<1>(plan, q, k, v, dout, strides, head_dim, a, batch, s);
  }
  const int w = cs * half;  // the columns the slices cover: the parts' width in the scratch
  long long st[12];
  const cudaError_t err = split_operands(q, k, v, dout, strides, batch, heads, lq, lk, head_dim, w, q2, k2, v2, do2,
                                         st, s);
  if (err != cudaSuccess) return (int)err;
  auto a = make_args<float>(dq, dk, dv, lse, delta, strides, heads, lq, lk, lq_pad, head_dim, scale);
  a.cs = cs;
  a.dq_parts = dq_parts;
  a.dkv_parts = dkv_parts;
  return (int)run<2>(plan, q2, k2, v2, do2, st, 2 * w, a, batch, s);
}

// How many clusters of `cluster` (2, 4 or 8) blocks of the dq (dkv 0) or
// dk/dv (dkv 1) kernel of an instance (dtype, half, stages) the card holds
// at once (cudaOccupancyMaxActiveClusters: the plan splits the streamed
// dimension only where the doubled grid fits one wave), or a negative
// cudaError_t.
extern "C" int emox_flash_bwd_wide_clusters(int dtype, int half, int stages, int cluster, int dkv) {
  using namespace emox::bwd_wide_sm90;
  const ClusterBwd p{cluster, half, stages, 1, 1};
  if ((cluster != 2 && cluster != 4 && cluster != 8) || (dtype != 0 && dtype != 1) ||
      !cluster_bwd_fits(dtype == 1 ? 1 : 2, 0, 1, 1, p)) {
    return -(int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    return half == 320 ? held<320, 1, 1, B16>(cluster, dkv) : half == 192 ? held<192, 1, 2, B16>(cluster, dkv)
                                                                           : held<256, 1, 2, B16>(cluster, dkv);
  }
  return half == 192 ? held<192, 2, 1, float>(cluster, dkv) : held<128, 2, 2, float>(cluster, dkv);
}
