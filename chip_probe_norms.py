#!/usr/bin/env python3
"""Where the time of the fused-norm kernels goes, on one NVIDIA H100.

    python3 chip_probe_norms.py

Three probes behind the designs of K7 (emox_torch/csrc/ln_qkv_sm90.cu) and
K8 (emox_torch/csrc/group_norm.cu), each printing JSON lines:

  * trace: K7's phases inside the kernel, at the four 256^2 self-attention
    shapes. A copy of ln_qkv_sm90.cu with %globaltimer stamps (thread 0 of
    each block: start, LN done, each column tile's products done, its
    stores done) is built next to the build directory and run three times;
    the medians over blocks of the last run are printed.
  * regimes: K8a (GroupNorm + SiLU, bf16) at the UNet's and the VAE's slabs
    launched through its C entry with clusters of 4, 7, 8 and 16 blocks
    (where the slab fits) and with two launches, its device time (20 calls in one CUDA graph) and error
    against group_norm_plain; K8b's device time at cluster sizes 4, 8, 16
    and two launches.
  * held: how many K8a clusters the card holds at once, by cluster size
    (emox_group_norm_clusters: cudaOccupancyMaxActiveClusters), for the
    same slabs; gn_plan takes the smallest cluster that holds all samples.

Exits non-zero where there is no card or a probe fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

GN_SLABS = ((32, 1024, 320), (32, 256, 640), (32, 64, 1280), (32, 1024, 640), (32, 256, 1280),
            (32, 4096, 320), (16, 1024, 512), (16, 65536, 128), (4, 262144, 128))
K7_SHAPES = ((32768, 320), (8192, 640), (2048, 1280), (512, 1280))

# (anchor in ln_qkv_sm90.cu, text put in its place): the trace's stamps
_STAMP = '__device__ __forceinline__ unsigned long long stamp() { unsigned long long t; ' \
         'asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t; }\n'
_TRACE_PATCHES = (
    ("  float eps;\n};", "  float eps;\n  unsigned long long* trace;\n};\n" + _STAMP),
    ("  __syncthreads();\n  const int wg = threadIdx.x / 128;",
     "  __syncthreads();\n  unsigned long long* tr = a.trace + (blockIdx.y * gridDim.x + blockIdx.x) * 64;\n"
     "  if (threadIdx.x == 0) tr[0] = stamp();\n  const int wg = threadIdx.x / 128;"),
    ("  asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");                // every row normalised\n",
     "  asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");\n  if (threadIdx.x == 0) tr[1] = stamp();\n"),
    ("  for (int t = t0; t < t1; ++t) {\n    for (int k = 0; k < a.chunks; ++k, ++j) {",
     "  for (int t = t0; t < t1; ++t) {\n    if (threadIdx.x == 0) tr[2 + 2 * (t - t0)] = stamp();\n"
     "    for (int k = 0; k < a.chunks; ++k, ++j) {"),
    ("    wgmma_wait0();\n#pragma unroll\n    for (int ms = 0; ms < S::kMSub; ++ms) fence_regs",
     "    wgmma_wait0();\n    if (threadIdx.x == 0) tr[3 + 2 * (t - t0)] = stamp();\n"
     "#pragma unroll\n    for (int ms = 0; ms < S::kMSub; ++ms) fence_regs"),
    ("\n}\n\ntemplate <int BM, int BN, int STAGES, int CHUNKS>\nstatic cudaError_t launch(",
     "\n  if (threadIdx.x == 0) tr[63] = stamp();\n}\n\n"
     "template <int BM, int BN, int STAGES, int CHUNKS>\nstatic cudaError_t launch("),
    ("int per,\n                                float eps, void* stream) {",
     "int per,\n                                float eps, void* stream, void* trace) {"),
    ("static_cast<T*>(v), m, c, inner, chunks, 0, 0, per, eps};",
     "static_cast<T*>(v), m, c, inner, chunks, 0, 0, per, eps, static_cast<unsigned long long*>(trace)};"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_trace(build) -> ctypes.CDLL:
    src = (build.CSRC / "ln_qkv_sm90.cu").read_text()
    for old, new in _TRACE_PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"chip_probe_norms: the trace's anchor is gone from ln_qkv_sm90.cu: {old!r}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ln_qkv_trace.cu").write_text(src)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out / "ln_qkv_trace.so"),
           str(out / "ln_qkv_trace.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("chip_probe_norms: the trace build failed:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out / "ln_qkv_trace.so"))
    fn = lib.emox_ln_qkv_sm90
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i] * 4 + [f, p, p]
    fn.restype = ctypes.c_int
    return fn


def probe_trace(cs, build, gen) -> None:
    import numpy as np
    import torch
    from emox_torch.ops.ln_qkv import ln_qkv_plain, ln_qkv_sm90_plan

    fn = build_trace(build)
    bf = torch.bfloat16
    for m, c in K7_SHAPES:
        x = cs._rand(gen, m, c, dtype=bf)
        w, b = cs._rand(gen, c, scale=0.1, shift=1.0, dtype=bf), cs._rand(gen, c, scale=0.1, dtype=bf)
        weights = [cs._rand(gen, c, c, scale=c ** -0.5, dtype=bf) for _ in range(3)]
        outs = [torch.empty(m, c, device="cuda", dtype=bf) for _ in range(3)]
        plan = ln_qkv_sm90_plan(m, c, c, torch.cuda.get_device_properties(0).multi_processor_count)
        trace = torch.zeros(plan["blocks"] * 64, dtype=torch.int64, device="cuda")
        for _ in range(3):
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in weights),
                     *(o.data_ptr() for o in outs), m, c, c, plan["per"], 1e-5,
                     torch.cuda.current_stream().cuda_stream, trace.data_ptr())
            build.check(err, "ln_qkv_trace")
        torch.cuda.synchronize()
        max_err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, ln_qkv_plain(x, w, b, *weights)))
        tr = trace.view(plan["blocks"], 64).cpu().numpy().astype(np.float64) / 1e3  # microseconds
        per = plan["per"]
        ends = [tr[:, 2 + 2 * (i + 1)] if i + 1 < per else tr[:, 63] for i in range(per)]
        med = lambda v: round(float(np.median(v)), 3)
        emit({"probe": "trace", "kernel": "ln_qkv_sm90", "m": m, "c": c, "plan": plan, "max_abs_err": max_err,
              "span_us": med(tr[:, 63].max() - tr[:, 0].min()),
              "block_starts_us": [med(np.quantile(tr[:, 0] - tr[:, 0].min(), q)) for q in (0.5, 1.0)],
              "x_and_ln_us": med(tr[:, 1] - tr[:, 0]),
              "products_us_per_tile": med(np.stack([tr[:, 3 + 2 * i] - tr[:, 2 + 2 * i] for i in range(per)])),
              "stores_us_per_tile": med(np.stack([ends[i] - tr[:, 3 + 2 * i] for i in range(per)])),
              "block_us": med(tr[:, 63] - tr[:, 0])})


def probe_regimes(cs, build, gen) -> None:
    import torch
    from emox_torch.ops.groupnorm import gn_smem, group_norm_plain, stats_chunks

    bf = torch.bfloat16
    stream = lambda: torch.cuda.current_stream().cuda_stream
    held = build.kernel("group_norm", "emox_group_norm_clusters")
    for n, l, c in GN_SLABS:
        x = cs._rand(gen, n, l, c, scale=3.0, shift=1.0, dtype=bf)
        gamma, beta = cs._rand(gen, c, scale=0.1, shift=1.0, dtype=bf), cs._rand(gen, c, scale=0.1, dtype=bf)
        want = group_norm_plain(x, gamma, beta, 32, silu=True).float()
        chunks = stats_chunks(n, l, c, 2)
        part = torch.empty((2, n, chunks, c), device="cuda", dtype=torch.float32)
        sums = torch.empty((2, n, c), device="cuda", dtype=torch.float32)

        def k8a(k):
            y = torch.empty_like(x)
            err = build.kernel("group_norm", "emox_group_norm")(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), part.data_ptr(), n, l, c, 32, k,
                chunks, 1e-5, 1, 1, stream())
            build.check(err, "group_norm")
            return y

        def k8b(k):
            err = build.kernel("group_norm", "emox_group_norm_stats")(
                x.data_ptr(), part.data_ptr(), sums.data_ptr(), n, l, c, k, chunks, 1, stream())
            build.check(err, "group_norm_stats")

        regimes, stats = {}, {}
        sizes = [k for k in range(1, 17) if gn_smem(-(-l // k), c, 2) <= 232448 and -(-l // k) * (k - 1) < l]
        for k in [*(k for k in (4, 7, 8, 16) if k in sizes), 0]:
            err = (k8a(k).float() - want).abs().max().item()
            regimes["two_launch" if k == 0 else f"cluster_{k}"] = {"device_ms": cs.device_ms(lambda: k8a(k)),
                                                                    "max_abs_err": err}
        for k in (4, 8, 16, 0):
            if k == 0 or -(-l // k) * (k - 1) < l:
                stats["two_launch" if k == 0 else f"cluster_{k}"] = cs.device_ms(lambda: k8b(k))
        emit({"probe": "regimes", "n": n, "l": l, "c": c, "k8a": regimes, "k8b_device_ms": stats,
              "library_device_ms": cs.device_ms(lambda: torch.nn.functional.silu(
                  torch.nn.functional.group_norm(x.transpose(1, 2), 32, gamma, beta)))})
        emit({"probe": "held", "n": n, "l": l, "c": c,
              "clusters_held": {k: held(k, -(-l // k), c, 32, 1) for k in sizes}})


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_probe_norms: no CUDA device; the probes run on the card only", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from emox_torch.ops import build

    emit({"phase": "device", "nvidia_smi": cs.smi_line(), "torch": torch.__version__})
    build.build(["ln_qkv_sm90", "group_norm"])
    gen = torch.Generator(device="cuda").manual_seed(1234)
    probe_trace(cs, build, gen)
    probe_regimes(cs, build, gen)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
