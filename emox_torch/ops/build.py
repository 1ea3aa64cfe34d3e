"""Build and load the port's CUDA kernels.

Each source in emox_torch/csrc/ is compiled by `nvcc` into a shared
library with a plain C interface and loaded with ctypes (no PyTorch
headers, so a build takes seconds rather than minutes). Builds happen at
first use, into build/emox_torch/ at the root of the checkout, one `nvcc`
per source, all started together. A library's file name carries a hash of
the sources and flags, so an edited kernel is never served from a stale
build. Nothing here runs when the module is imported: the CPU tests import
every module of the port on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emox_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)  # an array of element strides
# library -> {C function: argtypes}; the first function launches the kernel
KERNELS = {
    "flash_fwd_sm90": {"emox_flash_fwd_sm90": [_P] * 5 + [_LL] + [_I] * 5 + [_F, _P],
                       "emox_flash_fwd_f32_sm90": [_P] * 5 + [_LL] + [_I] * 5 + [_F] + [_P] * 4},
    "flash_bwd_sm90": {"emox_flash_bwd_sm90": [_P] * 9 + [_LL] + [_I] * 6 + [_F, _P],
                       "emox_flash_bwd_f32_sm90": [_P] * 9 + [_LL] + [_I] * 6 + [_F] + [_P] * 5},
    "flash_bwd_d512_sm90": {"emox_flash_bwd_d512_sm90": [_P] * 9 + [_LL] + [_I] * 5 + [_F, _P],
                            "emox_flash_bwd_d256_sm90": [_P] * 9 + [_LL] + [_I] * 6 + [_F, _I] + [_P] * 5,
                            "emox_flash_bwd_d512_f32": [_P] * 9 + [_LL] + [_I] * 5 + [_F] + [_P] * 5},
    "flash_fwd_wide": {"emox_flash_fwd_wide": [_P] * 5 + [_LL] + [_I] * 5 + [_F] + [_I] * 7 + [_P] * 4},
    "flash_attn_wide": {"emox_flash_bwd_wide": [_P] * 9 + [_LL] + [_I] * 6 + [_F, _I] + [_P] * 5},
    "flash_bwd_wide_sm90": {"emox_flash_bwd_wide_sm90": [_P] * 9 + [_LL] + [_I] * 6 + [_F, _I] + [_I] * 5 + [_P] * 5,
                            "emox_flash_bwd_wide_clusters": [_I] * 5},
    "flash_fwd_d512_f32": {"emox_flash_fwd_d512_f32": [_P] * 5 + [_LL] + [_I] * 4 + [_F] + [_P] * 4},
    "ff_sm90": {"emox_ff_sm90": [_P] * 11 + [_I] * 4 + [_F, _P],
                "emox_ff_f32_sm90": [_P] * 13 + [_I] * 4 + [_F, _P]},
    "group_norm": {"emox_group_norm": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
                   "emox_group_norm_stats": [_P] * 3 + [_I] * 6 + [_P],
                   "emox_group_norm_clusters": [_I] * 5},
    "ln_qkv_sm90": {"emox_ln_qkv_sm90": [_P] * 9 + [_I] * 4 + [_F, _P],
                    "emox_ln_qkv_f32_sm90": [_P] * 11 + [_I] * 3 + [_F, _P]},
}

_loaded: Dict[str, Dict[str, ctypes._CFuncPtr]] = {}
# per library: seconds the build took (0.0 when found built) and the
# compiler's report (ptxas registers / shared memory / spills)
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds nvcc as PyTorch does

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: List[str] = None) -> Dict[str, dict]:
    """Compile (in parallel) and load the named kernel libraries, all by
    default. Returns build_info. Raises with the compiler's output when a
    build fails."""
    names = list(KERNELS) if names is None else names
    todo = [n for n in names if n not in _loaded]
    if not todo:
        return build_info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        target = _target(name)
        if target.exists():
            build_info[name] = {"seconds": 0.0, "ptxas": "", "path": str(target)}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target)
        build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": out, "path": str(target)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(build_info[name]["path"])
        _loaded[name] = {}
        for fn_name, argtypes in KERNELS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name][fn_name] = fn
    return build_info


def kernel(name: str, fn_name: str = ""):
    """A C entry point of a kernel library, built on first use: `fn_name`,
    or by default the one that launches the kernel."""
    if name not in _loaded:
        build([name])
    fns = _loaded[name]
    return fns[fn_name] if fn_name else next(iter(fns.values()))


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (refused launches never run,
    and a later synchronize would not report them)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
