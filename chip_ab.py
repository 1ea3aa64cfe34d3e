#!/usr/bin/env python3
"""A/B of the port's kernels between two checkouts, on one NVIDIA H100.

    python3 chip_ab.py OTHER_CHECKOUT [--out DIR] [--only PREFIX[,PREFIX...]]

Runs the same checks of chip_smoke.py (its `check_*` functions: the kernel
against its plain version, then CUDA-event times) from OTHER_CHECKOUT and
from this one, in turns (other, this, this, other), each turn a fresh
process that builds its own checkout's kernels from its sources, so both
are timed on the same card in one run. The checks: the fused LN + q/k/v
(fused_ln_qkv, K7, bf16) at the self-attention sites of the flagship's
256^2 and 512^2 requests; GroupNorm + SiLU (fused_group_norm, K8a) and
its statistics (group_norm_stats, K8b) at the UNet's and the VAE's slabs,
bf16; the head-dim-512 attention (the VAE's mid-attention): the bf16
backward at stage 5's 512^2 shape and at 384^2, and the float32 forward at
one and at 16 512^2 images; the float32 attention at head dims <= 256 (the
forward at the float32 step's strided SD-1.5 shape and packed flagship
shape, the backward at the float32 train step's shape) and the bf16
backward at head dims 160 (SD-1.5's level 2 under EMOX_ATTENTION_IMPL=pallas)
and 256 (the small preset's VAE mid-attention, and in float32); the float32
head-dim-512 backward at the float32 stage-5 step's N 1 x 1024; the wide
kernels at d 640 (bf16 at N 1 x 4096, float32 at N 1 x 1024), forward and
backward; the feed-forward
(fused_ln_geglu_ff, K2/K3, and fused_geglu_ff, K6) in float32 at the float32
step's level 0 and in bf16 at the flagship's level 0 and mid; and K7 in
float32 at M 4096, C 320 and M 2048, C 1280. `--only` keeps the checks
whose labels start with one of the prefixes (e.g. `--only ff_,geglu_ff_,ln_qkv_f32`
for the FF and float32 K7; `--only wide_,d512_,bwd_d` for the attention at
head dims 160 to 640: the wide forward and backward against the other
checkout, the other backward kernels' checksums). Each check's `ms` is its chip_smoke.py time
(CUDA events around the calls); `device_ms` is the same call's device time
without the host's cost of issuing it (calls captured in one CUDA graph,
timed by this checkout's code for both trees), and `checksum` a hash of the
call's output bits on inputs drawn from a fixed seed, the same in both
trees (a backward's o and lse come from the plain forward, so that its
checksum is the backward kernel's alone). Prints one JSON line per check and turn, then one summary line per
check: each checkout's faster turn, their ratio, and whether the two
checkouts gave the same bits. Exits non-zero where a check fails in either
checkout or where there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (label, chip_smoke function, positional arguments after the generator, keyword arguments)
GN_SLABS = ((32, 1024, 320), (32, 256, 640), (32, 64, 1280), (16, 65536, 128),  # 256^2: levels 0-2, VAE decode
            (32, 4096, 320), (32, 1024, 640), (32, 256, 1280), (4, 262144, 128))  # 512^2 levels 0-2; stage 5
CHECKS = [
    *((f"ln_qkv_{m}x{c}", "check_ln_qkv", (m, c), {}) for m, c in (
        (32768, 320), (8192, 640), (2048, 1280), (512, 1280),  # 256^2 under CFG: levels 0, 1, 2, mid
        (131072, 320), (32768, 640), (8192, 1280), (2048, 1280))),  # 512^2: levels 0, 1, 2, mid
    *((f"gn_{n}x{l}x{c}", "check_group_norm", (n, l, c), {}) for n, l, c in GN_SLABS),
    *((f"gn_stats_{n}x{l}x{c}", "check_group_norm_stats", (n, l, c), {}) for n, l, c in GN_SLABS),
    # head dim 512: the bf16 backward (stage 5 at 512^2, and 384^2) and the float32 forward (one image, 16)
    ("d512_bwd_4x4096", "check_flash_bwd", (4, 4096, 4096), {"c": 512, "heads": 1, "chunk": 1}),
    ("d512_bwd_2x2304", "check_flash_bwd", (2, 2304, 2304), {"c": 512, "heads": 1, "chunk": 1}),
    ("d512_fwd_f32_1x4096", "check_flash", (1, 4096, 4096), {"c": 512, "heads": 1, "dtype": "float32"}),
    ("d512_fwd_f32_16x4096", "check_flash", (16, 4096, 4096), {"c": 512, "heads": 1, "dtype": "float32", "chunk": 4}),
    # float32 at head dims <= 256 (the float32 step and train step), bf16 backward at 160 and 256
    ("f32_fwd_strided_32x1024x2048_d40", "check_flash_strided", (32, 1024, 2048),
     {"heads": 8, "d": 40, "dtype": "float32"}),
    ("f32_fwd_packed_2x1024x2048", "check_flash", (2, 1024, 2048), {"c": 320, "heads": 5, "dtype": "float32"}),
    ("f32_bwd_packed_2x1024x2048", "check_flash_bwd", (2, 1024, 2048), {"c": 320, "heads": 5, "dtype": "float32"}),
    ("bwd_d160_strided_16x256x512", "check_flash_strided_bwd", (16, 256, 512), {"heads": 8, "d": 160}),
    ("bwd_d256_packed_4x1024", "check_flash_bwd", (4, 1024, 1024), {"c": 256, "heads": 1}),
    ("bwd_d256_f32_packed_1x1024", "check_flash_bwd", (1, 1024, 1024), {"c": 256, "heads": 1, "dtype": "float32"}),
    # the float32 head-dim-512 backward (the float32 stage-5 step's shape) and
    # the wide kernels at d 640: bf16 at 512^2 (N 1 x 4096), float32 at the
    # width-640 VAE's stage-5 step (N 1 x 1024), forward and backward
    ("d512_bwd_f32_1x1024", "check_flash_bwd", (1, 1024, 1024), {"c": 512, "heads": 1, "dtype": "float32"}),
    ("wide_fwd_1x4096", "check_flash", (1, 4096, 4096), {"c": 640, "heads": 1}),
    ("wide_fwd_f32_1x1024", "check_flash", (1, 1024, 1024), {"c": 640, "heads": 1, "dtype": "float32"}),
    ("wide_bwd_1x4096", "check_flash_bwd", (1, 4096, 4096), {"c": 640, "heads": 1}),
    ("wide_bwd_f32_1x1024", "check_flash_bwd", (1, 1024, 1024), {"c": 640, "heads": 1, "dtype": "float32"}),
    # the FF: float32 at the float32 step's level 0, both functions; bf16 at
    # the flagship's level 0 (both functions) and mid (GEMM 2 split over F)
    ("ff_f32_4096x320", "check_ff", (4096, 320), {"dtype": "float32"}),
    ("geglu_ff_f32_4096x320", "check_geglu_ff", (4096, 320), {"dtype": "float32"}),
    ("ff_32768x320", "check_ff", (32768, 320), {}),
    ("ff_512x1280", "check_ff", (512, 1280), {}),
    ("geglu_ff_32768x320", "check_geglu_ff", (32768, 320), {}),
    # K7 in float32: the float32 step's level 0, and level 2's width
    ("ln_qkv_f32_4096x320", "check_ln_qkv", (4096, 320), {"dtype": "float32"}),
    ("ln_qkv_f32_2048x1280", "check_ln_qkv", (2048, 1280), {"dtype": "float32"}),
]

_TURN = """
import hashlib, json, sys, torch
import chip_smoke as cs
from emox_torch.ops import (flash_attention, flash_attention_bwd, flash_attention_nlc, flash_attention_nlc_bwd,
                             fused_geglu_ff, fused_group_norm, fused_ln_geglu_ff, fused_ln_qkv, group_norm_stats)
from emox_torch.ops.attention import attention_nlc_plain, attention_plain

def device_ms(fn, iters=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms

def checksum(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]

def call(fn, args, gen, kw):
    dt = kw.get("dtype", torch.bfloat16)
    rand = lambda *shape, scale=1.0, shift=0.0: (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dt)
    if fn in ("check_flash", "check_flash_bwd"):
        n, lq, lk = args
        c, heads, dt = kw["c"], kw["heads"], kw.get("dtype", torch.bfloat16)
        q, k, v = (torch.randn((n, l, c), generator=gen, device="cuda").to(dt) for l in (lq, lk, lk))
        if fn == "check_flash":
            return lambda: flash_attention_nlc(q, k, v, heads)
        # the backward's o and lse from the plain forward: the same inputs in both trees
        o, lse = attention_nlc_plain(q, k, v, heads, (c // heads) ** -0.5)
        dout = torch.randn((n, lq, c), generator=gen, device="cuda").to(dt)
        return lambda: flash_attention_nlc_bwd(q, k, v, o, lse, dout, heads)
    if fn in ("check_flash_strided", "check_flash_strided_bwd"):
        n, lq, lk = args
        heads, d, dt = kw["heads"], kw["d"], kw.get("dtype", torch.bfloat16)
        split = lambda l: torch.randn((n, l, heads * d), generator=gen, device="cuda").to(dt).view(
            n, l, heads, d).transpose(1, 2)  # head-split views of packed tokens
        q, k, v = split(lq), split(lk), split(lk)
        if fn == "check_flash_strided":
            return lambda: flash_attention(q, k, v)
        o, lse = attention_plain(q, k, v, d ** -0.5)
        dout = split(lq)
        return lambda: flash_attention_bwd(q, k, v, o, lse, dout)
    if fn in ("check_ff", "check_geglu_ff"):
        m, c = args
        f = 4 * c
        x, w1, b1 = rand(m, c), rand(2 * f, c, scale=c ** -0.5), rand(2 * f, scale=0.1)
        w2, b2 = rand(c, f, scale=f ** -0.5), rand(c, scale=0.1)
        if fn == "check_geglu_ff":
            return lambda: fused_geglu_ff(x, w1, b1, w2, b2)
        ln_w, ln_b = rand(c, scale=0.1, shift=1.0), rand(c, scale=0.1)
        return lambda: fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2)
    if fn == "check_ln_qkv":
        m, c = args
        xs = (rand(m, c), rand(c, scale=0.1, shift=1.0), rand(c, scale=0.1),
              *(rand(c, c, scale=c ** -0.5) for _ in range(3)))
        return lambda: fused_ln_qkv(*xs)
    n, l, c = args
    x = rand(n, l, c, scale=3.0, shift=1.0)
    if fn == "check_group_norm_stats":
        return lambda: group_norm_stats(x)
    gamma, beta = rand(c, scale=0.1, shift=1.0), rand(c, scale=0.1)
    return lambda: fused_group_norm(x, gamma, beta, 32, silu=True)

checks = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(1234)
for label, fn, args, kw in checks:
    if "dtype" in kw:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
    res = getattr(cs, fn)(gen, *args, **kw)
    run = call(fn, args, torch.Generator(device="cuda").manual_seed(4321), kw)
    print("AB " + json.dumps({"label": label, "kernel": res["kernel"], "ms": res["ms"],
                              "device_ms": device_ms(run, iters=10 if "flash" in fn else 20),
                              "checksum": checksum(run()), "bound_ms": res["bound_ms"],
                              "max_abs_err": res["max_abs_err"]}), flush=True)
    del run
    torch.cuda.empty_cache()
"""


def turn(tree: str, name: str, checks: list) -> dict:
    """One turn: every check in a fresh process run from `tree`."""
    proc = subprocess.run([sys.executable, "-c", _TURN, json.dumps(checks)], cwd=tree, capture_output=True,
                          text=True)
    results = {}
    for line in proc.stdout.splitlines():
        if line.startswith("AB "):
            res = dict(json.loads(line[3:]), tree=name)
            results[res["label"]] = res
            print(json.dumps(res), flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"chip_ab: the {name} checkout's turn failed (exit {proc.returncode})")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout (its root, holding its chip_smoke.py)")
    ap.add_argument("--out", default="", help="directory for the summary (ab.json)")
    ap.add_argument("--only", default="", help="comma-separated label prefixes of the checks to run (default: all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; the A/B runs on the card only", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "device", "nvidia_smi": card, "other": other, "this": ROOT}), flush=True)
    prefixes = tuple(p for p in args.only.split(",") if p)
    checks = [c for c in CHECKS if not prefixes or c[0].startswith(prefixes)]
    turns = [turn(other, "other", checks), turn(ROOT, "this", checks), turn(ROOT, "this", checks),
             turn(other, "other", checks)]
    summary = []
    for label, *_ in checks:
        best = {(name, key): min(t[label][key] for t in turns if t[label]["tree"] == name)
                for name in ("other", "this") for key in ("ms", "device_ms")}
        summary.append({"label": label, "other_ms": best["other", "ms"], "this_ms": best["this", "ms"],
                        "other_device_ms": best["other", "device_ms"], "this_device_ms": best["this", "device_ms"],
                        "other_kernel": turns[0][label]["kernel"], "this_kernel": turns[1][label]["kernel"],
                        "speedup": best["other", "ms"] / best["this", "ms"],
                        "device_speedup": best["other", "device_ms"] / best["this", "device_ms"],
                        "bound_ms": turns[1][label]["bound_ms"],
                        "checksums": [t[label]["checksum"] for t in turns],
                        "same_bits": len({t[label]["checksum"] for t in turns}) == 1})
        print(json.dumps({"summary": summary[-1]}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ab.json"), "w") as f:
            json.dump({"card": card, "turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
