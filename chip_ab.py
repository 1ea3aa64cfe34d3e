#!/usr/bin/env python3
"""A/B of the port's kernels between two checkouts, on one NVIDIA H100.

    python3 chip_ab.py OTHER_CHECKOUT [--out DIR]

Runs the same checks of chip_smoke.py (its `check_*` functions: the kernel
against its plain version, then CUDA-event times) from OTHER_CHECKOUT and
from this one, in turns (other, this, this, other), each turn a fresh
process that builds its own checkout's kernels from its sources, so both
are timed on the same card in one run. The checks: the fused LN + q/k/v
(fused_ln_qkv, K7, bf16) at the self-attention sites of the flagship's
256^2 and 512^2 requests, and GroupNorm + SiLU (fused_group_norm, K8a) and
its statistics (group_norm_stats, K8b) at the UNet's and the VAE's slabs,
bf16. Each check's `ms` is its chip_smoke.py time (CUDA events around 20
calls); `device_ms` is the same call's device time without the host's
cost of issuing it (20 calls captured in one CUDA graph, timed by this
checkout's code for both trees). Prints one JSON line per check and turn,
then one summary line per check: each checkout's faster turn and their
ratio. Exits non-zero where a check fails in either checkout or where
there is no card.
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
]

_TURN = """
import json, sys, torch
import chip_smoke as cs
from emox_torch.ops import fused_group_norm, fused_ln_qkv, group_norm_stats

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

def call(fn, args, gen):
    bf = torch.bfloat16
    rand = lambda *shape, scale=1.0, shift=0.0: (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(bf)
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
    res = getattr(cs, fn)(gen, *args, **kw)
    print("AB " + json.dumps({"label": label, "kernel": res["kernel"], "ms": res["ms"],
                              "device_ms": device_ms(call(fn, args, gen)),
                              "bound_ms": res["bound_ms"], "max_abs_err": res["max_abs_err"]}), flush=True)
"""


def turn(tree: str, name: str) -> dict:
    """One turn: every check in a fresh process run from `tree`."""
    proc = subprocess.run([sys.executable, "-c", _TURN, json.dumps(CHECKS)], cwd=tree, capture_output=True,
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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; the A/B runs on the card only", file=sys.stderr)
        return 2
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "device", "nvidia_smi": card, "other": other, "this": ROOT}), flush=True)
    turns = [turn(other, "other"), turn(ROOT, "this"), turn(ROOT, "this"), turn(other, "other")]
    summary = []
    for label, *_ in CHECKS:
        best = {(name, key): min(t[label][key] for t in turns if t[label]["tree"] == name)
                for name in ("other", "this") for key in ("ms", "device_ms")}
        summary.append({"label": label, "other_ms": best["other", "ms"], "this_ms": best["this", "ms"],
                        "other_device_ms": best["other", "device_ms"], "this_device_ms": best["this", "device_ms"],
                        "other_kernel": turns[0][label]["kernel"], "this_kernel": turns[1][label]["kernel"],
                        "speedup": best["other", "ms"] / best["this", "ms"],
                        "device_speedup": best["other", "device_ms"] / best["this", "device_ms"],
                        "bound_ms": turns[1][label]["bound_ms"]})
        print(json.dumps({"summary": summary[-1]}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ab.json"), "w") as f:
            json.dump({"card": card, "turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
