#!/usr/bin/env python3
"""A/B of the port's kernels between two checkouts, on one NVIDIA H100.

    python3 chip_ab.py OTHER_CHECKOUT [--out DIR]

Runs the same checks of chip_smoke.py (its `check_*` functions: the kernel
against its plain version, then CUDA-event times) from OTHER_CHECKOUT and
from this one, in turns (other, this, this, other), each turn a fresh
process that builds its own checkout's kernels from its sources, so both
are timed on the same card in one run. The checks: the transformer FF
sub-layer (fused_ln_geglu_ff, bf16) at the flagship's 256^2 and 512^2
shapes and the attention forward at head dim 512 (the VAE's mid-attention,
bf16). Prints one JSON line per check and turn, then one summary line per
check: each checkout's faster turn and their ratio. Exits non-zero where a
check fails in either checkout or where there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (label, chip_smoke function, positional arguments after the generator, keyword arguments)
CHECKS = [
    *((f"ff_{m}x{c}", "check_ff", (m, c), {}) for m, c in (
        (32768, 320), (8192, 640), (2048, 1280), (512, 1280),  # 256^2 under CFG: levels 0, 1, 2, mid
        (131072, 320), (32768, 640), (8192, 1280), (2048, 1280))),  # 512^2: levels 0, 1, 2, mid
    ("flash_d512", "check_flash", (16, 4096, 4096), {"c": 512, "heads": 1}),
]

_TURN = """
import json, sys, torch
import chip_smoke as cs
checks = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(1234)
for label, fn, args, kw in checks:
    res = getattr(cs, fn)(gen, *args, **kw)
    print("AB " + json.dumps({"label": label, "kernel": res["kernel"], "ms": res["ms"],
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
        best = {name: min(t[label]["ms"] for t in turns if t[label]["tree"] == name) for name in ("other", "this")}
        summary.append({"label": label, "other_ms": best["other"], "this_ms": best["this"],
                        "other_kernel": turns[0][label]["kernel"], "this_kernel": turns[1][label]["kernel"],
                        "speedup": best["other"] / best["this"], "bound_ms": turns[1][label]["bound_ms"]})
        print(json.dumps({"summary": summary[-1]}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ab.json"), "w") as f:
            json.dump({"card": card, "turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
