#!/usr/bin/env python3
"""The bf16 feed-forward's kernels one by one, on one NVIDIA H100.

    python3 chip_probe_ff.py [OTHER_CHECKOUT] [--serve]

At the flagship's FF level 0 under CFG at 256^2 (M 32768, C 320, F 1280,
bf16), each FF function (fused_ln_geglu_ff: K2/K3; fused_geglu_ff: K6) runs
50 times under torch.profiler, and the device time per call of each kernel
it launches (ff_sm90.cu's LN pass, GEMM 1, GEMM 2) is printed as one JSON
line per function. With --serve each turn then serves the flagship's 256^2
request end to end (chip_smoke.phase_serve: three requests, every switch
unset, no profile) and prints its s/request, to tell the kernels' share of
a change from the host's. With OTHER_CHECKOUT the other checkout is timed
too, in turns (other, this, this, other), each turn a fresh process that
builds its own checkout's kernels, so both are timed on one card. Exits
non-zero where there is no card or a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
M, C, F = 32768, 320, 1280
CALLS = 50


def turn(tree: str, serve: bool) -> int:
    """One turn in the checkout at the working directory."""
    sys.path.insert(0, os.getcwd())  # that checkout's emox_torch, not this one's
    import torch
    from emox_torch.ops import build
    from emox_torch.ops.ff import fused_geglu_ff, fused_ln_geglu_ff

    if not torch.cuda.is_available():
        print("chip_probe_ff: no CUDA device", file=sys.stderr)
        return 2
    build.build(["ff_sm90"])
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale + shift).to(torch.bfloat16)

    x, ln_w, ln_b = rand(M, C), rand(C, scale=0.1, shift=1.0), rand(C, scale=0.1)
    w1, b1, w2, b2 = rand(2 * F, C, scale=C ** -0.5), rand(2 * F, scale=0.1), rand(C, F, scale=F ** -0.5), rand(C, scale=0.1)
    for function, run in (("ln_geglu_ff", lambda: fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2)),
                          ("geglu_ff", lambda: fused_geglu_ff(x, w1, b1, w2, b2))):
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                run()
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if total and e.count:
                us[e.key[:80]] = total / CALLS
        print(json.dumps({"tree": tree, "function": function, "m": M, "c": C, "f": F, "us_per_call": us}), flush=True)
    if serve:
        import chip_smoke

        chip_smoke.phase_build("")
        with chip_smoke.switches():
            res = chip_smoke.phase_serve("", requests=3, profile=False)
        print(json.dumps({"tree": tree, "phase": "serve", "s_per_request": res["s_per_request"],
                          "ms_per_step": res["ms_per_step"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", default="", help="another checkout (its root) to time in turns")
    ap.add_argument("--serve", action="store_true", help="also serve the flagship's 256^2 request in each turn")
    ap.add_argument("--turn", default="", help=argparse.SUPPRESS)  # one turn, in the working directory
    args = ap.parse_args(argv)
    if args.turn:
        return turn(args.turn, args.serve)
    trees = [("this", ROOT)]
    if args.other:
        other = os.path.abspath(args.other)
        trees = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    rc = 0
    for label, root in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", label] + (["--serve"] if args.serve else [])
        rc |= subprocess.run(cmd, cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
