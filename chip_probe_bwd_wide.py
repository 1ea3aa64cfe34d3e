#!/usr/bin/env python3
"""The wide attention backward's plans side by side, on one H100.

    python3 chip_probe_bwd_wide.py

For each case (type, N, L, head dim; packed layout, one head, Lq = Lk),
the backward through flash_attention_nlc_bwd (split launches, padding and
delta included) on the plan wide_plan picks and on the alternatives the
plan weighs: the first cluster of BWD_CLUSTERS that covers the head dim
against the next one that does (in bf16 at d 640 a pair of 320-column
slices against four of 192), and the streamed dimension in one part
against two (the plan takes two where the dq and dk/dv kernels' clusters,
side by side, take fewer waves of what the card holds at once). Each plan
is checked against the plain version (the
bar of chip_smoke.py's check_flash_bwd) before it is timed; device_ms is
chip_smoke.device_ms (calls in one CUDA graph). Prints one JSON line per
case and plan, then the card's name and power limit and how many clusters
of 2, 4 and 8 blocks of each cluster instance it holds at once. Exits
non-zero without a card.
"""

from __future__ import annotations

import contextlib
import json
import sys

CASES = [("bfloat16", 1, 4096, 640), ("float32", 1, 1024, 640), ("float32", 1, 2048, 640),
         ("bfloat16", 1, 1024, 640), ("float32", 1, 512, 640), ("float32", 1, 256, 640),
         ("bfloat16", 1, 1000, 1024)]


@contextlib.contextmanager
def planned(attention, parts: int, clusters, held):
    """wide_plan with BWD_CLUSTERS[parts] = clusters and the card's held
    clusters replaced by held (None: the card's)."""
    saved, saved_held = attention.BWD_CLUSTERS[parts], attention._clusters_held
    attention.BWD_CLUSTERS[parts] = clusters
    if held is not None:
        attention._clusters_held = held
    try:
        yield
    finally:
        attention.BWD_CLUSTERS[parts], attention._clusters_held = saved, saved_held


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_bwd_wide: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from emox_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name, n, l, d in CASES:
        dtype = getattr(torch, dtype_name)
        parts = 2 if dtype == torch.float32 else 1
        default = attention.BWD_CLUSTERS[parts]
        fits = [c for c in default if c[0] * c[1] >= d]
        options = [("default", default, None), ("one part", default, lambda *a: 0)]
        if len(fits) > 1:
            options.append((f"next cluster {fits[1]}", tuple(fits[1:]), None))
        q, k, v, g = (torch.randn((n, l, d), generator=gen, device="cuda").to(dtype) for _ in range(4))
        o, lse = attention.attention_nlc_plain(q.float(), k.float(), v.float(), 1, d ** -0.5)
        o = o.to(dtype)
        want = attention.attention_nlc_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, g.float(), 1,
                                                 d ** -0.5)
        for label, clusters, held in options:
            with planned(attention, parts, clusters, held):
                plan = attention.card_wide_plan(n, 1, l, l, d, dtype, 0)
                run = lambda: attention.flash_attention_nlc_bwd(q, k, v, o, lse, g, 1)
                got = run()
                torch.cuda.synchronize()
                bar = (4 * cs.BF16_EPS if dtype == torch.bfloat16 else 2e-4)
                ok = all((a.float() - w).abs().max().item() <= bar * w.abs().max().item() for a, w in zip(got, want))
                ms = cs.device_ms(run, iters=10)
            print(json.dumps({"dtype": dtype_name, "n": n, "l": l, "head_dim": d, "plan": label,
                              "bwd_plan": list(attention.cluster_bwd_args(plan)), "within_bar": ok,
                              "device_ms": ms}), flush=True)
            if not ok:
                return 1
    print(cs.smi_line(), flush=True)
    fn = lambda *a: attention._clusters_held(0, *a)
    held = {f"{'bf16' if p == 1 else 'float32'} {h}x{s}": {c: fn(p, h, s, c) for c in (2, 4, 8)}
            for p, inst in ((1, ((320, 1), (192, 2), (256, 2))), (2, ((192, 1), (128, 2)))) for h, s in inst}
    print(json.dumps({"clusters_held": held}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
