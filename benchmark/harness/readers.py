"""What the per-layer readers (benchmark/metrics/<name>.py) share."""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

from benchmark.harness.trace import family_seconds
from benchmark.work.sites import PEAK_FLOPS


def roofline(obs: Dict, kernel: str, include: Sequence[str], exclude: Sequence[str], per: str) -> Optional[float]:
    """100 x the least time of the window's launches of `kernel` (its sites' work at the
    roofline, times the requests or steps completed) over the device time of the kernels
    named by `include` / `exclude`. None where nothing ran, or where the launch counter
    disagrees with the site list (said on standard error): mismatched work is not divided
    by time."""
    want = obs["expected_launches"].get(kernel, 0)
    got = obs["launches"].get(kernel, 0)
    if not want or not obs.get("trace"):
        return None
    if got != want:
        print(f"{kernel}: {got} launches in the window, the site list gives {want}; its roofline is left out",
              file=sys.stderr)
        return None
    seconds = family_seconds(obs["trace"], include, exclude)
    if not seconds:
        return None
    least = sum(s.least_s() * s.count for s in obs["sites"] if s.kernel == kernel) * obs[per]
    return 100.0 * least / seconds


def idle_share(obs: Dict) -> Optional[float]:
    trace = obs.get("trace")
    return 100.0 * (1.0 - trace["busy_s"] / obs["window_s"]) if trace else None


def ops_per(obs: Dict, per: str) -> Optional[float]:
    trace = obs.get("trace")
    return trace["device_ops"] / obs[per] if trace and obs[per] else None


def peak_gb(obs: Dict) -> Optional[float]:
    return obs["peak_bytes"] / 1e9 if obs["peak_bytes"] else None


def mfu(obs: Dict, flops_key: str, per: str) -> Optional[float]:
    flops = obs.get(flops_key)
    return 100.0 * flops * obs[per] / obs["window_s"] / PEAK_FLOPS if flops and obs[per] else None
