"""The traced window: torch.profiler around it, and its reduction to what the per-layer
metrics read.

`summarize` is a frozen copy of chip_smoke.py's `_profile_summary` (the device's busy time as
the union of device-event intervals from the profiler's raw kineto events, device time by
kernel name), extended by the device operation count, the busy seconds inside the window and
the longest idle gaps, each named by the innermost host event open when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import time
from typing import Dict, List, Optional

LOOKBACK = 4096  # host events searched before a gap for the innermost one open across it


class Window:
    """Times the measured window; with trace=True, profiles it (CPU and CUDA activity)."""

    def __init__(self, trace: bool, sync):
        self.trace, self.sync = trace, sync
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.summary: Dict = {}

    def __enter__(self):
        gc.collect()  # the set-up's garbage, before the window
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def reduce(self) -> Dict:
        """The trace's summary (empty without a trace or with no device events)."""
        if self.prof is not None and not self.summary:
            self.summary = summarize(self.prof.profiler.kineto_results.events())
        return self.summary


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host range in the trace (a no-op when not tracing)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def summarize(events) -> Dict:
    from torch.autograd import DeviceType

    events = [e for e in events if not e.is_hidden_event()]
    device = [e for e in events if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if not device:
        return {}
    intervals: List[List[int]] = []
    for e in sorted(device, key=lambda e: e.start_ns()):
        start, end = e.start_ns(), e.end_ns()
        if intervals and start <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], end)
        else:
            intervals.append([start, end])
    busy = sum(b - a for a, b in intervals)
    by_name: Dict[str, List[float]] = {}
    for e in device:
        rec = by_name.setdefault(e.name(), [0, 0])
        rec[0] += 1
        rec[1] += e.end_ns() - e.start_ns()
    host = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in events if e.device_type() == DeviceType.CPU),
                  key=lambda r: r[0])
    starts = [h[0] for h in host]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(intervals, intervals[1:])), reverse=True)[:10]
    return {
        "device_ops": len(device),
        "busy_s": busy / 1e9,
        "span_s": (intervals[-1][1] - intervals[0][0]) / 1e9,
        "by_name": {n: {"count": c, "s": ns / 1e9} for n, (c, ns) in by_name.items()},
        "idle_gaps": [[_open_at(host, starts, at), ns / 1e9] for ns, at in gaps],
    }


def _open_at(host, starts, at: int) -> str:
    """The innermost host event open at `at` (the latest started that has not ended)."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(-1, i - LOOKBACK), -1):
        if host[j][1] > at:
            return host[j][2]
    return "(no host event open)"


def family_seconds(summary: Dict, include, exclude=()) -> Optional[float]:
    """Device seconds of the kernels whose names hold one of `include` and none of `exclude`
    (None when no such kernel ran)."""
    hits = [rec["s"] for name, rec in summary.get("by_name", {}).items()
            if any(k in name for k in include) and not any(k in name for k in exclude)]
    return sum(hits) if hits else None


def breakdown(summary: Dict) -> Dict:
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1]["s"])[:10]
    return {"device_ops": [[name[:200], rec["s"]] for name, rec in top],
            "idle_gaps": summary["idle_gaps"]}
