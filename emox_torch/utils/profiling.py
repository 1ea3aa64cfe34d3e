"""Profiling and tracing hooks (counterpart of emox/utils/profiling.py).

torch.profiler traces around hot loops, written as Chrome traces that
TensorBoard's profiler plugin and chrome://tracing read; named regions; and
a step timer that reports steps/s and the card's memory:

    from emox_torch.utils import profiling
    with profiling.trace("/tmp/emox_trace"):
        for _ in range(3):
            trainer.train_step(batch, gen)
    # tensorboard --logdir /tmp/emox_trace

The trace records the host's activity and, where a CUDA card is present,
the card's kernels and copies.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start a trace of the host and, with a CUDA card, of the card; stop_trace
    writes it under log_dir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Stop a trace from start_trace (after the card's queued work) and write
    it as `<host>_<pid>.<ms>.pt.trace.json` in its log_dir."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block into log_dir."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof)


def annotate(name: str):
    """A named region, visible in the trace viewer."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Blocking wall-clock step timer with warm-up discard: the card's queued
    work is waited for before the clock is read at both ends of a step."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        self._count = 0

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    @property
    def mean_s(self) -> float:
        return sum(self._times) / max(1, len(self._times))

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.mean_s if self._times else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mean_ms": self.mean_s * 1e3, "steps_per_sec": self.steps_per_sec, "n": float(len(self._times))}


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """The CUDA card's allocator statistics (torch.cuda.memory_stats: bytes and
    counts under CUDA's keys, such as "allocated_bytes.all.peak"); empty
    without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: float(v) for k, v in stats.items() if isinstance(v, (int, float))}


def save_profile_summary(path: str, timer: StepTimer, extra: Optional[Dict] = None) -> None:
    """Append one JSON line: the time, the timer's summary, the card's memory
    statistics and `extra`."""
    rec = {"time": time.time(), **timer.summary(), "memory": device_memory_stats()}
    if extra:
        rec.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
