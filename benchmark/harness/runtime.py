"""What every run shares: the cell's files found by name, the process's environment, its age,
the device, the numbers compared and the result line."""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = BENCH.parent  # the checkout
CACHE = BENCH / ".cache"  # the program's build and kernel caches, at fixed paths in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "emox")  # top-level module names no run may load


def set_environment() -> None:
    """Clear every EMOX_* switch (each cell runs the port's defaults), keep every build and
    kernel cache inside the checkout. Call before torch is imported."""
    for key in [k for k in os.environ if k.startswith("EMOX_")]:
        del os.environ[key]
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"


def process_age() -> float:
    """Seconds since this process started (its start time in /proc, against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file: sections as run, source, precision
    traffic: dict  # the traffic file: its driver and that driver's parameters
    limits: dict  # the limit of each number compared
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, bench: Optional[dict] = None, root: Path = BENCH) -> Cell:
    """The cell `workload` of BENCHMARK.json (or of `bench`), with its configuration,
    traffic and limits read by name from `root`."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    read = lambda sub, name: json.loads((root / sub / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    # a per-layer metric in the cells it lists, or else in every cell that reports what it moves
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload] if m["moves"] in reported
                                                                    else [])]
    return Cell(workload, w["chips"], w["config"], read("configs", w["config"]), read("traffic", w["traffic"]),
                read("limits", workload), e2e, per_layer)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


@dataclass
class Checks:
    """The numbers compared, each with its limit; `correct` when every one is within."""

    items: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                                        for v in self.items.values())

    def lines(self) -> List[str]:
        return [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in self.items.items()]


def rel_l2(got, want) -> float:
    """|got - want| / |want| over whole tensors, in float64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


def rel_max(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
