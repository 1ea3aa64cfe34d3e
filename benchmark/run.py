"""Runs one cell of emox_torch's benchmark once and prints its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1> [--control 1]

From the root of a checkout, on a machine with the cards the cell asks for. The cell's
configuration, traffic, limits and per-layer readers are files of their own under
benchmark/, found by the names in BENCHMARK.json; the traffic names the driver
(benchmark/drivers/) that sets up, runs the window and decides `correct`. With --trace 0 the
metrics are the cell's end-to-end ones; with --trace 1 the window runs under torch.profiler
and the metrics are its per-layer ones. --control 1 puts the control of the lower precision
(the reference in float8) in the program's place for the comparison, so that `correct` is
decided on its numbers against the cell's limits, and --fault <name> plants a fault under the
run (benchmark/harness/faults.py): both for setting limits.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import runtime as rt  # noqa: E402


@dataclass
class Context:
    cell: rt.Cell
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: object  # torch.device
    dtype: object  # torch.dtype the program computes in
    fault: Optional[Callable] = None  # a test's planted fault: called with the program before the window
    scratch: Path = rt.BENCH / ".runs"
    detail: Dict = field(default_factory=dict)  # what the check found, for standard error

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @staticmethod
    def age() -> float:
        return rt.process_age()


def read_metric(name: str, obs: Dict, root: Path = rt.BENCH) -> Optional[float]:
    """The per-layer metric `name` by its reader, benchmark/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def execute(ctx: Context) -> Tuple[Dict, Dict]:
    """Runs the cell's driver; returns the result line's object (without the import check)
    and the seconds of the window and of the check."""
    import torch

    res = rt.driver(ctx.cell).run(ctx)
    checks = res["checks"]
    line = {"correct": checks.correct and res["failed"] == 0, "attempted": res["attempted"], "failed": res["failed"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
              "count": ctx.cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    if not ctx.trace:
        metrics = {m["name"]: res["e2e"][m["name"]] for m in ctx.cell.end_to_end}
    else:
        obs = dict(res["obs"], trace=res["window"].reduce())
        metrics = {}
        for m in ctx.cell.per_layer:
            value = read_metric(m["name"], obs)
            if value is not None:
                metrics[m["name"]] = value
        summary = obs["trace"]
        if summary:
            device.update(busy_s=summary["busy_s"], window_s=res["window"].seconds)
            from benchmark.harness.trace import breakdown

            line["breakdown"] = breakdown(summary)
    line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
    line["device"] = device
    line["checks"] = checks.items
    return line, {"window_s": res["window"].seconds, "check_s": res["check_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default="", help="plant a fault (benchmark/harness/faults.py) to read the numbers")
    args = p.parse_args(argv)
    rt.set_environment()
    cell = rt.load_cell(args.workload)
    import torch
    from emox_torch.core.compile_cache import enable_persistent_cache  # the system under test

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    enable_persistent_cache(str(rt.CACHE / "kernels"))
    fault = None
    if args.fault:
        from benchmark.harness.faults import plant

        fault = lambda target: plant(cell.traffic["driver"], args.fault, target)  # noqa: E731
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), bool(args.control), torch.device("cuda", 0),
                  getattr(torch, cell.config["dtype"]), fault=fault)
    line, took = execute(ctx)
    bad = rt.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port's benchmark may not load JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"window_s {took['window_s']!r} check_s {took['check_s']!r}", file=sys.stderr)
    if ctx.detail:
        print(f"detail {json.dumps(ctx.detail)}", file=sys.stderr)
    if ctx.control:
        print("control: the float8 reference in the program's place", file=sys.stderr)
    for text in rt.Checks(line["checks"]).lines():
        print(f"check {text}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
