"""BENCHMARK.json and the files it names: every configuration, traffic mix, limit set and
per-layer reader found by name, a new one picked up without an edit, the result line's keys,
and the guard against JAX."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny, tiny_bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200 and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(workload):
    from benchmark.harness import runtime as rt

    cell = rt.load_cell(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.config["dtype"] == cell.config["train"]["compute_dtype"]
    assert (ROOT / "benchmark/drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_reader_states_what_benchmark_json_does(metric):
    import importlib.util

    path = ROOT / "benchmark/metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (metric["unit"], metric["layer"], metric["moves"],
                                                           metric["source"])


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    from benchmark.harness import runtime as rt
    from benchmark.run import read_metric

    bench = tiny_bench(tmp_path)
    (tmp_path / "traffic" / "serve-tiny-more.json").write_text(
        (tmp_path / "traffic" / "serve-tiny.json").read_text().replace('"steps": 4', '"steps": 5'))
    (tmp_path / "limits" / "tiny-more.json").write_text((tmp_path / "limits" / "tiny-serve.json").read_text())
    bench["workloads"].append({"name": "tiny-more", "config": "tiny", "traffic": "serve-tiny-more", "chips": 1,
                               "why": "test"})
    cell = rt.load_cell("tiny-more", bench, root=tmp_path)
    assert cell.traffic["steps"] == 5 and cell.config_name == "tiny"
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "host.requests.serve.py").write_text("def read(obs):\n    return obs['requests']\n")
    assert read_metric("host.requests.serve", {"requests": 7}, root=tmp_path) == 7


def test_the_result_line_has_the_drivers_keys(tmp_path):
    line = run_tiny(tmp_path, "tiny-serve")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"serve_frames_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    traced = run_tiny(tmp_path, "tiny-train", trace=True)
    assert set(traced) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
    assert list(traced)[-1] == "checks"


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        tree = ast.parse(path.read_text())
        tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        tops |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not tops & {"jax", "jaxlib", "flax", "emox"}, path
        if "reference" in path.parts:
            assert "emox_torch" not in tops, path


def test_a_run_loads_no_jax_by_whole_top_level_name(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark/tests')!r}]
from pathlib import Path
from conftest import run_tiny
from benchmark.harness.runtime import forbidden_modules
assert run_tiny(Path({str(tmp_path)!r}), "tiny-long")["correct"]
assert "emox_torch" in sys.modules and forbidden_modules() == [], forbidden_modules()
sys.modules["emox"] = sys.modules["emox_torch"]
assert forbidden_modules() == ["emox"]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("with_program", [False, True])
def test_a_run_without_the_card_or_the_program_prints_no_result(tmp_path, with_program):
    """From a checkout that holds only BENCHMARK.json and the benchmark's folder (the program
    missing), or on a machine without a card: a non-zero exit and no result line."""
    import shutil

    import torch

    if with_program and torch.cuda.is_available():
        pytest.skip("with a card and the program the run would measure")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns(".cache", ".runs"))
    if with_program:
        (tmp_path / "emox_torch").symlink_to(ROOT / "emox_torch")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
