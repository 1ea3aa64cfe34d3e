"""The benchmark's reference and its comparison, on the CPU at the port's tiny preset.

The reference against emox_torch in float32 (one request in one window, one in windows with a
prompt, three stage-2 steps), its parameter layout against the port's at every configuration
the benchmark runs, the control of the lower precision in the program's place failing each cell's limits, and every
fault a cell can have driving `correct` to false.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness.faults import NAMES as FAULTS
from benchmark.harness.faults import plant
from conftest import ROOT, TINY_LIMITS, run_tiny

CELL_OF = {"tiny-serve": "flagship-serve512", "tiny-long": "sd15-serve256-long48", "tiny-train": "flagship-train512-s2-b8"}


def cell_limits(tiny: str) -> dict:
    return json.loads((ROOT / "benchmark/limits" / f"{CELL_OF[tiny]}.json").read_text())


@pytest.mark.parametrize("config", sorted(p.stem for p in (ROOT / "benchmark/configs").glob("*.json")))
def test_parameter_layout_is_the_ports(config):
    from emox_torch.core.config import load_config
    from emox_torch.models.emo import EMOModules

    from benchmark.reference.emo import param_shapes

    cfg = json.loads((ROOT / "benchmark/configs" / f"{config}.json").read_text())
    program = load_config(overrides={k: cfg[k] for k in ("vae", "model", "audio", "clip", "diffusion", "inference")})
    with torch.device("meta"):
        mods = EMOModules(program)
    assert {n: tuple(p.shape) for n, p in mods.named_parameters()} == param_shapes(cfg)


@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-long", "tiny-train"])
def test_reference_agrees_with_the_port_in_float32(tmp_path, workload):
    line = run_tiny(tmp_path, workload)
    assert line["correct"], line["checks"]
    for name, c in line["checks"].items():
        assert c["value"] <= TINY_LIMITS[name]


@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-long", "tiny-train"])
def test_the_float8_control_fails_the_cells_limits(tmp_path, workload):
    """The float8 reference in the program's place reads not correct under the cell's limits."""
    line = run_tiny(tmp_path, workload, control=True, limits=cell_limits(workload))
    assert not line["correct"], line["checks"]
    assert set(line["checks"]) == set(cell_limits(workload)), line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-long", "tiny-train"])
def test_a_fault_makes_the_run_incorrect(tmp_path, workload, fault):
    """Each fault a one-card cell can have (the exchange between cards has no place in it),
    planted under the run, fails the cell's own limits."""
    driver = "train_steps" if workload == "tiny-train" else "serve_closed_loop"
    undo = []
    line = run_tiny(tmp_path, workload, fault=lambda target: undo.append(plant(driver, fault, target)),
                    limits=cell_limits(workload))
    for u in undo:
        u()
    assert not line["correct"], line["checks"]
