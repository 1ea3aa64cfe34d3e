"""Tiny cells for the benchmark's CPU tests: the port's tiny preset on the CPU in float32,
one served in a single window, one in windows with a prompt, one trained, each with limits
for float32 against float32."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LIMITS = {"state_gap": 0.0, "eps_gap": 1e-4, "step_gap": 1e-4, "frames_gap": 1e-4, "failed_requests": 0,
               "leaf_set_gap": 0, "loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_sections(sd15: bool) -> dict:
    from emox_torch.core.presets import tiny_config

    cfg = tiny_config(32, 3)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, speed_axes=3))
    if sd15:
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, attention_heads=2, resnet_temb_mode="add", use_cross_attention=True,
                                      cross_attention_dim=16),
            clip=dataclasses.replace(cfg.clip, text_enabled=True, text_hidden_dim=16, text_layers=2, text_heads=2),
            inference=dataclasses.replace(cfg.inference, context_frames=4, context_overlap=1))
    out = {k: dataclasses.asdict(getattr(cfg, k)) for k in ("vae", "model", "audio", "clip", "diffusion", "inference")}
    out["train"] = dict(json.loads((ROOT / "benchmark/configs/emo-flagship.json").read_text())["train"],
                        compute_dtype="float32")
    return json.loads(json.dumps(out))


def tiny_bench(root: Path) -> dict:
    """A benchmark of three tiny cells under `root` (its own configs, traffic and limits)."""
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for name, sd15 in (("tiny", False), ("tiny-sd15", True)):
        cfg = dict(name=name, source="tests", reduced=[], assumed=[], dtype="float32", **tiny_sections(sd15))
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    traffic = {
        "serve-tiny": {"driver": "serve_closed_loop", "image_size": 32, "frames": 3, "steps": 4, "guidance_scale": 7.5,
                       "negative_prompt": "", "pool": 2, "warmup_steps": 2, "check_requests": 2, "check_steps": 2},
        "serve-tiny-long": {"driver": "serve_closed_loop", "image_size": 32, "frames": 7, "steps": 3,
                            "guidance_scale": 7.5, "prompts": ["a person talking", "a cat singing loudly"],
                            "negative_prompt": "", "pool": 2, "warmup_steps": 2, "check_requests": 1, "check_steps": 2},
        "train-tiny": {"driver": "train_steps", "image_size": 32, "stage": 2, "batch": 2, "frames": 3,
                       "learning_rate": 1e-3, "pool": 4, "check_steps": 3},
    }
    for name, tr in traffic.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    cells = [("tiny-serve", "tiny", "serve-tiny"), ("tiny-long", "tiny-sd15", "serve-tiny-long"),
             ("tiny-train", "tiny", "train-tiny")]
    for name, _, _ in cells:
        (root / "limits" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    serve, train = ["tiny-serve", "tiny-long"], ["tiny-train"]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"} for n, c, t in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = serve if m["workloads"][0].startswith(("flagship-serve", "sd15")) else train
    return bench


def run_tiny(tmp_path: Path, workload: str, fault=None, trace: bool = False, control: bool = False, seed: int = 3,
             limits=None, device: str = "cpu"):
    """One run of a tiny cell (a window of one request or step); `limits` in place of the
    tiny ones."""
    import benchmark.drivers.train_steps as train_steps
    from benchmark.harness import runtime as rt
    from benchmark.run import Context, execute

    bench = tiny_bench(tmp_path)
    if limits is not None:
        (tmp_path / "limits" / f"{workload}.json").write_text(json.dumps(limits))
    cell = rt.load_cell(workload, bench, root=tmp_path)
    ctx = Context(cell, seed, 0.0, trace, control, torch.device(device), torch.float32, fault=fault,
                  scratch=tmp_path / "runs")
    rows, train_steps.LOSS_ROWS = train_steps.LOSS_ROWS, 1  # the reference's blocks of rows, one row each
    try:
        return execute(ctx)[0]
    finally:
        train_steps.LOSS_ROWS = rows
