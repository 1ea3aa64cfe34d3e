"""The profiling hooks, the metric sinks and fit's trace capture, on the CPU.

  * emox_torch.utils.profiling: trace() writes a Chrome trace holding the
    annotated regions; StepTimer discards its warm-up; the memory
    statistics are empty without a card; save_profile_summary appends a
    JSON line;
  * MetricsLogger's TensorBoard and wandb sinks (EMOX_TENSORBOARD=1,
    EMOX_WANDB=1) on stand-in modules put in place with monkeypatch, and
    skipped when the package is missing, as the reference skips them;
  * Trainer.fit with EMOX_PROFILE_DIR: steps 3-5 of the run traced, the
    trace stopped when the run ends inside the window, and the first step's
    compile_s logged.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import sys
import types

import pytest
import torch

from emox_torch.core.presets import tiny_config
from emox_torch.train import MetricsLogger, Trainer
from emox_torch.utils import profiling


def _events(log_dir):
    files = glob.glob(f"{log_dir}/*.pt.trace.json")
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_the_annotated_regions(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("emox_region"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    names = {e.get("name") for e in _events(tmp_path)}
    assert "emox_region" in names and any(n and "mm" in n for n in names)


def test_step_timer_and_summary(tmp_path):
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            torch.randn(8, 8).sum()
    s = timer.summary()
    assert s["n"] == 2.0 and s["mean_ms"] > 0 and s["steps_per_sec"] == pytest.approx(1e3 / s["mean_ms"])
    assert profiling.device_memory_stats() == {}  # no card here
    path = tmp_path / "sub" / "profile.jsonl"
    profiling.save_profile_summary(str(path), timer, {"what": 1})
    profiling.save_profile_summary(str(path), timer)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 2 and recs[0]["what"] == 1 and recs[0]["memory"] == {} and recs[1]["n"] == 2.0


def _fake_sinks(monkeypatch):
    calls = {"tb": [], "wandb": []}

    class SummaryWriter:
        def __init__(self, log_dir):
            calls["tb"].append(("init", log_dir))

        def add_scalar(self, key, value, step):
            calls["tb"].append((key, value, step))

        def close(self):
            calls["tb"].append("close")

    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    wandb = types.ModuleType("wandb")
    wandb.run = None

    def init(project, name):
        calls["wandb"].append(("init", project, name))
        wandb.run = object()

    wandb.init = init
    wandb.log = lambda values, step: calls["wandb"].append((values, step))
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    return calls


def test_metric_sinks_get_every_record(tmp_path, monkeypatch):
    calls = _fake_sinks(monkeypatch)
    monkeypatch.setenv("EMOX_TENSORBOARD", "1")
    monkeypatch.setenv("EMOX_WANDB", "1")
    monkeypatch.setenv("EMOX_WANDB_PROJECT", "talking")
    log = MetricsLogger(str(tmp_path), "stage2")
    log.log(3, {"loss": torch.tensor(0.5), "grad_norm": 2})
    log.close()
    assert calls["tb"] == [("init", str(tmp_path / "tb" / "stage2")), ("loss", 0.5, 3), ("grad_norm", 2.0, 3), "close"]
    assert calls["wandb"] == [("init", "talking", "stage2"), ({"loss": 0.5, "grad_norm": 2.0}, 3)]
    rec = json.loads((tmp_path / "stage2_metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["grad_norm"] == 2.0


def test_metric_sinks_off_or_missing_are_skipped(tmp_path, monkeypatch):
    calls = _fake_sinks(monkeypatch)
    MetricsLogger(str(tmp_path), "a").log(1, {"loss": 1.0})  # switches unset
    assert calls == {"tb": [], "wandb": []}
    monkeypatch.setenv("EMOX_TENSORBOARD", "1")
    monkeypatch.setenv("EMOX_WANDB", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises ImportError
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = MetricsLogger(str(tmp_path), "b")
    log.log(1, {"loss": 1.0})
    log.close()
    assert (tmp_path / "b_metrics.jsonl").exists() and not (tmp_path / "tb").exists()


@pytest.mark.parametrize("steps", [7, 5], ids=["whole_window", "ends_inside"])
def test_fit_traces_steps_3_to_5(steps, tmp_path, monkeypatch):
    cfg = tiny_config(16, 2)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, stage=2, num_steps=steps, log_every=1, checkpoint_every=0,
                                                compute_dtype="float32", checkpoint_dir=str(tmp_path / "ckpt")))
    monkeypatch.setenv("EMOX_PROFILE_DIR", str(tmp_path / "trace"))
    gen = torch.Generator().manual_seed(0)
    batch = {"ref_image": torch.rand((1, 16, 16, 3), generator=gen) * 2 - 1,
             "frames": torch.rand((1, 2, 16, 16, 3), generator=gen) * 2 - 1,
             "wav": torch.randn((1, 16000 * 6 // 25), generator=gen) * 0.1}
    tr = Trainer(cfg, device="cpu")
    tr.fit(iter([batch] * steps))
    tr.close()
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    traced = {n for n in names if n and n.startswith("train_step_")}
    assert traced == {f"train_step_{i}" for i in range(3, min(steps, 6))}
    log = [json.loads(line) for line in open(tr.logger.path)]
    assert "compile_s" in log[0] and sum("loss" in r for r in log) == steps
