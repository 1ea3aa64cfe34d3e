"""The port stands alone: it imports neither JAX nor anything of emox.

emox_torch and chip_smoke.py run on machines that have no JAX (and no
PyYAML), so every module of the port is imported in a fresh interpreter
and the test asserts that none of jax, flax, emox or yaml came in; the
sources are also scanned for such imports, including those inside
functions; importing the trainer leaves optax and orbax out as well, and
the command line (`python -m emox_torch`) and the config reader pull in
none of them either. Entry points run on the CUDA card unless told otherwise, and
raise rather than fall back to the CPU when there is none.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "emox_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "emox")

_PROBE = r"""
import importlib, json, pkgutil, sys
import emox_torch
names = sorted(m.name for m in pkgutil.walk_packages(emox_torch.__path__, "emox_torch."))
for n in names:
    importlib.import_module(n)
roots = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"modules": names, "roots": roots}))
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_every_module_pulls_in_no_jax_and_no_emox():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"emox_torch.ops.attention", "emox_torch.ops.ff", "emox_torch.infer.pipeline",
            "emox_torch.interop.from_flax", "emox_torch.train.stages", "emox_torch.train.trainer",
            "emox_torch.train.face_nets",
            "emox_torch.core.dtypes", "emox_torch.data.tokenizer", "emox_torch.models.clip",
            "emox_torch.cli", "emox_torch.data.dataset", "emox_torch.data.records", "emox_torch.data.precompute",
            "emox_torch.core.yamlio", "emox_torch.utils.profiling", "emox_torch.eval.metrics",
            "emox_torch.infer.export", "emox_torch.interop.torch_import", "emox_torch.core.compile_cache",
            "emox_torch.data.camera", "emox_torch.ops.registry", "emox_torch.comm", "emox_torch.comm.runtime",
            "emox_torch.comm.halo", "emox_torch.comm.sharding", "emox_torch.core.mesh",
            "emox_torch.ops.ring"} <= set(res["modules"])
    leaked = sorted(set(res["roots"]) & set(FORBIDDEN + ("yaml",)))
    assert not leaked, f"importing emox_torch pulled in {leaked}"
    # checkpoints are read without safetensors, diffusers or transformers, and
    # cv2 comes in only when a call needs it: none of them at import
    optional = sorted(set(res["roots"]) & {"safetensors", "diffusers", "transformers", "cv2"})
    assert not optional, f"importing emox_torch pulled in {optional}"


def test_importing_train_pulls_in_no_jax_optax_orbax_or_yaml():
    """The trainer runs on the card machine, which has none of these."""
    probe = "import json, sys, emox_torch.train; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    leaked = sorted(roots & {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "emox"})
    assert not leaked, f"importing emox_torch.train pulled in {leaked}"


@pytest.mark.parametrize("module", ["emox_torch.data.tokenizer", "emox_torch.models.clip",
                                    "emox_torch.infer.pipeline"])
def test_prompt_path_pulls_in_no_regex(module):
    """The card machine has no `regex` package (the reference tokenizer's
    word splitter): the port's tokenizer, CLIP encoder and pipeline, and a
    prompt tokenized through them, must not import it."""
    probe = (f"import json, sys, {module}; from emox_torch.data.tokenizer import CLIPTokenizer; "
             "CLIPTokenizer().encode(['x² ½ café 中文 it\\'s 42']); "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    leaked = sorted(roots & {"regex", "jax", "flax", "yaml", "emox"})
    assert not leaked, f"importing {module} pulled in {leaked}"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_jax_or_emox(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_yaml_only_inside_load_and_save_config():
    """PyYAML is not on the card machine: not even load_config and
    save_config import it now; they read and write YAML through
    emox_torch.core.yamlio."""
    for path in sorted(PORT.rglob("*.py")):
        assert "yaml" not in [m.split(".")[0] for m in _imports(path)], path


_CLI_PROBE = r"""
import json, runpy, sys
sys.argv = ["emox_torch", "--help"]
try:
    runpy.run_module("emox_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from emox_torch.core.config import load_config
assert load_config("configs/stage2.yaml").train.stage == 2
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_command_line_and_config_reader_pull_in_no_jax_emox_or_yaml():
    """A fresh `python -m emox_torch --help` and load_config of a shipped
    YAML, as on the card machine."""
    out = subprocess.run([sys.executable, "-c", _CLI_PROBE], cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "precompute" in out.stdout and "train-face" in out.stdout
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    leaked = sorted(roots & {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "emox"})
    assert not leaked, f"the command line pulled in {leaked}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_never_name_the_reference_host_library(path):
    """The reference builds native/libemoxhost.so at first use, racing its
    loader threads; the port keeps numpy copies and never loads or builds it."""
    assert "libemoxhost" not in path.read_text(), path.relative_to(ROOT)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from emox_torch.core.device import resolve_device
    from emox_torch.core.presets import tiny_config
    from emox_torch.eval import evaluate_clip
    from emox_torch.models.emo import EMOModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        EMOModel(tiny_config())
    assert resolve_device("cpu") == torch.device("cpu")
    assert EMOModel(tiny_config(), device="cpu").device.type == "cpu"
    frames = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA card"):
        evaluate_clip(frames, gt=frames)
    assert evaluate_clip(frames, gt=frames, device="cpu")["psnr_db"] == pytest.approx(100.0)


def test_unsupported_options_raise_with_their_roadmap_item():
    import dataclasses

    from emox_torch import cli
    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel

    # what the port still leaves out is a command: bench, which its benchmark
    # PR brings; multi-process training is ported, and exits naming the flags
    # a coordinator needs beside it
    with pytest.raises(SystemExit, match="--num-processes and --process-id"):
        cli.main(["train", "--stage", "2", "--coordinator", "h:1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="benchmark"):
        cli.main(["bench"])
    assert set(cli._NOT_PORTED) == {"bench"}
    cfg = tiny_config()
    # every model option builds: sparse-causal attention, separable convs
    for field in ("use_sparse_causal", "separable_convs"):
        EMOModel(cfg.replace(model=dataclasses.replace(cfg.model, **{field: True})), device="cpu")
    # the side models are ported: the ControlNet, and the CLIP vision encoder
    # with the identity embedding it feeds
    vision = dataclasses.replace(cfg.clip, vision_enabled=True, vision_hidden_dim=8, vision_layers=1, vision_heads=2,
                                 image_size=28, patch_size=14, projection_dim=8)
    side = cfg.replace(model=dataclasses.replace(cfg.model, use_controlnet=True, use_identity_embed=True), clip=vision)
    mods = EMOModel(side, device="cpu").modules
    assert mods.controlnet is not None and mods.clip_vision is not None
    assert EMOModel(cfg.replace(clip=vision), device="cpu").modules.clip_vision is not None
    # the CLIP text encoder is ported: text_enabled builds it
    text = cfg.replace(clip=dataclasses.replace(cfg.clip, text_enabled=True, text_hidden_dim=8, text_layers=1,
                                                text_heads=2, vocab_size=64, max_positions=8))
    assert EMOModel(text, device="cpu").modules.clip_text is not None


def test_kernel_wrappers_never_fall_back_for_cuda_tensors():
    """The wrappers choose by the tensor's device alone: CPU tensors take the
    plain version, other devices raise (a CUDA tensor launches the kernel)."""
    from emox_torch.ops import (flash_attention, flash_attention_bwd, flash_attention_nlc, flash_attention_nlc_bwd,
                                fused_ln_geglu_ff)

    strided = torch.zeros(1, 2, 4, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(strided, strided, strided)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_bwd(*(strided,) * 4, torch.zeros(1, 2, 4, device="meta"), strided)
    meta = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_ln_geglu_ff(meta, *(torch.zeros(1, device="meta"),) * 6)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_nlc(meta[None], meta[None], meta[None], 1)
    lse = torch.zeros(1, 4, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_nlc_bwd(*(meta[None],) * 4, lse, meta[None], 1)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result where there is no
    card, and in a directory that holds nothing else of the repository."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
