"""The port stands alone: it imports neither JAX nor anything of emox.

emox_torch and chip_smoke.py run on machines that have no JAX (and no
PyYAML), so every module of the port is imported in a fresh interpreter
and the test asserts that none of jax, flax, emox or yaml came in; the
sources are also scanned for such imports, including those inside
functions; importing the trainer leaves optax and orbax out as well. Entry points run on the CUDA card unless told otherwise, and
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
            "emox_torch.core.dtypes", "emox_torch.data.tokenizer", "emox_torch.models.clip"} <= set(res["modules"])
    leaked = sorted(set(res["roots"]) & set(FORBIDDEN + ("yaml",)))
    assert not leaked, f"importing emox_torch pulled in {leaked}"


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
    """PyYAML is not on the card machine: only the two YAML functions touch it."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            body_imports = [n for n in ast.walk(fn) if isinstance(n, ast.Import)
                            and any(a.name == "yaml" for a in n.names)]
            if isinstance(fn, ast.Module):
                top = [n for n in fn.body if isinstance(n, ast.Import) and any(a.name == "yaml" for a in n.names)]
                assert not top, path
            elif isinstance(fn, ast.FunctionDef) and body_imports:
                assert fn.name in ("load_config", "save_config"), (path, fn.name)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from emox_torch.core.device import resolve_device
    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        EMOModel(tiny_config())
    assert resolve_device("cpu") == torch.device("cpu")
    assert EMOModel(tiny_config(), device="cpu").device.type == "cpu"


def test_unsupported_options_raise_with_their_roadmap_item():
    import dataclasses

    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel

    cfg = tiny_config()
    for field in ("use_sparse_causal", "use_controlnet", "use_identity_embed"):
        bad = cfg.replace(model=dataclasses.replace(cfg.model, **{field: True}))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EMOModel(bad, device="cpu")
    bad = cfg.replace(clip=dataclasses.replace(cfg.clip, vision_enabled=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EMOModel(bad, device="cpu")
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
