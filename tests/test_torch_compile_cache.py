"""enable_persistent_cache (emox_torch.core.compile_cache), the counterpart of
tests/test_compile_cache.py: None and nothing changed without a card; with
one (torch.cuda.is_available patched, nvcc and the loader stubbed) the
kernel libraries build into and load from the directory it names."""

from __future__ import annotations

import subprocess

import torch

from emox_torch.core.compile_cache import enable_persistent_cache
from emox_torch.ops import build


def test_skips_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = build.BUILD_DIR
    assert enable_persistent_cache(str(tmp_path / "should_not_be_used")) is None
    assert build.BUILD_DIR == before and not (tmp_path / "should_not_be_used").exists()


def test_moves_the_build_directory_with_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)  # restored after the test
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_info", {})
    cache = tmp_path / "cc"
    got = enable_persistent_cache(str(cache))
    assert got == str(cache) and cache.is_dir() and build.BUILD_DIR == cache
    assert enable_persistent_cache(str(cache)) == got  # idempotent
    assert build._target("group_norm").parent == cache

    # a build writes its library there: nvcc and the loader stubbed
    class Nvcc:
        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"\0")
            return "ptxas info", None

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {"argtypes": None, "restype": None})()

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    info = build.build(["group_norm"])
    assert info["group_norm"]["path"] == str(build._target("group_norm")) and build._target("group_norm").exists()
    # the default is the checkout's build/emox_torch, where chip_smoke.py builds
    assert enable_persistent_cache() == str(build.DEFAULT_BUILD_DIR)
    assert build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "emox_torch")
