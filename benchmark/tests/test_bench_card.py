"""The tiny cells on the card: the harness, the recorder and the reference on CUDA tensors
(float32; at these sizes no site reaches the hand-written kernels)."""

from __future__ import annotations

import pytest
import torch

from conftest import TINY_LIMITS, run_tiny


@pytest.mark.card
@pytest.mark.parametrize("workload", ["tiny-serve", "tiny-long", "tiny-train"])
def test_tiny_cells_on_the_card(tmp_path, monkeypatch, card, workload):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the program in float32 as the reference
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    line = run_tiny(tmp_path, workload, device="cuda", trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert all(c["value"] <= TINY_LIMITS[k] for k, c in line["checks"].items())
