"""train_face_nets on the CPU reaches the bars that the reference's shipped
face nets are held to (tests/test_face_nets.py::test_shipped_asset_quality:
mask IoU > 0.5 and landmark error < 6 px at 128^2 on a held-out sample),
and the file it writes reads back as the reference's format."""

from __future__ import annotations

import numpy as np

from emox.data.fixtures import synthetic_face_batch
from emox.train.face_nets import load_face_nets as load_reference
from emox_torch.data.face import FaceHelper
from emox_torch.train.face_nets import save_face_nets, train_face_nets


def test_two_hundred_steps_reach_the_asset_bars(tmp_path):
    params, metrics = train_face_nets(steps=200, batch_size=8, image_size=128, log_every=0, device="cpu")
    assert metrics["val_landmark_px"] < 6.0, metrics
    path = save_face_nets(params, str(tmp_path / "face_nets.npz"))
    assert set(load_reference(path)) == {"face_locator", "landmarker"}
    fh = FaceHelper.from_asset(path, device="cpu")
    batch = synthetic_face_batch(np.random.default_rng(123), 8, 128, 128)
    ious, errs = [], []
    for i in range(8):
        mask = fh.face_mask(batch["image"][i])
        ious.append((mask * batch["mask"][i]).sum() / np.maximum(mask, batch["mask"][i]).sum())
        lm = fh.landmark_fn(batch["image"][i])  # pixel (x, y)
        gt = batch["landmarks"][i] * 128  # (y, x)
        errs.append(np.abs(np.stack([lm[:, 1], lm[:, 0]], -1) - gt).mean())
    assert np.mean(ious) > 0.5, f"mask IoU too low: {np.mean(ious):.3f}"
    assert np.mean(errs) < 6.0, f"landmark err {np.mean(errs):.2f} px @128"
