"""Stage 0 and the face nets against the reference on the CPU, in float32.

FaceLocator (face-region logits, upsampled as jax.image.resize's
"bilinear") and FaceLandmarkNet (6 landmarks by soft-argmax), on seeded
random weights and on the trained weights the repository ships
(emox/assets/face_nets.npz, read by path through the port's own
load_face_nets), then stage 0's loss (BCE with logits, IoU, and the 10x
landmark MSE weighted by landmarks_valid) and its gradients over the two
nets. Outputs, loss and metrics <= 1e-5 relative; gradients, flattened,
<= 1e-5 relative L2 (float32 sums in other orders; measured at most 2.3e-7
and 2.1e-6).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.diffusion import schedule as jschedule
from emox.train import face_nets as jface
from emox.train import stages as jstages
from emox_torch.diffusion import schedule as tschedule
from emox_torch.models.emo import EMOModel
from emox_torch.train import sample_draws, stage_loss_fn, trainable_mask
from emox_torch.train.face_nets import load_face_nets, load_face_nets_into, save_face_nets
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_train import _port_leaves

ASSET = str(Path(__file__).resolve().parents[1] / "emox" / "assets" / "face_nets.npz")
TOL = 1e-5
WEIGHTS = ("random", "asset")


@functools.lru_cache(maxsize=None)
def _params(weights: str):
    """The tiny preset's reference param tree, its face nets replaced by the
    shipped ones for "asset"."""
    _, params, _ = model_params("tiny")
    if weights == "asset":
        params = dict(params, **jface.load_face_nets(ASSET))
    return params


def _config():
    jm, _, tcfg = model_params("tiny")
    return tuple(c.replace(train=dataclasses.replace(c.train, stage=0, compute_dtype="float32"))
                 for c in (jm.config, tcfg))


def _batch(landmarks: str, batch: int = 4, size: int = IMAGE):
    """Images with a bright disc (the shipped locator finds faces in such
    frames), its mask, and with landmarks "all" or "half" (the second half
    of the batch marked invalid) 6 points each."""
    rng = np.random.default_rng(60)
    yy, xx = np.mgrid[:size, :size] / size
    centre = rng.uniform(0.35, 0.65, (batch, 2))
    disc = ((yy[None] - centre[:, :1, None]) ** 2 + (xx[None] - centre[:, 1:, None]) ** 2) < 0.25 ** 2
    images = np.where(disc[..., None], 0.6, -0.4) + 0.2 * rng.standard_normal((batch, size, size, 3))
    out = {"images": images.astype(np.float32), "masks": disc[..., None].astype(np.float32)}
    if landmarks != "none":
        out["landmarks"] = rng.uniform(0.2, 0.8, (batch, 6, 2)).astype(np.float32)
    if landmarks == "half":
        out["landmarks_valid"] = (np.arange(batch) < batch // 2).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _reference(weights: str, landmarks: str):
    from emox.models.emo import EMOModel as JEMOModel

    jcfg, _ = _config()
    jm = JEMOModel(jcfg)
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), 0)
    batch = {k: jnp.asarray(v) for k, v in _batch(landmarks).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, _params(weights)), batch, jax.random.PRNGKey(0))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _model(weights: str) -> EMOModel:
    _, tcfg = _config()
    return EMOModel(tcfg, device="cpu").load_flax(_params(weights))


@pytest.mark.parametrize("weights", WEIGHTS)
def test_face_nets_match_the_reference(weights):
    """locate_face and locate_landmarks at 64^2 (the trunk pools to 8^2)."""
    from emox.models.emo import EMOModel as JEMOModel

    jcfg, _ = _config()
    jm, model = JEMOModel(jcfg), _model(weights)
    images = _batch("none", size=64)["images"]
    params = jax.tree.map(jnp.asarray, _params(weights))
    with torch.no_grad():
        logits = model.locate_face(torch.from_numpy(images))
        points = model.locate_landmarks(torch.from_numpy(images))
    want_logits = jm.locate_face(params, jnp.asarray(images))
    want_points = jm.locate_landmarks(params, jnp.asarray(images))
    assert logits.shape == (4, 64, 64, 1) and points.shape == (4, 6, 2)
    assert rel_err(logits, want_logits) <= TOL and rel_err(points, want_points) <= TOL
    if weights == "asset":  # trained weights: the mask follows the disc
        mask = _batch("none", size=64)["masks"]
        iou = ((logits.numpy() > 0) & (mask > 0.5)).sum() / ((logits.numpy() > 0) | (mask > 0.5)).sum()
        assert iou > 0.5, iou


CASES = [(w, lm) for w in WEIGHTS for lm in ("none", "all", "half")]


@pytest.mark.parametrize("weights,landmarks", CASES, ids=[f"{w}-{lm}" for w, lm in CASES])
def test_stage0_loss_and_grads_match_the_reference(weights, landmarks):
    want_loss, want_metrics, want_grads = _reference(weights, landmarks)
    _, tcfg = _config()
    model = _model(weights)
    mask = trainable_mask(model.modules, 0)
    model.set_trainable(mask)
    sched = tschedule.make_schedule(tcfg.diffusion)
    batch = {k: torch.from_numpy(v) for k, v in _batch(landmarks).items()}
    assert sample_draws(tcfg, sched, 0, batch, torch.Generator()) == {}
    loss, metrics = stage_loss_fn(model, tcfg, sched, 0)(batch, {})
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        assert abs(v.item() - want_metrics[k]) <= TOL * max(abs(want_metrics[k]), 1e-6), k
    assert abs(loss.item() - want_loss) <= TOL * abs(want_loss)
    if landmarks == "half":
        assert metrics["landmark_frac"].item() == 0.5
    params_t = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    assert {n.split(".")[0] for n in names} == {"face_locator", "landmarker"}
    grads = torch.autograd.grad(loss, [params_t[n] for n in names], allow_unused=True)
    grads = [torch.zeros_like(params_t[n]) if g is None else g for n, g in zip(names, grads)]
    want = _port_leaves(want_grads)
    got_flat = torch.cat([g.reshape(-1) for g in grads]).double()
    want_flat = torch.cat([torch.from_numpy(np.asarray(want[n])).reshape(-1) for n in names]).double()
    assert float(want_flat.norm()) > 0
    assert float((got_flat - want_flat).norm() / want_flat.norm()) <= TOL


def test_face_nets_file_round_trips_the_reference_layout(tmp_path):
    """The port reads the shipped file exactly as the reference does (float16
    on disk, float32 loaded); a file the port writes, the reference reads
    back, and the other way round; a missing file gives None; the loaded
    tree lands in a model's face nets through the weight bridge."""
    got, want = load_face_nets(ASSET), jface.load_face_nets(ASSET)
    flat = lambda tree: {"/".join(map(str, (getattr(k, "key", k) for k in p))): np.asarray(v)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(got).keys() == flat(want).keys() and len(flat(got)) == 16
    for k, v in flat(got).items():
        assert v.dtype == np.float32 and np.array_equal(v, flat(want)[k]), k
    port_file = save_face_nets(got, str(tmp_path / "port" / "face_nets.npz"))
    with np.load(port_file) as f:
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float16)}
    for k, v in flat(jface.load_face_nets(port_file)).items():
        assert np.array_equal(v, flat(want)[k]), k
    ref_file = jface.save_face_nets(jax.tree.map(lambda x: x + 0.5, want), str(tmp_path / "ref.npz"),
                                    dtype=np.float32)
    for k, v in flat(load_face_nets(ref_file)).items():
        assert np.array_equal(v, flat(want)[k] + 0.5), k
    assert load_face_nets(str(tmp_path / "absent.npz")) is None
    model = _model("random")
    load_face_nets_into(model.modules, got)
    np.testing.assert_array_equal(model.modules.landmarker.heat.weight.detach().numpy(),
                                  np.asarray(got["landmarker"]["heat"]["kernel"]).transpose(3, 2, 0, 1))
