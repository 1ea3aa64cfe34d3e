"""The quality metrics and the `eval` command against the reference, on the CPU.

  * every function of emox_torch.eval.metrics against emox.eval.metrics on
    the same seeded numpy inputs, <= 1e-5 relative (absolute near 0);
  * `python -m emox_torch eval` against the reference's own `emox eval` on
    a fixture: a generated clip (.npz of uint8 frames), a precompute cache
    as ground truth (frames, face masks, wav, fps), a reference image and a
    checkpoint of the side models (the tiny preset with a 2-layer CLIP
    vision encoder): psnr_db, ssim, temporal_flicker, audio_sync,
    gt_audio_sync, identity_similarity and latent_frechet. The commands
    print 6 decimals; the reference reads the same weights from its own
    checkpoint reader (stood in for by the param tree).
"""

from __future__ import annotations

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox import cli as jcli
from emox.data import native as jnative
from emox.eval import metrics as jm
from emox_torch import cli
from emox_torch.core import config as tconfig
from emox_torch.eval import metrics as tm
from emox_torch.train.trainer import Checkpointer
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches  # noqa: F401 (autouse fixture)

TOL = 1e-5


def close(got, want, tol=TOL, atol=1e-7) -> bool:
    got, want = float(got), float(want)
    return abs(got - want) <= tol * abs(want) + atol


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    t, h, w = 6, 24, 20
    gt = rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32)
    gen = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    masks = np.stack([((yy - h / 2 - k) ** 2 + (xx - w / 2) ** 2 < (h / 3) ** 2) for k in range(t)])
    masks = masks[..., None].astype(np.float32)
    # speech-like: noise under an envelope that moves from frame to frame (a
    # flat one makes the sync correlation ill-conditioned in float32:
    # test_audio_sync_of_a_flat_envelope_against_float64)
    env = np.repeat(rng.uniform(0.1, 1.0, t), 640)
    wav = (0.3 * env * rng.standard_normal(16000 * t // 25)).astype(np.float32)
    return dict(gen=gen, gt=gt, masks=masks, wav=wav)


def _sync64(frames, masks, wav, spf=640) -> float:
    """audio_sync_score in float64 numpy: the truth both packages round."""
    x, m, wav = frames.astype(np.float64), masks.astype(np.float64), wav.astype(np.float64)
    t, h = x.shape[:2]
    rows = np.arange(h)[None, :, None, None]
    cy = (m * rows).sum((1, 2, 3), keepdims=True) / np.maximum(m.sum((1, 2, 3), keepdims=True), 1e-6)
    lower = m * (rows > cy)
    mouth = -(x.mean(-1, keepdims=True) * lower).sum((1, 2, 3)) / np.maximum(lower.sum((1, 2, 3)), 1e-6)
    env = np.sqrt((wav[:t * spf].reshape(t, spf) ** 2).mean(1))
    a, b = mouth - mouth.mean(), env / env.max() - (env / env.max()).mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def _frechet64(a, b, eps=1e-6) -> float:
    """frechet_distance in float64 numpy."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ca, cb = np.cov(a, rowvar=False) + eps * np.eye(a.shape[1]), np.cov(b, rowvar=False) + eps * np.eye(a.shape[1])
    ev, u = np.linalg.eigh(ca)
    sa = (u * np.sqrt(np.maximum(ev, 0))) @ u.T
    tr = np.sqrt(np.maximum(np.linalg.eigvalsh(sa @ cb @ sa), 0)).sum()
    return float(((a.mean(0) - b.mean(0)) ** 2).sum() + np.trace(ca) + np.trace(cb) - 2 * tr)


@pytest.mark.parametrize("name", ["psnr", "ssim", "temporal_flicker"])
def test_frame_metrics_match_the_reference(name, clips):
    got = getattr(tm, name)(torch.from_numpy(clips["gen"]), torch.from_numpy(clips["gt"]))
    want = getattr(jm, name)(jnp.asarray(clips["gen"]), jnp.asarray(clips["gt"]))
    assert close(got, want)


def test_psnr_caps_identical_inputs_at_100_db(clips):
    x = torch.from_numpy(clips["gt"])
    assert float(tm.psnr(x, x)) == pytest.approx(100.0)


def test_ssim_of_one_frame_and_its_window_match_the_reference(clips):
    got = tm.ssim(torch.from_numpy(clips["gen"][0]), torch.from_numpy(clips["gt"][0]), window=7, sigma=1.0)
    want = jm.ssim(jnp.asarray(clips["gen"][0]), jnp.asarray(clips["gt"][0]), window=7, sigma=1.0)
    assert close(got, want)


def test_audio_series_match_the_reference(clips):
    f, m, w = (torch.from_numpy(clips[k]) for k in ("gen", "masks", "wav"))
    jf, jmask, jw = (jnp.asarray(clips[k]) for k in ("gen", "masks", "wav"))
    np.testing.assert_allclose(tm.frame_audio_envelope(w, 8, 640).numpy(),  # padded past the end
                               np.asarray(jm.frame_audio_envelope(jw, 8, 640)), rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(tm.mouth_openness(f, m).numpy(), np.asarray(jm.mouth_openness(jf, jmask)),
                               rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(tm.mouth_openness(f, m[..., 0]).numpy(),  # [T, H, W] masks
                               np.asarray(jm.mouth_openness(jf, jmask[..., 0])), rtol=TOL, atol=1e-7)
    assert close(tm.audio_sync_score(f, m, w, fps=25.0), jm.audio_sync_score(jf, jmask, jw, fps=25.0))


def test_audio_sync_of_a_flat_envelope_against_float64(clips):
    """White noise: every frame's RMS within a few percent, so the
    correlation divides float32 rounding by a small spread. Both packages
    against the float64 truth: the port within 1e-5, the reference (its
    own float32 arithmetic) within 1e-4."""
    wav = (0.3 * np.random.default_rng(5).standard_normal(clips["wav"].shape)).astype(np.float32)
    truth = _sync64(clips["gen"], clips["masks"], wav)
    got = tm.audio_sync_score(*(torch.from_numpy(a) for a in (clips["gen"], clips["masks"], wav)))
    want = jm.audio_sync_score(*(jnp.asarray(a) for a in (clips["gen"], clips["masks"], wav)))
    assert close(got, truth) and close(want, truth, tol=1e-4)


def test_pearson_matches_the_reference():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(17).astype(np.float32), rng.standard_normal(17).astype(np.float32)
    assert close(tm.pearson(torch.from_numpy(a), torch.from_numpy(b)), jm.pearson(jnp.asarray(a), jnp.asarray(b)))
    flat = np.full(17, 0.5, np.float32)
    assert float(tm.pearson(torch.from_numpy(a), torch.from_numpy(flat))) == 0.0


def test_identity_similarity_matches_the_reference():
    rng = np.random.default_rng(2)
    fe, re = rng.standard_normal((5, 12)).astype(np.float32), rng.standard_normal((1, 12)).astype(np.float32)
    assert close(tm.identity_similarity(torch.from_numpy(fe), torch.from_numpy(re)),
                 jm.identity_similarity(jnp.asarray(fe), jnp.asarray(re)))


@pytest.mark.parametrize("n,d", [(64, 8), (6, 16)], ids=["well_posed", "few_samples"])
def test_frechet_distance_matches_the_reference(n, d):
    """Against the reference where its float32 fit is well posed (N >> D);
    with fewer samples than dims (singular covariances, as latent_frechet
    of a short clip) against the float64 truth, which the reference's
    float32 result misses by up to 1e-4."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (1.5 * rng.standard_normal((n, d)) + 0.3).astype(np.float32)
    got = tm.frechet_distance(torch.from_numpy(a), torch.from_numpy(b))
    want, truth = jm.frechet_distance(jnp.asarray(a), jnp.asarray(b)), _frechet64(a, b)
    assert close(got, truth, tol=1e-6)
    assert close(got, want, tol=TOL if n > d else 2e-4)
    assert abs(float(tm.frechet_distance(torch.from_numpy(a), torch.from_numpy(a)))) < 1e-3
    with pytest.raises(ValueError, match=">= 2 frames"):
        tm.frechet_distance(torch.from_numpy(a[:1]), torch.from_numpy(b))


def test_evaluate_clip_matches_the_reference(clips):
    kw = dict(masks=clips["masks"], wav=clips["wav"], fps=25.0)
    got = tm.evaluate_clip(clips["gen"], gt=clips["gt"], device="cpu", **kw)
    want = jm.evaluate_clip(clips["gen"], gt=clips["gt"], **kw)
    assert set(got) == set(want) == {"psnr_db", "ssim", "temporal_flicker", "audio_sync", "gt_audio_sync"}
    assert all(close(got[k], want[k]) for k in want), (got, want)
    assert tm.evaluate_clip(clips["gen"], device="cpu") == {}
    with pytest.raises(ValueError, match="shapes must match"):
        tm.evaluate_clip(clips["gen"], gt=clips["gt"][:, :-1], device="cpu")


# ---- the command -------------------------------------------------------------------
def _printed(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_eval_command_matches_the_reference(tmp_path, monkeypatch):
    """Both commands on the same files: a 4-frame generated clip at 32^2,
    a 5-frame cache (trimmed to 4), a reference image and the side models'
    weights (the reference's from its param tree, the port's from a
    checkpoint of the same tree)."""
    import emox.train.trainer as jtrainer

    from emox_torch.models.emo import EMOModel

    monkeypatch.setenv("EMOX_NATIVE_NO_BUILD", "1")
    monkeypatch.setattr(jnative, "_lib", lambda: None)  # the reference's numpy resize
    jmodel, params, tcfg = model_params("tiny_side")
    rng = np.random.default_rng(4)
    t = 4
    gt = rng.integers(0, 256, (t + 1, IMAGE, IMAGE, 3), dtype=np.uint8)
    gen = np.clip(gt[:t].astype(np.int16) + rng.integers(-30, 30, gt[:t].shape), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    masks = np.repeat(((yy - 16) ** 2 + (xx - 16) ** 2 < 100)[None, ..., None], t + 1, 0).astype(np.float32)
    wav = (0.2 * rng.standard_normal(16000 * (t + 1) // 25)).astype(np.float32)
    np.savez(tmp_path / "gen.npz", frames=gen)
    np.savez(tmp_path / "gt.npz", frames=gt, face_masks=masks, wav=wav, fps=np.float32(25.0))
    np.save(tmp_path / "ref.npy", rng.uniform(-1, 1, (40, 40, 3)).astype(np.float32))
    tconfig.save_config(tcfg, str(tmp_path / "side.yaml"))
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    Checkpointer(str(tmp_path / "ckpt")).save(1, {"params": dict(model.modules.named_parameters())})

    class FlaxTree:  # the reference's Orbax reader, handing back the same tree
        def __init__(self, directory):
            pass

        def restore_params(self, use_ema=False):
            return params

    monkeypatch.setattr(jtrainer, "Checkpointer", FlaxTree)
    argv = ["eval", "--gen", str(tmp_path / "gen.npz"), "--gt", str(tmp_path / "gt.npz"), "--ref-image",
            str(tmp_path / "ref.npy"), "--params", str(tmp_path / "ckpt"), "--config", str(tmp_path / "side.yaml")]
    want = _printed(jcli.main, argv)
    got = _printed(cli.main, argv + ["--device", "cpu", "--out", str(tmp_path / "m.json")])
    assert set(got) == set(want) == {"psnr_db", "ssim", "temporal_flicker", "audio_sync", "gt_audio_sync",
                                     "identity_similarity", "latent_frechet"}
    # 6 printed decimals: half a unit of the last one on top of the relative bar
    assert all(close(got[k], want[k], atol=5e-6) for k in want if k != "latent_frechet"), (got, want)
    # latent_frechet fits 64 features to 4 frames: singular covariances, whose
    # square roots the reference's float32 eigh rounds visibly. Both against the
    # float64 distance of the reference's own pooled latents.
    import jax

    gen_f = jnp.asarray(gen.astype(np.float32) / 127.5 - 1.0)
    gt_f = jnp.asarray(gt[:t].astype(np.float32) / 127.5 - 1.0)

    def feats(frames):
        lat = jmodel.encode_images(params, frames)
        return np.asarray(jax.image.resize(lat, (t, 4, 4, lat.shape[-1]), "linear")).reshape(t, -1)

    truth = _frechet64(feats(gen_f), feats(gt_f))
    assert close(got["latent_frechet"], truth, atol=5e-6), (got["latent_frechet"], truth)
    assert close(want["latent_frechet"], truth, tol=1e-2), (want["latent_frechet"], truth)
    assert json.loads((tmp_path / "m.json").read_text()) == got
    # the metrics alone (no --params), from the cache's masks and wav
    plain = _printed(cli.main, ["eval", "--gen", str(tmp_path / "gen.npz"), "--gt", str(tmp_path / "gt.npz"),
                                "--device", "cpu"])
    assert {k: got[k] for k in plain} == plain
