"""The port's windowed sampler and motion-frame locking against the reference's
EMOPipeline.generate_latents.

A clip longer than inference.context_frames is denoised in overlapping
windows. The tiny preset runs T 7 at context 4, overlap 1, 4 DDIM steps
(steps 0-2 have 3 windows, step 3 has 2 and a padding row), CFG 2.0 batched,
eta 0, with audio, speeds and a face mask, float32. The reference's own
generate_latents draws its initial latents and the locked frames' re-noise
from jax.random; the test rebuilds those draws from the same key chain
(pipeline.py:175-176, :199, :217-218, :239-242) and hands them to the port.
The port folds up to WINDOWS_PER_CALL windows into one call: G = 1 and
G = all windows give the same latents (<= 1e-6), and each is within 1e-5
relative L2 of the reference.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models.emo import EMOModel as JEMOModel
from emox_torch.infer import pipeline as tpipeline
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)

TRAJ_TOL = 1e-5
G_TOL = 1e-6
STEPS, GUIDANCE = 4, 2.0


def windowed(cfg, context=4, overlap=1, **inference):
    """cfg with a context window of `context` frames (and other inference fields)."""
    return cfg.replace(inference=dataclasses.replace(cfg.inference, context_frames=context,
                                                     context_overlap=overlap, **inference))


def request(cfg, frames, seed=0, total_audio_frames=None):
    """Seeded numpy inputs: reference image, wav covering the clip (4 frames
    more), per-frame speeds and a round face mask."""
    rng = np.random.default_rng(seed)
    axes = cfg.model.speed_axes
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    audio_frames = total_audio_frames or frames
    return dict(
        image=rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
        wav=(0.1 * rng.standard_normal((1, 16000 * (audio_frames + 4) // 25))).astype(np.float32),
        speeds=rng.uniform(-1, 1, (1, frames) + ((axes,) if axes > 1 else ())).astype(np.float32),
        mask=((((yy - IMAGE / 2) ** 2 + (xx - IMAGE / 2) ** 2) < (IMAGE / 3) ** 2)
              .astype(np.float32)[None, :, :, None]),
    )


def latent_shape(cfg, frames):
    lat = IMAGE // cfg.vae.downscale
    return (1, frames, lat, lat, cfg.model.in_channels)


def jax_draws(key, shape, steps, lock_shape=None):
    """The reference sampler's draws from `key`: the initial latents
    (k_init of split(key)) and, with locked frames, each step's re-noise
    (the first half of split(k) for k in split(k_lock, steps))."""
    k_init, k_lock = jax.random.split(key)
    latents = np.asarray(jax.random.normal(k_init, shape))
    if lock_shape is None:
        return latents, None
    noise = [np.asarray(jax.random.normal(jax.random.split(k)[0], lock_shape))
             for k in jax.random.split(k_lock, steps)]
    return latents, np.stack(noise)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def inputs(tcfg, frames, lock=0, seed=0):
    """The request, the reference's key, the draws it makes from it and the
    known latents to lock (with lock > 0)."""
    req = request(tcfg, frames, seed)
    shape = latent_shape(tcfg, frames)
    req["key"] = jax.random.PRNGKey(seed)
    req["lock_latents"] = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32) if lock else None
    req["latents"], req["lock_noise"] = jax_draws(req["key"], shape, STEPS, shape if lock else None)
    return req


def reference_latents(jcfg, params, req, frames, lock=0):
    """The reference's own generate_latents (it draws from req["key"])."""
    lock_latents = req["lock_latents"]
    return np.asarray(JEMOPipeline(JEMOModel(jcfg), jcfg).generate_latents(
        params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), video_length=frames,
        num_inference_steps=STEPS, guidance_scale=GUIDANCE, speeds=jnp.asarray(req["speeds"]),
        face_mask=jnp.asarray(req["mask"]), key=req["key"],
        lock_latents=None if lock_latents is None else jnp.asarray(lock_latents), num_locked=lock,
    ))


def port_latents(tcfg, params, req, frames, lock=0, batches=None):
    """The port's generate_latents with the reference's draws injected;
    `batches`, when given, collects the batch of each predict_noise call."""
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    if batches is not None:
        inner = pipe.model.predict_noise
        pipe.model.predict_noise = lambda lat, *a, **k: batches.append(lat.shape[0]) or inner(lat, *a, **k)
    return pipe.generate_latents(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=STEPS,
                                 guidance_scale=GUIDANCE, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]),
                                 latents=_t(req["latents"]), lock_latents=_t(req["lock_latents"]),
                                 num_locked=lock, lock_noise=_t(req["lock_noise"]))


def test_windowed_trajectory_matches_reference_at_any_group_size(monkeypatch):
    """T 7 > context 4: the windowed path, at G = 1 (11 calls of one window
    under CFG: batch 2) and G = 3 = all windows (4 calls: batch 6, 6, 6 and
    4 at the step with 2 real windows)."""
    jm, params, tcfg = model_params("tiny")
    jcfg, tcfg = windowed(jm.config), windowed(tcfg)
    req = inputs(tcfg, 7)
    want = reference_latents(jcfg, params, req, 7)
    calls_one, calls_all = [], []
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 1)
    one = port_latents(tcfg, params, req, 7, batches=calls_one)
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 3)
    every = port_latents(tcfg, params, req, 7, batches=calls_all)
    assert calls_one == [2] * 11 and calls_all == [6, 6, 6, 4]
    assert one.shape == want.shape == latent_shape(tcfg, 7)
    assert rel_err(one, want) <= TRAJ_TOL
    assert rel_err(every, want) <= TRAJ_TOL
    assert rel_err(one, every.numpy()) <= G_TOL
    assert rel_err(every, req["latents"]) > 0.1  # the latents moved


@pytest.mark.parametrize("frames,lock", [(7, 2), (3, 1)], ids=["windowed", "short"])
def test_locked_frames_match_reference(frames, lock):
    """lock_latents / num_locked: the locked frames re-noised from the known
    latents at every step with the reference's draws, in the windowed and
    the single-window sampler."""
    jm, params, tcfg = model_params("tiny")
    jcfg, tcfg = windowed(jm.config), windowed(tcfg)
    req = inputs(tcfg, frames, lock=lock, seed=3)
    want = reference_latents(jcfg, params, req, frames, lock=lock)
    assert rel_err(port_latents(tcfg, params, req, frames, lock=lock), want) <= TRAJ_TOL


def test_lock_noise_comes_from_the_generator():
    """Without lock_noise= the re-noise is drawn from the caller's generator:
    after the initial latents, one draw of the lock shape per step (eta 0)."""
    jm, params, tcfg = model_params("tiny")
    req = request(tcfg, 2, seed=2)
    shape = latent_shape(tcfg, 2)
    lock = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    kw = dict(video_length=2, num_inference_steps=2, guidance_scale=2.0, lock_latents=lock, num_locked=1)
    a = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), generator=torch.Generator().manual_seed(7), **kw)
    gen = torch.Generator().manual_seed(7)
    latents = torch.randn(shape, generator=gen)
    noise = torch.stack([torch.randn(shape, generator=gen) for _ in range(2)])
    b = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), latents=latents, lock_noise=noise, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launches_per_windowed_request_match_the_code(monkeypatch):
    """chip_smoke.py's exact counts for a clip longer than one window: the
    reader's calls from the window plan and WINDOWS_PER_CALL (T 7, 2 steps
    of 3 windows in groups of 2: 4 calls), then the calls that take each
    attention kernel's route (the cutoff lowered to the reader's sites) and
    the fused FF sub-layers of one request, counted."""
    import chip_smoke
    from emox_torch.nn import attention_blocks
    from tests.test_torch_512 import _count_routes

    steps, frames = 2, 7
    _, params, tcfg = model_params("tiny")
    tcfg = windowed(tcfg)
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 2)
    attn = _count_routes(monkeypatch, cutoff=128)
    ff = []
    inner = attention_blocks.fused_ln_geglu_ff
    monkeypatch.setattr(attention_blocks, "fused_ln_geglu_ff", lambda *a, **k: ff.append(1) or inner(*a, **k))
    req = request(tcfg, frames, seed=11)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    video = pipe(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=steps,
                 guidance_scale=2.0, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]))
    assert video.shape == (1, frames, IMAGE, IMAGE, 3) and bool(video.isfinite().all())
    calls = chip_smoke.reader_calls(tcfg, steps, frames)
    assert calls == 4 and chip_smoke.reader_calls(tcfg, steps, 4) == steps
    assert attn == chip_smoke.attn_launches_per_request(tcfg, calls)
    assert sum(attn.values()) == 4 * calls + 2  # 4 reader sites a call, the VAE's encode and decode
    assert len(ff) == chip_smoke.ff_launches_per_request(tcfg, calls)


def test_windowed_batch_of_two_folds_window_major(monkeypatch):
    """B = 2 requests in one windowed call: each row equals its own B = 1
    run, at G = 1 and G = 3 (the folded batch is window-major, and every
    per-clip tensor is repeated in that order)."""
    _, params, tcfg = model_params("tiny")
    tcfg = windowed(tcfg)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    reqs = [inputs(tcfg, 7, seed=s) for s in (12, 13)]
    both = {k: np.concatenate([r[k] for r in reqs]) for k in ("image", "wav", "speeds", "mask", "latents")}

    def run(req):
        return pipe.generate_latents(_t(req["image"]), _t(req["wav"]), video_length=7, num_inference_steps=STEPS,
                                     guidance_scale=GUIDANCE, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]),
                                     latents=_t(req["latents"]))

    for g in (1, 3):
        monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", g)
        got = run(both)
        for b, req in enumerate(reqs):
            assert rel_err(got[b:b + 1], run(req).numpy()) <= G_TOL
