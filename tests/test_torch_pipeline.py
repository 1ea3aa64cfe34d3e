"""The port's diffusion functions and serving pipeline against the reference's.

Schedules, DDIM steps and the sampler are held to <= 1e-6 relative L2
(float32 arithmetic on both sides). The serving path is held end to end:
a 3-step CFG-batched DDIM trajectory (eta 0) from the same injected initial
latents, followed by the VAE decode, <= 1e-5 relative L2 on the latents and
on the video (measured 1.2e-6). The reference's initial noise comes from jax.random, which
torch cannot reproduce, so its side is driven through
EMOPipeline._model_out and ddim_step in a loop from those latents.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.core.config import DiffusionConfig as JDiffusionConfig
from emox.diffusion import sampler as jsampler
from emox.diffusion import schedule as jsched
from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox_torch.core.config import DiffusionConfig
from emox_torch.diffusion import sampler as tsampler
from emox_torch.diffusion import schedule as tsched
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)

FN_TOL = 1e-6
TRAJ_TOL = 1e-5
LATENT_MSE_BAR = 1e-2  # BASELINE.json's bar for a latent trajectory


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


SCHEDULES = [
    dict(),
    dict(beta_schedule="linear", beta_start=1e-4, beta_end=0.02),
    dict(beta_schedule="squaredcos_cap_v2"),
    dict(zero_terminal_snr=True, prediction_type="v_prediction"),
]


def _scheds(kw):
    return jsched.make_schedule(JDiffusionConfig(**kw)), tsched.make_schedule(DiffusionConfig(**kw))


@pytest.mark.parametrize("kw", SCHEDULES, ids=["scaled_linear", "linear", "cosine", "zero_snr_v"])
def test_make_schedule(kw):
    """The zero-terminal-SNR rescale subtracts two close square roots (the
    last alphas_cumprod are ~1e-7), so float32 rounding in another order
    moves the tail betas by up to ~1e-5 relative; 2e-5 there, 1e-6 elsewhere."""
    js, ts = _scheds(kw)
    tol = 2e-5 if kw.get("zero_terminal_snr") else FN_TOL
    assert ts.num_train_timesteps == js.num_train_timesteps
    assert ts.prediction_type == js.prediction_type
    assert rel_err(ts.betas, js.betas) <= tol
    assert rel_err(ts.alphas_cumprod, js.alphas_cumprod) <= FN_TOL


@pytest.mark.parametrize("steps", [1, 3, 10, 7, 50])
def test_inference_timesteps(steps):
    want = np.asarray(jsched.inference_timesteps(1000, steps))
    got = tsched.inference_timesteps(1000, steps)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [SCHEDULES[0], SCHEDULES[3]], ids=["epsilon", "v_prediction"])
@pytest.mark.parametrize("clip_x0", [False, True])
def test_ddim_step_eta0(kw, clip_x0):
    """Batched steps including the final one (t_prev = -1)."""
    js, ts = _scheds(kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
    out = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 500, 20], np.int32)
    t_prev = np.array([899, 400, -1], np.int32)
    want = jsched.ddim_step(js, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), jnp.asarray(t_prev),
                            clip_x0=clip_x0)
    got = tsched.ddim_step(ts, _t(out), _t(x), _t(t).long(), _t(t_prev).long(), clip_x0=clip_x0)
    assert rel_err(got, want) <= FN_TOL


def test_ddim_step_eta_draws_from_generator():
    """eta > 0: the deterministic part matches the reference, and the added
    noise is sigma times the generator's next normal draw."""
    js, ts = _scheds({})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 4, 4, 4)).astype(np.float32)
    out = rng.standard_normal(x.shape).astype(np.float32)
    t, t_prev, eta = np.array([700, 300]), np.array([600, 200]), 0.7
    key = jax.random.PRNGKey(3)
    want = jsched.ddim_step(js, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), jnp.asarray(t_prev),
                            eta=eta, key=key)
    acp = np.asarray(js.alphas_cumprod, np.float64)
    var = (1 - acp[t_prev]) / (1 - acp[t]) * (1 - acp[t] / acp[t_prev])
    sigma = (eta * np.sqrt(var)).reshape(-1, 1, 1, 1, 1)
    deterministic = np.asarray(want) - sigma * np.asarray(jax.random.normal(key, x.shape))
    got = tsched.ddim_step(ts, _t(out), _t(x), _t(t), _t(t_prev), eta=eta,
                           generator=torch.Generator().manual_seed(5))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).numpy()
    assert rel_err(got, deterministic + sigma * noise) <= FN_TOL
    with pytest.raises(ValueError, match="Generator"):
        tsched.ddim_step(ts, _t(out), _t(x), _t(t), _t(t_prev), eta=eta)


def test_add_noise_and_pred_to_x0():
    for kw in (SCHEDULES[0], SCHEDULES[3]):
        js, ts = _scheds(kw)
        rng = np.random.default_rng(2)
        x0, noise = (rng.standard_normal((3, 2, 4)).astype(np.float32) for _ in range(2))
        t = np.array([0, 480, 999])
        want = jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        assert rel_err(tsched.add_noise(ts, _t(x0), _t(noise), _t(t)), want) <= FN_TOL
        for w, g in zip(jsched.pred_to_x0(js, jnp.asarray(noise), want, jnp.asarray(t)),
                        tsched.pred_to_x0(ts, _t(noise), _t(want), _t(t))):
            assert rel_err(g, w) <= 1e-5  # x0 divides by sqrt(acp), small at t=999


def test_ddim_sample_and_cfg_combine():
    """The sampler loop with a denoiser that depends on x and t."""
    js, ts = _scheds({})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.3
    jfn = lambda lat, tb: jnp.tanh(lat @ w) + tb[:, None, None] / 1000.0
    tfn = lambda lat, tb: torch.tanh(lat @ _t(w)) + tb[:, None, None] / 1000.0
    want = jsampler.ddim_sample(jfn, jnp.asarray(x), js, 5)
    assert rel_err(tsampler.ddim_sample(tfn, _t(x), ts, 5), want) <= 1e-5
    u, c = rng.standard_normal((2, 5)).astype(np.float32)
    assert rel_err(tsampler.cfg_combine(_t(u), _t(c), 7.5), jsampler.cfg_combine(u, c, 7.5)) <= FN_TOL


# ---- the serving path -------------------------------------------------------------
def _request(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lat = IMAGE // cfg.vae.downscale
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    axes = cfg.model.speed_axes
    return dict(
        image=rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
        wav=(0.1 * rng.standard_normal((1, 16000 * (FRAMES + 4) // 25))).astype(np.float32),
        speeds=rng.uniform(-1, 1, (1, FRAMES) + ((axes,) if axes > 1 else ())).astype(np.float32),
        mask=((((yy - IMAGE / 2) ** 2 + (xx - IMAGE / 2) ** 2) < (IMAGE / 3) ** 2)
              .astype(np.float32)[None, :, :, None]),
        latents=rng.standard_normal((1, FRAMES, lat, lat, cfg.model.in_channels)).astype(np.float32),
    )


def _reference_trajectory(jm, params, req, steps, guidance):
    """The reference's _sample_short, step by step, from injected latents."""
    pipe = JEMOPipeline(jm)
    ref, audio = pipe._prepare(params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), FRAMES)
    face = jm.encode_face_mask(params, jnp.asarray(req["mask"]), ref.shape[1])
    ts = jsched.inference_timesteps(pipe.sched.num_train_timesteps, steps)
    feats, _ = pipe._precompute_banks(params, ref, ts)
    ts = [int(t) for t in ts]
    lat = jnp.asarray(req["latents"])
    for i, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        rf = jax.tree.map(lambda x: x[i], feats)
        out = pipe._model_out(params, lat, jnp.full((1,), t, jnp.int32), ref, audio, jnp.asarray(req["speeds"]),
                              face, guidance, ref_features=rf)
        lat = jsched.ddim_step(pipe.sched, out, lat, jnp.full((1,), t, jnp.int32), jnp.full((1,), t_prev, jnp.int32))
    return lat, jm.decode_latents(params, lat)


def test_cfg_trajectory_and_decode_match_reference():
    steps, guidance = 3, 3.5
    jm, params, tcfg = model_params("tiny")
    req = _request(jm.config)
    want_lat, want_video = _reference_trajectory(jm, params, req, steps, guidance)

    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params))
    kw = dict(video_length=FRAMES, num_inference_steps=steps, guidance_scale=guidance,
              speeds=_t(req["speeds"]), face_mask=_t(req["mask"]), latents=_t(req["latents"]))
    got_lat = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), **kw)
    timings = {}
    got_video = pipe(_t(req["image"]), _t(req["wav"]), timings=timings, **kw)
    assert got_video.shape == want_video.shape == (1, FRAMES, IMAGE, IMAGE, 3)
    assert rel_err(got_lat, want_lat) <= TRAJ_TOL
    assert float(np.mean((got_lat.numpy() - np.asarray(want_lat)) ** 2)) < 1e-6 * LATENT_MSE_BAR
    assert rel_err(got_video, want_video) <= TRAJ_TOL
    assert set(timings) == {"prepare_s", "face_mask_s", "ref_banks_s", "denoise_s", "decode_s"}
    # the latents really moved: three steps of a guided model, not a copy
    assert rel_err(got_lat, req["latents"]) > 0.1


def test_initial_latents_come_from_the_generator():
    """Without latents=, the sampler draws them from the caller's
    generator: the same seed gives the same video, and the draw equals
    torch.randn of the latent shape."""
    jm, params, tcfg = model_params("tiny")
    req = _request(jm.config, seed=1)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params))
    args = (_t(req["image"]), _t(req["wav"]))
    kw = dict(video_length=FRAMES, num_inference_steps=2, guidance_scale=2.0)
    a = pipe.generate_latents(*args, generator=torch.Generator().manual_seed(7), **kw)
    b = pipe.generate_latents(*args, latents=torch.randn(req["latents"].shape,
                                                         generator=torch.Generator().manual_seed(7)), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_out_of_slice_options_raise():
    """The options the port still leaves out raise NotImplementedError and
    name their ROADMAP item: the CLIP vision encoder and the model options
    of later slices. (The windowed sampler, the two-call CFG program, latent
    interpolation and use_gn_ref run: tests/test_torch_windowed.py,
    test_torch_cfg_programs.py, test_torch_adain.py.)"""
    _, _, tcfg = model_params("tiny")
    vision = tcfg.replace(clip=dataclasses.replace(tcfg.clip, vision_enabled=True))
    with pytest.raises(NotImplementedError, match="vision.*ROADMAP"):
        EMOModel(vision, device="cpu")
    for field in ("use_controlnet", "use_identity_embed", "use_sparse_causal", "separable_convs"):
        bad = tcfg.replace(model=dataclasses.replace(tcfg.model, **{field: True}))
        with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP"):
            EMOModel(bad, device="cpu")
