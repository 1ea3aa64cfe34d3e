"""The port's sampling functions against the reference's: the context-window
plan, the windowed DDIM loop, DDIM inversion, the DDPM step, latent
interpolation and video IO.

The window plan is held index for index and weight for weight (or both
raise the same error) over a grid of steps, frame counts, context
sizes, strides, overlaps and closed loops. The samplers run a toy denoise
function that depends on the latents, the timestep and, per window, the
frame indices; they, ddpm_step with the reference's jax.random noise and
the interpolations (the near-parallel lerp branch included) are held to
<= 1e-6 relative L2.
"""

from __future__ import annotations

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.core.config import DiffusionConfig as JDiffusionConfig
from emox.diffusion import context as jcontext
from emox.diffusion import interp as jinterp
from emox.diffusion import sampler as jsampler
from emox.diffusion import schedule as jsched
from emox.infer import video_io as jvideo_io
from emox_torch.core.config import DiffusionConfig
from emox_torch.diffusion import context as tcontext
from emox_torch.diffusion import interp as tinterp
from emox_torch.diffusion import sampler as tsampler
from emox_torch.diffusion import schedule as tsched
from emox_torch.infer import video_io as tvideo_io
from tests.test_torch_bridge import no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)

FN_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_ordered_halving():
    for v in range(300):
        assert tcontext.ordered_halving(v) == jcontext.ordered_halving(v)
    assert [tcontext.ordered_halving(v, 3) for v in range(4)] == [0.0, 0.5, 0.25, 0.75]


@pytest.mark.parametrize("num_frames", [4, 7, 16, 17, 48, 125])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("closed_loop", [True, False], ids=["closed", "open"])
def test_window_plan_equals_reference(num_frames, stride, closed_loop):
    for steps, (context, overlap) in itertools.product((1, 4, 10), ((4, 0), (4, 1), (4, 3), (4, 4), (16, 0),
                                                                    (16, 4), (16, 8))):
        kw = dict(context_size=context, context_stride=stride, context_overlap=overlap, closed_loop=closed_loop)
        try:
            want = jcontext.window_plan(steps, num_frames, **kw)
        except (AssertionError, ValueError) as e:  # a frame left uncovered; a hop of 0 frames
            with pytest.raises(type(e), match=re.escape(str(e))):
                tcontext.window_plan(steps, num_frames, **kw)
            continue
        got = tcontext.window_plan(steps, num_frames, **kw)
        assert got.indices.dtype == np.int32 and got.weights.dtype == np.float32
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.weights, want.weights)
        assert (got.num_steps, got.max_windows, got.context_size) == (want.num_steps, want.max_windows,
                                                                      want.context_size)


def test_window_plan_wraps_and_pads():
    """T 6, context 4, overlap 1: the windows wrap around the clip; T 7 at 4
    steps has a padding row (weight 0, window 0 repeated) at step 3."""
    plan = tcontext.window_plan(1, 6, 4, 1, 1)
    assert plan.indices[0].tolist() == [[0, 1, 2, 3], [3, 4, 5, 0]]
    plan = tcontext.window_plan(4, 7, 4, 1, 1)
    assert plan.weights.tolist() == [[1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 0]]
    np.testing.assert_array_equal(plan.indices[3, 2], plan.indices[3, 0])


def _scheds(**kw):
    return jsched.make_schedule(JDiffusionConfig(**kw)), tsched.make_schedule(DiffusionConfig(**kw))


def _toy(rng, c):
    w = (rng.standard_normal((c, c)) * 0.3).astype(np.float32)
    jfn = lambda lat, tb: jnp.tanh(lat @ w) + tb.reshape(-1, *(1,) * (lat.ndim - 1)) / 1000.0
    tfn = lambda lat, tb: torch.tanh(lat @ _t(w)) + tb.reshape(-1, *(1,) * (lat.dim() - 1)) / 1000.0
    return jfn, tfn


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_windowed_ddim_sample(eta):
    """T 7, context 4, overlap 1, 4 steps (a padding row at step 3), batch 2;
    the toy output of a window depends on its frames' indices. With eta > 0
    the reference's noise is replaced by the generator's in both (the noise
    added at each step is checked in test_torch_pipeline)."""
    js, ts = _scheds()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 3, 4)).astype(np.float32)
    jtoy, ttoy = _toy(rng, 4)
    plan_j = jcontext.window_plan(4, 7, 4, 1, 1)
    plan_t = tcontext.window_plan(4, 7, 4, 1, 1)

    def jfn(windows, tb, idx):  # [W, B, c, h, w, C]
        return jax.vmap(lambda wl: jtoy(wl, tb))(windows) + 0.01 * idx[:, None, :, None, None, None]

    def tfn(windows, tb, idx):
        return torch.stack([ttoy(wl, tb) for wl in windows]) + 0.01 * idx[:, None, :, None, None, None]

    if eta == 0:
        want = jsampler.windowed_ddim_sample(jfn, jnp.asarray(x), js, plan_j)
        got = tsampler.windowed_ddim_sample(tfn, _t(x), ts, plan_t)
        assert rel_err(got, want) <= FN_TOL
        return
    # eta > 0: the same generator draws in the port as one step at a time
    gen = torch.Generator().manual_seed(3)
    got = tsampler.windowed_ddim_sample(tfn, _t(x), ts, plan_t, eta=eta, generator=gen)
    gen = torch.Generator().manual_seed(3)
    lat = _t(x)
    steps = tsched.inference_timesteps(1000, 4).tolist()
    for i, (t, t_prev) in enumerate(zip(steps, steps[1:] + [-1])):
        tb = torch.full((2,), t)
        out = tsampler.windowed_model_out(tfn, lat, tb, plan_t.indices[i], plan_t.weights[i])
        lat = tsched.ddim_step(ts, out, lat, tb, torch.full((2,), t_prev), eta=eta, generator=gen)
    torch.testing.assert_close(got, lat, rtol=0, atol=0)


def test_windowed_model_out_skips_padding_rows():
    """A padding row (weight 0) is never denoised, and the average is the
    reference's scatter-add over all rows divided by the weighted counts."""
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 7, 2, 2, 4)).astype(np.float32)
    plan = tcontext.window_plan(4, 7, 4, 1, 1)
    seen = []

    def fn(windows, tb, idx):
        seen.append(idx.tolist())
        return windows * 2.0 + idx[:, None, :, None, None, None].to(windows.dtype)

    out = tsampler.windowed_model_out(fn, _t(lat), torch.zeros(1), plan.indices[3], plan.weights[3])
    assert seen == [plan.indices[3, :2].tolist()]
    idx, w8 = plan.indices[3], plan.weights[3]
    preds = (lat[:, idx] * 2.0 + idx[None, :, :, None, None, None]) * w8[None, :, None, None, None, None]
    nsum = np.zeros_like(lat)
    np.add.at(nsum, (slice(None), idx.reshape(-1)), preds.reshape(1, -1, 2, 2, 4))
    counts = np.zeros(7, np.float32)
    np.add.at(counts, idx.reshape(-1), np.repeat(w8, 4))
    assert rel_err(out, nsum / np.maximum(counts, 1e-6)[None, :, None, None, None]) <= FN_TOL


@pytest.mark.parametrize("steps", [1, 2, 5, 10])
def test_ddim_invert(steps):
    js, ts = _scheds()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 2, 2, 4)).astype(np.float32)
    jfn, tfn = _toy(rng, 4)
    want = jsampler.ddim_invert(jfn, jnp.asarray(x), js, steps)
    assert rel_err(tsampler.ddim_invert(tfn, _t(x), ts, steps), want) <= FN_TOL


@pytest.mark.parametrize("kw", [dict(), dict(zero_terminal_snr=True, prediction_type="v_prediction")],
                         ids=["epsilon", "v_prediction"])
@pytest.mark.parametrize("clip_x0", [True, False])
def test_ddpm_step_with_reference_noise(kw, clip_x0):
    """Batched t including 0 (no noise there); the reference's jax.random
    noise handed to the port as noise=. Both read the reference's tables
    (the zero-terminal-SNR betas differ by up to 2e-5 between the two
    packages' float32 rescales, test_torch_pipeline.test_make_schedule)."""
    js = jsched.make_schedule(JDiffusionConfig(**kw))
    ts = tsched.Schedule(_t(js.betas), _t(js.alphas_cumprod), js.num_train_timesteps, js.prediction_type)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2, 3, 3, 4)).astype(np.float32)
    out = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 500, 1, 0], np.int32)
    key = jax.random.PRNGKey(5)
    want = jsched.ddpm_step(js, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), key, clip_x0=clip_x0)
    noise = np.asarray(jax.random.normal(key, x.shape))
    got = tsched.ddpm_step(ts, _t(out), _t(x), _t(t).long(), clip_x0=clip_x0, noise=_t(noise))
    assert rel_err(got, want) <= FN_TOL
    # from a generator: the same as its next normal draw handed in
    a = tsched.ddpm_step(ts, _t(out), _t(x), _t(t).long(), generator=torch.Generator().manual_seed(4))
    b = tsched.ddpm_step(ts, _t(out), _t(x), _t(t).long(),
                         noise=torch.randn(x.shape, generator=torch.Generator().manual_seed(4)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        tsched.ddpm_step(ts, _t(out), _t(x), _t(t).long())


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.9])
def test_lerp_and_slerp(t):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 2, 3, 4, 4)).astype(np.float32)
    assert rel_err(tinterp.lerp_latents(_t(a), _t(b), t), jinterp.lerp_latents(a, b, t)) <= FN_TOL
    assert rel_err(tinterp.slerp_latents(_t(a), _t(b), t), jinterp.slerp_latents(jnp.asarray(a), jnp.asarray(b), t)) <= FN_TOL
    # nearly parallel (|cos| > 0.9995): the lerp branch
    c = a + 1e-3 * b
    want = jinterp.slerp_latents(jnp.asarray(a), jnp.asarray(c), t)
    got = tinterp.slerp_latents(_t(a), _t(c), t)
    assert rel_err(got, want) <= FN_TOL
    assert rel_err(got, (1 - t) * a + t * c) <= FN_TOL


@pytest.mark.parametrize("factor,mode", [(1, "slerp"), (2, "slerp"), (3, "slerp"), (3, "lerp")])
def test_interpolate_latents(factor, mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 3, 3, 4)).astype(np.float32)
    x[:, 2] = x[:, 1] * 1.0001  # one near-parallel pair
    want = jinterp.interpolate_latents(jnp.asarray(x), factor, mode=mode)
    got = tinterp.interpolate_latents(_t(x), factor, mode=mode)
    assert got.shape == want.shape == (2, 3 * factor + 1, 3, 3, 4)
    assert rel_err(got, want) <= FN_TOL


def test_video_io_matches_reference(tmp_path):
    rng = np.random.default_rng(6)
    videos = rng.uniform(-1.2, 1.2, (3, 2, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvideo_io.frames_to_uint8(videos), jvideo_io.frames_to_uint8(videos))
    for cols in (1, 2, 6):
        np.testing.assert_array_equal(tvideo_io.tile_video_grid(videos, n_cols=cols),
                                      jvideo_io.tile_video_grid(videos, n_cols=cols))
    with pytest.raises(ValueError):
        tvideo_io.tile_video_grid(videos[0])
    path = tvideo_io.save_video(videos[0], str(tmp_path / "clip.npz"), fps=12.5)
    saved = np.load(path)
    np.testing.assert_array_equal(saved["frames"], jvideo_io.frames_to_uint8(videos[0]))
    assert float(saved["fps"]) == 12.5
    wav = rng.uniform(-1.1, 1.1, 800)
    tvideo_io._write_wav(str(tmp_path / "a.wav"), wav, 16000)
    jvideo_io._write_wav(str(tmp_path / "b.wav"), wav, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
