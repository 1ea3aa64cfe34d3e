"""The port's autoregressive long-video generation against the reference's
EMOPipeline.generate_long.

Tiny preset, float32: 9 frames in segments of 4 with 1 motion frame
(segments of 4, 4 and 3 frames: the wav sliced at int(frame / fps * sr),
the wav and the speeds a frame short of the clip and zero-padded), CFG 2.0
batched, eta 0, 3 DDIM steps, with speeds and a face mask. The reference
draws each segment's initial latents and its locked frame's re-noise from
jax.random (a key split per segment, pipeline.py:521); the test rebuilds
them and hands them to the port. The decoded video is held to <= 1e-5
relative L2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_windowed import _t, jax_draws, latent_shape, request

TRAJ_TOL = 1e-5


def test_generate_long_matches_reference():
    total, segment, motion, steps, guidance = 9, 4, 1, 3, 2.0
    jm, params, tcfg = model_params("tiny")
    # the wav and the speeds end a frame short of the clip: both are zero-padded
    req = request(tcfg, total, seed=4, total_audio_frames=total - 5)
    req["speeds"] = req["speeds"][:, :total - 1]
    key = jax.random.PRNGKey(4)
    want = JEMOPipeline(jm).generate_long(
        params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), total, segment_length=segment,
        num_motion_frames=motion, num_inference_steps=steps, guidance_scale=guidance, key=key,
        speeds=jnp.asarray(req["speeds"]), face_mask=jnp.asarray(req["mask"]),
    )
    latents, lock_noise = [], []
    for seg, frames in enumerate((4, 4, 3)):
        key, sub = jax.random.split(key)
        shape = latent_shape(tcfg, frames)
        lat, noise = jax_draws(sub, shape, steps, None if seg == 0 else shape)
        latents.append(_t(lat))
        lock_noise.append(None if noise is None else _t(noise))
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params))
    segments = []
    inner = pipe.generate_latents
    pipe.generate_latents = lambda *a, **k: segments.append((k["video_length"], k["num_locked"],
                                                              tuple(a[1].shape))) or inner(*a, **k)
    got = pipe.generate_long(_t(req["image"]), _t(req["wav"]), total, segment_length=segment,
                             num_motion_frames=motion, num_inference_steps=steps, guidance_scale=guidance,
                             speeds=_t(req["speeds"]), face_mask=_t(req["mask"]), latents=latents,
                             lock_noise=lock_noise)
    sr, fps = tcfg.audio.sample_rate, tcfg.audio.video_fps
    assert segments == [(4, 0, (1, int(4 / fps * sr))), (4, 1, (1, int(7 / fps * sr) - int(3 / fps * sr))),
                        (3, 1, (1, int(9 / fps * sr) - int(6 / fps * sr)))]
    assert got.shape == want.shape == (1, total, IMAGE, IMAGE, 3)
    assert rel_err(got, want) <= TRAJ_TOL
