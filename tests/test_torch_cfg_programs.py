"""The port's two-call CFG program, latent interpolation and DDIM inversion
against the reference's EMOPipeline.

Tiny preset, float32, eta 0, the reference's jax.random initial latents
handed to the port:
  * inference.cfg_batching=False: the cond call with the reference, the
    uncond call with ref_latent=None (no writer) and zeroed audio, on a
    single window (T 3) and on the windowed sampler (T 7, context 4,
    overlap 1: each group of windows makes two calls);
  * __call__ with interpolation_factor=2 (latent slerp, 3 -> 5 decoded frames);
  * invert: a 3-frame clip into the noise space, 4 steps.
Each is held to <= 1e-5 relative L2.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models.emo import EMOModel as JEMOModel
from emox_torch.infer import pipeline as tpipeline
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_windowed import (STEPS, GUIDANCE, _t, inputs, port_latents, reference_latents, request,
                                       windowed)

TRAJ_TOL = 1e-5


@pytest.mark.parametrize("frames", [3, 7], ids=["short", "windowed"])
def test_two_call_cfg_matches_reference(frames, monkeypatch):
    jm, params, tcfg = model_params("tiny")
    two_call = dict(cfg_batching=False)
    jcfg, tcfg = windowed(jm.config, **two_call), windowed(tcfg, **two_call)
    req = inputs(tcfg, frames, seed=5)
    want = reference_latents(jcfg, params, req, frames)
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 2)
    refs = []
    got = port_latents(tcfg, params, req, frames, batches=refs)
    # one cond and one uncond call per window group (3 windows in groups of
    # 2 and 1; at step 3, 2 windows in one group)
    calls = 2 * STEPS if frames == 3 else 2 * (2 + 2 + 2 + 1)
    assert len(refs) == calls
    assert rel_err(got, want) <= TRAJ_TOL
    # without AdaIN the batched program's masked reference tokens are the
    # same function as no reference branch: both programs agree
    batched = port_latents(windowed(model_params("tiny")[2]), params, req, frames)
    assert rel_err(batched, got) <= TRAJ_TOL


def test_interpolation_factor_matches_reference():
    """__call__ with interpolation_factor=2: 3 denoised latent frames, slerp
    to 5, VAE-decoded."""
    frames, factor = 3, 2
    jm, params, tcfg = model_params("tiny")
    req = request(tcfg, frames, seed=6)
    key = jax.random.PRNGKey(6)
    want = JEMOPipeline(jm)(params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), video_length=frames,
                            num_inference_steps=STEPS, guidance_scale=GUIDANCE, speeds=jnp.asarray(req["speeds"]),
                            face_mask=jnp.asarray(req["mask"]), key=key, interpolation_factor=factor)
    lat = IMAGE // tcfg.vae.downscale
    latents = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, frames, lat, lat, 4)))
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params))
    got = pipe(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=STEPS,
               guidance_scale=GUIDANCE, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]), latents=_t(latents),
               interpolation_factor=factor)
    assert got.shape == want.shape == (1, (frames - 1) * factor + 1, IMAGE, IMAGE, 3)
    assert rel_err(got, want) <= TRAJ_TOL


def test_invert_matches_reference():
    """DDIM inversion of a 3-frame clip, 4 steps: the writer runs at every
    step, no CFG, no speeds, no face mask; then sampling back from the
    inverted latents runs."""
    frames, steps = 3, 4
    jm, params, tcfg = model_params("tiny")
    req = request(tcfg, frames, seed=7)
    video = np.random.default_rng(8).uniform(-1, 1, (1, frames, IMAGE, IMAGE, 3)).astype(np.float32)
    want = JEMOPipeline(jm).invert(params, jnp.asarray(video), jnp.asarray(req["image"]), jnp.asarray(req["wav"]),
                                   num_inference_steps=steps)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params))
    got = pipe.invert(_t(video), _t(req["image"]), _t(req["wav"]), num_inference_steps=steps)
    assert got.shape == want.shape == (1, frames, IMAGE // tcfg.vae.downscale, IMAGE // tcfg.vae.downscale, 4)
    assert rel_err(got, want) <= TRAJ_TOL
    back = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=steps,
                                 guidance_scale=1.0, latents=got)
    assert back.shape == got.shape and bool(back.isfinite().all())


def test_use_gn_ref_tree_bridges_unchanged():
    """AdaIN has no parameters: a use_gn_ref=True model's param tree is the
    plain one, and the port loads it as it is (every leaf mapped)."""
    jm, params, tcfg = model_params("tiny")
    gn = dataclasses.replace(jm.config.model, use_gn_ref=True)
    shapes = jax.eval_shape(lambda k: JEMOModel(jm.config.replace(model=gn)).init_params(k, num_frames=2,
                                                                                        image_size=IMAGE),
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(shapes), jax.tree.leaves(params)))
    tcfg_gn = tcfg.replace(model=dataclasses.replace(tcfg.model, use_gn_ref=True))
    EMOModel(tcfg_gn, device="cpu").load_flax(params)
