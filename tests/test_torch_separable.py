"""Separable ResBlock convs (model.separable_convs) against the reference, on the CPU.

Each 3x3 conv of a ResBlock becomes `{name}_dw`, a depthwise 3x3 with bias
(flax kernel [3, 3, 1, C]), followed by `{name}_pw`, a 1x1 to the output
width; the flag reaches every ResBlock of the writer, the denoiser and the
ControlNet (the VAE has none). One seeded flax param tree carried into both
packages, float32, <= 1e-5 relative L2:

  * ResBlock in both time-embedding modes, with and without the 1x1 skip;
    the bridge's HWIO -> OIHW mapping of a depthwise kernel;
  * predict_noise of the tiny preset, and the side models' (the ControlNet
    on per-frame control renders, the identity embedding);
  * the ControlNet's residuals, and a CFG trajectory through the
    reference's own EMOPipeline, its draws injected.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models import controlnet as jcn
from emox.models.emo import EMOModel as JEMOModel
from emox.nn import blocks as jblocks
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.interop.from_flax import state_dict_from_flax
from emox_torch.models.emo import EMOModel
from emox_torch.nn import blocks as tblocks
from tests.test_torch_bridge import (FRAMES, IMAGE, configs, flax_module_params,  # noqa: F401 (autouse fixture)
                                     no_kernel_launches, random_flax_params, rel_err, torch_module)
from tests.test_torch_windowed import GUIDANCE, STEPS, jax_draws, request

TOL = 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def sep_models(name: str):
    """(reference EMOModel, its param tree, port EMOModel) of a preset of
    tests/test_torch_bridge.py ('tiny', 'tiny_side') with separable convs,
    the tree at the reference's own shapes."""
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, separable_convs=True)) for c in configs(name))
    jm = JEMOModel(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init_params(k, num_frames=FRAMES, image_size=IMAGE), jax.random.PRNGKey(0))
    params = random_flax_params(shapes, seed=3)
    return jm, params, EMOModel(tcfg, device="cpu").load_flax(params)


@pytest.mark.parametrize("temb_mode,cin", [("scale_shift", 8), ("scale_shift", 16), ("add", 8)],
                         ids=["scale_shift_skip", "scale_shift", "add_skip"])
def test_resblock_matches_the_reference(temb_mode, cin):
    rng = np.random.default_rng(1)
    b, t = 2, 3
    x = rng.standard_normal((b, t, 6, 6, cin)).astype(np.float32)
    te = rng.standard_normal((b, 12)).astype(np.float32)
    jmod = jblocks.ResBlock(16, groups=4, temb_mode=temb_mode, separable=True)
    params = flax_module_params(jmod, jnp.asarray(x), jnp.asarray(te), seed=2)
    assert {"conv1_dw", "conv1_pw", "conv2_dw", "conv2_pw"} <= set(params) and "conv1" not in params
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(te))
    tmod = torch_module(tblocks.ResBlock(cin, 16, groups=4, temb_dim=12, temb_mode=temb_mode, separable=True), params)
    with torch.no_grad():
        got = tmod(_t(x), _t(te))
    assert rel_err(got, want) <= TOL
    assert tmod.conv1_dw.groups == cin and tmod.conv2_dw.groups == 16


def test_depthwise_kernel_maps_hwio_to_oihw():
    """A flax depthwise kernel [3, 3, 1, C] lands on the port's [C, 1, 3, 3]
    with w[c, 0, i, j] = k[i, j, 0, c]; the pointwise [1, 1, C, O] on
    [O, C, 1, 1]."""
    rng = np.random.default_rng(4)
    dw = rng.standard_normal((3, 3, 1, 5)).astype(np.float32)
    pw = rng.standard_normal((1, 1, 5, 7)).astype(np.float32)
    sd = state_dict_from_flax({"conv1_dw": {"kernel": dw}, "conv1_pw": {"kernel": pw}})
    assert tuple(sd["conv1_dw.weight"].shape) == (5, 1, 3, 3)
    for c in range(5):
        np.testing.assert_array_equal(sd["conv1_dw.weight"][c, 0].numpy(), dw[:, :, 0, c])
    np.testing.assert_array_equal(sd["conv1_pw.weight"][:, :, 0, 0].numpy(), pw[0, 0].T)


def test_every_resblock_of_the_unets_is_separable():
    """The writer, the denoiser and the ControlNet: no full 3x3 conv is left
    in a ResBlock; the VAE's stay full."""
    _, params, tm = sep_models("tiny_side")
    for sub in ("reference_net", "denoiser", "controlnet"):
        blocks = [m for m in getattr(tm.modules, sub).modules() if isinstance(m, tblocks.ResBlock)]
        assert blocks and all(m.separable and not hasattr(m, "conv1") for m in blocks)
    vae = [m for m in tm.modules.vae.modules() if isinstance(m, tblocks.ResBlock)]
    assert vae and not any(m.separable for m in vae)


@pytest.mark.parametrize("name", ["tiny", "tiny_side"])
def test_predict_noise_matches_the_reference(name):
    """The denoiser (and with the side models the ControlNet on per-frame
    renders and the identity embedding), the reference dropped on one row."""
    jm, params, tm = sep_models(name)
    rng = np.random.default_rng(6)
    lat = IMAGE // jm.config.vae.downscale
    noisy = rng.standard_normal((2, FRAMES, lat, lat, 4)).astype(np.float32)
    ts = np.array([910, 80], np.int32)
    img = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jm.encode_images(params, jnp.asarray(img))
    drop = np.array([True, False])
    jkw, tkw = dict(ref_dropout=jnp.asarray(drop)), dict(ref_dropout=_t(drop))
    if name == "tiny_side":
        ctrl = rng.uniform(0, 1, (2, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32)
        ide = JEMOPipeline(jm).encode_identity(params, jnp.asarray(img))
        jkw.update(control_cond=jnp.asarray(ctrl), identity_embed=ide)
        tkw.update(control_cond=_t(ctrl), identity_embed=_t(ide))
    want = jm.predict_noise(params, jnp.asarray(noisy), jnp.asarray(ts), ref, **jkw)
    got = tm.predict_noise(_t(noisy), _t(ts).long(), _t(ref), **tkw)
    assert rel_err(got, want) <= TOL


def test_controlnet_residuals_match_the_reference():
    """Every residual of the separable ControlNet, per-frame control."""
    jm, params, tm = sep_models("tiny_side")
    rng = np.random.default_rng(7)
    lat = IMAGE // jm.config.vae.downscale
    x = rng.standard_normal((2, FRAMES, lat, lat, 4)).astype(np.float32)
    ts = np.array([300, 20], np.int32)
    cond = rng.uniform(0, 1, (2, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32)
    want = jcn.ControlNetEncoder(jm.config.model).apply({"params": params["controlnet"]}, jnp.asarray(x),
                                                        jnp.asarray(ts), jnp.asarray(cond))
    with torch.no_grad():
        got = tm.modules.controlnet(_t(x), _t(ts).long(), _t(cond))
    assert len(got.down) == len(want.down)
    for g, w in zip([*got.down, got.mid], [*want.down, want.mid]):
        assert rel_err(g, w) <= TOL


def test_cfg_trajectory_matches_the_reference():
    """generate_latents, batched CFG 2, 3 frames, the reference's draws."""
    jm, params, tm = sep_models("tiny")
    frames = 3
    req = request(tm.config, frames, seed=14)
    key = jax.random.PRNGKey(14)
    want = JEMOPipeline(jm).generate_latents(
        params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), video_length=frames, num_inference_steps=STEPS,
        guidance_scale=GUIDANCE, speeds=jnp.asarray(req["speeds"]), face_mask=jnp.asarray(req["mask"]), key=key)
    lat = IMAGE // tm.config.vae.downscale
    latents, _ = jax_draws(key, (1, frames, lat, lat, 4), STEPS)
    got = EMOPipeline(tm).generate_latents(_t(req["image"]), _t(req["wav"]), video_length=frames,
                                           num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                                           speeds=_t(req["speeds"]), face_mask=_t(req["mask"]), latents=_t(latents))
    assert rel_err(got, want) <= TOL
