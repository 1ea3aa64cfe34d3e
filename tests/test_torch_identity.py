"""The CLIP vision encoder and the identity embedding against the reference, on the CPU.

The side-model configuration of tests/test_torch_bridge.py ("tiny_side":
the tiny preset with the ControlNet, a CLIP vision encoder of 2 layers,
width 64, 4 heads, image 28, patch 14, projection 32, and
model.use_identity_embed) carries one seeded flax param tree into both
packages. float32, <= 1e-5 relative L2 unless stated:

  * CLIPVisionEncoder, projected and hidden states, under both activations;
    clip_normalize; EMOPipeline.encode_identity, whose resize shrinks the
    reference image to the CLIP input as jax.image.resize does;
  * predict_noise with an identity embedding through the (non-zero)
    projection, and a whole __call__ with use_identity=True, the
    reference's draws injected;
  * the stage-2 loss with the identity branch (<= 1e-5) and its gradients
    (<= 1e-4);
  * the port's own init: the zero-initialised projection makes the
    identity branch an exact no-op, bit for bit;
  * the errors: the identity embedding without the vision encoder, and
    encode_identity with the embedding off.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.core.config import CLIPConfig as JCLIPConfig
from emox.diffusion import schedule as jschedule
from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models import clip as jclip
from emox.models.emo import EMOModel as JEMOModel
from emox.train import stages as jstages
from emox_torch.core.config import CLIPConfig
from emox_torch.diffusion import schedule as tschedule
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.interop.from_flax import _convert
from emox_torch.models import clip as tclip
from emox_torch.models.emo import EMOModel
from emox_torch.nn.layers import resize_bilinear
from emox_torch.train import stage_loss_fn, trainable_mask
from tests.test_torch_bridge import (FRAMES, IMAGE, SIDE_CLIP, flax_module_params, model_params,  # noqa: F401
                                     no_kernel_launches, rel_err, torch_module)

TOL = 1e-5
GRAD_TOL = 1e-4


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def side_pair():
    """(reference EMOModel, its params, port EMOModel with those weights) of
    the side-model configuration."""
    jm, params, tcfg = model_params("tiny_side")
    return jm, params, EMOModel(tcfg, device="cpu", seed=1).load_flax(params)


def port_leaves(tree):
    """{port parameter name: leaf in the port's layout} of a param-shaped
    tree, every top-level submodel included."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        name, value = _convert(keys[1:], np.asarray(leaf))
        out[f"{keys[0]}.{name}"] = value
    return out


# ---- the encoder ---------------------------------------------------------------------
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("project", [True, False], ids=["projected", "hidden"])
def test_clip_vision_encoder_matches_the_reference(act, project):
    jcfg, tcfg = (C(**SIDE_CLIP, hidden_act=act) for C in (JCLIPConfig, CLIPConfig))
    images = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    jmod = jclip.CLIPVisionEncoder(jcfg)
    params = flax_module_params(jmod, jnp.asarray(images), seed=4)
    want = jmod.apply({"params": params}, jnp.asarray(images), project=project)
    got = torch_module(tclip.CLIPVisionEncoder(tcfg), params)(_t(images), project=project)
    assert got.shape == want.shape == ((2, 32) if project else (2, 1 + 2 * 2, 64))
    assert rel_err(got, want) <= TOL


def test_clip_normalize_matches_the_reference():
    x = np.random.default_rng(5).uniform(0, 1, (2, 7, 5, 3)).astype(np.float32)
    assert tclip.CLIP_IMAGE_MEAN == jclip.CLIP_IMAGE_MEAN and tclip.CLIP_IMAGE_STD == jclip.CLIP_IMAGE_STD
    assert rel_err(tclip.clip_normalize(_t(x)), jclip.clip_normalize(jnp.asarray(x))) <= 1e-6


@pytest.mark.parametrize("size", [28, 32, 64], ids=["same", "shrink", "shrink_2x"])
def test_encode_identity_matches_the_reference(size):
    """Reference images of 28 (no resize), 32 and 64 pixels into the
    28-pixel CLIP: the antialiased shrink as jax.image.resize makes it."""
    jm, params, tm = side_pair()
    img = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = JEMOPipeline(jm).encode_identity(params, jnp.asarray(img))
    got = EMOPipeline(tm).encode_identity(_t(img))
    assert got.shape == want.shape == (2, 32)
    assert rel_err(got, want) <= TOL


def test_resize_shrinks_256_to_224_as_jax_image_resize():
    """The shrink the flagship's reference image takes into CLIP-L (256 ->
    224), on one channel-light image."""
    x = np.random.default_rng(6).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 224, 224, 3), "bilinear")
    assert rel_err(resize_bilinear(_t(x), 224, 224), want) <= 1e-6


# ---- the denoiser and the pipeline ---------------------------------------------------------
def _inputs(cfg, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    lat = IMAGE // cfg.vae.downscale
    return dict(images=rng.uniform(-1, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32),
                noisy=rng.standard_normal((batch, FRAMES, lat, lat, cfg.model.in_channels)).astype(np.float32),
                timesteps=np.array([981, 321][:batch], np.int32))


def test_predict_noise_with_identity_matches_the_reference():
    """The identity embedding through the projection (non-zero in the
    seeded tree) into the time embedding, with the reference dropped on one
    row; it moves the output."""
    jm, params, tm = side_pair()
    x = _inputs(jm.config, seed=7)
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    ide = JEMOPipeline(jm).encode_identity(params, jnp.asarray(x["images"]))
    drop = np.array([True, False])
    want = jm.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref,
                            identity_embed=ide, ref_dropout=jnp.asarray(drop))
    ts = _t(x["timesteps"]).long()
    got = tm.predict_noise(_t(x["noisy"]), ts, _t(ref), identity_embed=_t(ide), ref_dropout=_t(drop))
    assert rel_err(got, want) <= TOL
    without = tm.predict_noise(_t(x["noisy"]), ts, _t(ref), ref_dropout=_t(drop))
    assert rel_err(without, want) > 100 * TOL


def test_call_with_use_identity_matches_the_reference():
    """EMOPipeline.__call__(use_identity=True): the embedding encoded once,
    the CFG uncond half's zeroed, 2 DDIM steps, decoded; the reference's
    initial latents injected."""
    jm, params, tm = side_pair()
    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    wav = (0.1 * rng.standard_normal((1, 16000 * (FRAMES + 4) // 25))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kw = dict(video_length=FRAMES, num_inference_steps=2, guidance_scale=2.0)
    want = JEMOPipeline(jm)(params, jnp.asarray(img), jnp.asarray(wav), key=key, use_identity=True, **kw)
    lat = IMAGE // jm.config.vae.downscale
    latents = np.asarray(jax.random.normal(jax.random.split(key)[0], (1, FRAMES, lat, lat, 4)))
    got = EMOPipeline(tm)(_t(img), _t(wav), latents=_t(latents), use_identity=True, **kw)
    assert got.shape == want.shape == (1, FRAMES, IMAGE, IMAGE, 3)
    assert rel_err(got, want) <= TOL
    plain = EMOPipeline(tm)(_t(img), _t(wav), latents=_t(latents), **kw)
    assert rel_err(plain, want) > 100 * TOL


# ---- training --------------------------------------------------------------------------
def side_loss_configs(stage: int):
    """Reference and port configs of the side models with the loss shaping
    on: min-SNR 5, noise offset 0.05, CFG dropout 0.5, float32."""
    jm, _, tcfg = model_params("tiny_side")
    diff = dict(snr_gamma=5.0, noise_offset=0.05)
    train = dict(stage=stage, uncond_ratio=0.5, compute_dtype="float32")
    return [cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, **diff),
                        train=dataclasses.replace(cfg.train, **train)) for cfg in (jm.config, tcfg)]


def reference_draws(jcfg, batch, key):
    """The reference denoise loss's random numbers, replayed from its key
    splits (emox/train/stages.py denoise_loss), as the port's draws."""
    k_enc, k_noise, k_t, k_off, k_drop = jax.random.split(key, 5)
    b, t = batch["frames"].shape[:2]
    lat = IMAGE // jcfg.vae.downscale
    shape = (lat, lat, jcfg.vae.latent_channels)
    p = jcfg.train.uncond_ratio
    k_drop, k_rdrop = jax.random.split(k_drop)
    draws = {"posterior_eps": jax.random.normal(k_enc, (b * t, *shape), jnp.float32),
             "noise": jax.random.normal(k_noise, (b, t, *shape)),
             "noise_offset": jax.random.normal(k_off, (b, 1, 1, 1, 1)),
             "timesteps": jax.random.randint(k_t, (b,), 0, 1000),
             "ref_drop": jax.random.bernoulli(k_rdrop, p, (b,))}
    if "wav" in batch:
        draws["audio_keep"] = jax.random.bernoulli(k_drop, 1.0 - p, (b, 1, 1, 1)).astype(jnp.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def loss_and_grads_against_the_reference(stage: int, batch, seed: int):
    """(port loss, reference loss, port grads, reference grads) of one
    stage loss on the side models, the grads over the port's trainable
    leaves."""
    _, params, _ = model_params("tiny_side")
    jcfg, tcfg = side_loss_configs(stage)
    # remat changes no value, and compiles slower on the CPU
    jm = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), stage)
    key = jax.random.PRNGKey(seed)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, stage)
    model.set_trainable(mask)
    tfn = stage_loss_fn(model, tcfg, tschedule.make_schedule(tcfg.diffusion), stage)
    draws = reference_draws(jcfg, batch, key)
    assert draws["ref_drop"].any() and not draws["ref_drop"].all()  # both branches of the CFG drop
    loss, _ = tfn({k: _t(v) for k, v in batch.items()}, draws)
    named = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    grads = torch.autograd.grad(loss, [named[n] for n in names], allow_unused=True)
    got = torch.cat([(torch.zeros_like(named[n]) if g is None else g).reshape(-1) for n, g in zip(names, grads)])
    want = port_leaves(want_grads)
    return loss.item(), float(want_loss), got.double(), torch.cat(
        [torch.from_numpy(want[n]).reshape(-1) for n in names]).double()


def side_batch(stage: int, batch: int = 2, seed: int = 20):
    rng = np.random.default_rng(seed + stage)
    img = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    out = {"ref_image": img(batch, IMAGE, IMAGE, 3), "frames": img(batch, FRAMES, IMAGE, IMAGE, 3)}
    if stage == 4:  # the dataset's control renders in [0, 1], and no audio
        out["control"] = rng.uniform(0, 1, (batch, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32)
    else:
        out["wav"] = (0.1 * rng.standard_normal((batch, 16000 * (FRAMES + 4) // 25))).astype(np.float32)
    return out


def test_stage2_with_the_identity_embedding_matches_the_reference():
    """Stage 2 with model.use_identity_embed: the frozen CLIP encodes the
    reference image, dropped with the reference; the temporal and audio
    layers' gradients carry it."""
    loss, want_loss, got, want = loss_and_grads_against_the_reference(2, side_batch(2), seed=31)
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= GRAD_TOL


# ---- the port's init and the errors --------------------------------------------------------
def test_the_ports_init_makes_the_identity_branch_an_exact_no_op():
    """Built from one seed, a model with the identity embedding and one
    without share every weight, and the zero projection adds exactly
    nothing: the same bits with or without an embedding."""
    _, _, tcfg = model_params("tiny_side")
    base = tcfg.replace(model=dataclasses.replace(tcfg.model, use_controlnet=False, use_identity_embed=False))
    on = EMOModel(base.replace(model=dataclasses.replace(base.model, use_identity_embed=True)), device="cpu", seed=5)
    off = EMOModel(base, device="cpu", seed=5)
    own, other = on.modules.state_dict(), off.modules.state_dict()
    assert set(own) - set(other) == {"denoiser.identity_embed_proj.weight"}
    assert all(torch.equal(other[k], own[k]) for k in other)
    assert not own["denoiser.identity_embed_proj.weight"].any()
    x = _inputs(base, seed=9)
    ref = off.encode_images(_t(x["images"]))
    ide = EMOPipeline(on).encode_identity(_t(x["images"]))
    assert bool(ide.abs().sum() > 0)
    ts = _t(x["timesteps"]).long()
    want = off.predict_noise(_t(x["noisy"]), ts, ref)
    assert torch.equal(on.predict_noise(_t(x["noisy"]), ts, ref, identity_embed=ide), want)


def test_identity_errors_match_the_reference():
    """The identity embedding needs the vision encoder, in both packages;
    encode_identity refuses a model whose denoiser would drop it."""
    jcfg, tcfg = model_params("tiny_side")[0].config, model_params("tiny_side")[2]
    no_vision = lambda c: c.replace(clip=dataclasses.replace(c.clip, vision_enabled=False))
    with pytest.raises(ValueError, match="vision_enabled"):
        JEMOModel(no_vision(jcfg))
    with pytest.raises(ValueError, match="vision_enabled"):
        EMOModel(no_vision(tcfg), device="cpu")
    off = tcfg.replace(model=dataclasses.replace(tcfg.model, use_identity_embed=False))
    img = torch.zeros(1, IMAGE, IMAGE, 3)
    with pytest.raises(ValueError, match="use_identity_embed"):
        EMOPipeline(EMOModel(off, device="cpu")).encode_identity(img)
    with pytest.raises(ValueError, match="use_identity_embed"):
        EMOPipeline(EMOModel(off, device="cpu"))(img, torch.zeros(1, 3200), video_length=FRAMES,
                                                 num_inference_steps=1, use_identity=True)
    with pytest.raises(ValueError, match="clip.vision_enabled is False"):
        EMOModel(no_vision(off), device="cpu").encode_image_embedding(img)
