"""The ControlNet branch and training stage 4 against the reference, on the CPU.

One seeded flax param tree per case carried into both packages, float32,
<= 1e-5 relative L2 unless stated:

  * ControlNetEncoder with a per-clip (4-D) and a per-frame (5-D)
    conditioning, with and without a text context, conditioning_scale 1 and
    0.5, at batch 2 x 3 frames: every residual, their count and shapes
    (one per UNet skip and the mid block); both layouts give the
    reference's parameter tree;
  * the same ControlNet with the reference on its Pallas kernels in
    interpret mode (EMOX_ATTENTION_IMPL=pallas_interpret) and the port on
    its kernels' plain versions ("pallas");
  * controlnet_params_from_unet copies the leaves the reference copies;
  * predict_noise with control and identity; the CFG trajectory through
    the reference's own EMOPipeline, its draws injected, batched, in two
    calls and windowed with a per-frame control;
  * stage 4: the trainable mask (every stage, the side models present)
    equal to the reference's partition, the loss (<= 1e-5) and the
    ControlNet's gradients (<= 1e-4) through the frozen denoiser, a train
    step that changes the ControlNet alone, and a checkpoint without the
    ControlNet refused;
  * the port's own init: the zero convs make the branch an exact no-op,
    bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.core import presets as jpresets
from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models import controlnet as jcn
from emox.models.emo import EMOModel as JEMOModel
from emox.train import stages as jstages
from emox_torch.core import presets as tpresets
from emox_torch.infer import pipeline as tpipeline
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.interop.from_flax import state_dict_from_flax
from emox_torch.models import controlnet as tcn
from emox_torch.models.emo import EMOModel
from emox_torch.train import Trainer, trainable_mask
from tests.test_torch_bridge import (FRAMES, IMAGE, configs, flax_module_params, model_params,  # noqa: F401
                                     no_kernel_launches, random_flax_params, rel_err, torch_module)
from tests.test_torch_identity import _t, loss_and_grads_against_the_reference, port_leaves, side_batch, side_pair
from tests.test_torch_windowed import STEPS, GUIDANCE, jax_draws, windowed

TOL = 1e-5
GRAD_TOL = 1e-4
B, T = 2, 3


def _encoder_inputs(cfg, latent: int, cond_size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((B, T, latent, latent, cfg.in_channels)).astype(np.float32),
                ts=np.array([700, 40], np.int32),
                cond5=rng.uniform(0, 1, (B, T, cond_size, cond_size, cfg.control_cond_channels)).astype(np.float32),
                ctx=rng.standard_normal((B, 5, cfg.cross_attention_dim)).astype(np.float32))


def _encoder_pair(jmodel, tmodel, latent: int, cond_size: int, seed: int = 0):
    """(reference ControlNetEncoder, its params, port encoder, inputs): the
    reference initialised on a per-clip cond, as EMOModel.init_params does."""
    x = _encoder_inputs(jmodel, latent, cond_size, seed)
    jenc = jcn.ControlNetEncoder(jmodel)
    params = flax_module_params(jenc, jnp.asarray(x["x"]), jnp.asarray(x["ts"]), jnp.asarray(x["cond5"][:, 0]),
                                seed=seed + 1)
    downs = tcn.cond_downs(cond_size, latent)
    return jenc, params, torch_module(tcn.ControlNetEncoder(tmodel, cond_num_downs=downs), params), x


@pytest.mark.parametrize("layout,context,scale", [("4d", False, 1.0), ("5d", False, 0.5), ("4d", True, 0.5),
                                                  ("5d", True, 1.0)],
                         ids=["clip", "frames_scale", "clip_context_scale", "frames_context"])
def test_controlnet_encoder_matches_the_reference(layout, context, scale):
    """The tiny preset at latents 4 x 4 from 32-pixel conditioning: the
    embedding's three stride-2 stages, 2 levels, attention (with the text
    cross-attention) at level 1 and the mid block."""
    jc, tc = configs("tiny")
    jenc, params, tenc, x = _encoder_pair(jc.model, tc.model, latent=4, cond_size=32)
    cond = x["cond5"] if layout == "5d" else x["cond5"][:, 0]
    ctx = x["ctx"] if context else None
    want = jenc.apply({"params": params}, jnp.asarray(x["x"]), jnp.asarray(x["ts"]), jnp.asarray(cond),
                      context=None if ctx is None else jnp.asarray(ctx), conditioning_scale=scale)
    got = tenc(_t(x["x"]), _t(x["ts"]).long(), _t(cond), context=_t(ctx), conditioning_scale=scale)
    m = tc.model
    levels = len(m.block_channels)
    assert len(got.down) == len(want.down) == 1 + levels * m.layers_per_block + levels - 1
    shapes = [(B * T, 4, 4, 8)] * 2 + [(B * T, 2, 2, 8), (B * T, 2, 2, 16)]
    assert [tuple(d.shape) for d in got.down] == [tuple(d.shape) for d in want.down] == shapes
    assert tuple(got.mid.shape) == want.mid.shape == (B * T, 2, 2, 16)
    for g, w in zip([*got.down, got.mid], [*want.down, want.mid]):
        assert float(np.abs(np.asarray(w)).max()) > 0
        assert rel_err(g, w) <= TOL


def test_both_conditioning_layouts_give_the_references_tree():
    """The reference reads the size of a per-clip cond at axis 1 and of a
    per-frame one at axis 2: either init gives one tree, which the port's
    encoder loads."""
    jc, tc = configs("tiny")
    x = _encoder_inputs(jc.model, 4, 32)
    shapes = lambda cond: jax.eval_shape(lambda k: jcn.ControlNetEncoder(jc.model).init(
        k, jnp.asarray(x["x"]), jnp.asarray(x["ts"]), jnp.asarray(cond)), jax.random.PRNGKey(0))
    four, five = shapes(x["cond5"][:, 0]), shapes(x["cond5"])
    assert jax.tree.structure(four) == jax.tree.structure(five)
    assert [a.shape for a in jax.tree.leaves(four)] == [a.shape for a in jax.tree.leaves(five)]
    assert {f"cond_embed.conv_{i}{s}.weight" for i in range(3) for s in "ab"} <= set(
        tcn.ControlNetEncoder(tc.model, cond_num_downs=3).state_dict())
    with pytest.raises(ValueError, match="does not match latents"):
        tcn.ControlNetEncoder(tc.model, cond_num_downs=2)(_t(x["x"]), _t(x["ts"]).long(), _t(x["cond5"]))


def test_controlnet_on_the_kernels_matches_the_references_kernels(monkeypatch):
    """The small preset's ControlNet (head dim 64, attention at levels 1 and
    2) at latents 8 x 8 with the reference forced onto its Pallas kernels
    in interpret mode and the port onto its kernels' plain versions."""
    jc, tc = jpresets.small_config(64, T), tpresets.small_config(64, T)
    jenc, params, tenc, x = _encoder_pair(jc.model, tc.model, latent=8, cond_size=64, seed=3)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas_interpret")
    want = jenc.apply({"params": params}, jnp.asarray(x["x"]), jnp.asarray(x["ts"]), jnp.asarray(x["cond5"]),
                      conditioning_scale=0.5)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas")
    got = tenc(_t(x["x"]), _t(x["ts"]).long(), _t(x["cond5"]), conditioning_scale=0.5)
    for g, w in zip([*got.down, got.mid], [*want.down, want.mid]):
        assert rel_err(g, w) <= TOL


@functools.lru_cache(maxsize=None)
def _side_params(text: bool):
    """(reference config, param tree) of the tiny preset with the
    ControlNet, its denoiser with or without the text cross-attention."""
    jc, _ = configs("tiny")
    jc = jc.replace(model=dataclasses.replace(jc.model, use_controlnet=True, use_cross_attention=text))
    shapes = jax.eval_shape(lambda k: JEMOModel(jc).init_params(k, num_frames=FRAMES, image_size=IMAGE),
                            jax.random.PRNGKey(0))
    return jc, random_flax_params(shapes, seed=2)


@pytest.mark.parametrize("text", [True, False], ids=["text", "no_text"])
def test_controlnet_params_from_unet_copies_what_the_reference_copies(text):
    """A denoiser with the text cross-attention has the ControlNet's
    attention sites, which are copied too; one without (the flagship's
    option) gives only the convolutional trunk and the time embedding."""
    _, params = _side_params(text)
    want = state_dict_from_flax(jcn.controlnet_params_from_unet(params["denoiser"], params["controlnet"]))
    got = tcn.controlnet_params_from_unet(state_dict_from_flax(params["denoiser"]),
                                          state_dict_from_flax(params["controlnet"]))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    copied = {k.split(".")[0] for k in got if not torch.equal(got[k], state_dict_from_flax(params["controlnet"])[k])}
    assert {"time_embed", "conv_in", "mid_res_0"} <= copied
    assert ("mid_attn" in copied) == text
    assert not any(k.startswith(("zero_conv", "cond_embed")) for k in copied)


# ---- the model and the pipeline ------------------------------------------------------------
@pytest.mark.parametrize("layout", ["4d", "5d"])
def test_predict_noise_with_control_matches_the_reference(layout):
    """The ControlNet on the noisy latents and timesteps, its residuals at
    scale 0.5 into the denoiser's skips and mid block, with the identity
    embedding and the reference dropped on one row."""
    jm, params, tm = side_pair()
    rng = np.random.default_rng(11)
    lat = IMAGE // jm.config.vae.downscale
    noisy = rng.standard_normal((2, FRAMES, lat, lat, 4)).astype(np.float32)
    ts = np.array([900, 150], np.int32)
    img = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ctrl = rng.uniform(0, 1, (2, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32)
    ctrl = ctrl if layout == "5d" else ctrl[:, 0]
    ref = jm.encode_images(params, jnp.asarray(img))
    ide = JEMOPipeline(jm).encode_identity(params, jnp.asarray(img))
    drop = np.array([False, True])
    kw = dict(control_scale=0.5, ref_dropout=drop, identity_embed=ide)
    want = jm.predict_noise(params, jnp.asarray(noisy), jnp.asarray(ts), ref, control_cond=jnp.asarray(ctrl),
                            **{k: jnp.asarray(v) if k != "control_scale" else v for k, v in kw.items()})
    tkw = dict(control_scale=0.5, ref_dropout=_t(drop), identity_embed=_t(ide))
    got = tm.predict_noise(_t(noisy), _t(ts).long(), _t(ref), control_cond=_t(ctrl), **tkw)
    assert rel_err(got, want) <= TOL
    assert rel_err(tm.predict_noise(_t(noisy), _t(ts).long(), _t(ref), **tkw), want) > 100 * TOL


@pytest.mark.parametrize("program,frames", [("batched", 3), ("two_call", 3), ("windowed", 7)])
def test_cfg_trajectory_with_control_matches_the_reference(program, frames, monkeypatch):
    """generate_latents with per-frame control renders and the identity
    embedding, CFG 2: one batched call a step, two calls (the uncond one
    keeps the control and zeroes the identity), and T 7 through the
    windowed sampler (context 4, overlap 1) with the control gathered per
    window, two windows a call."""
    jm, params, _ = side_pair()
    jcfg, tcfg = jm.config, model_params("tiny_side")[2]
    inf = dict(cfg_batching=program != "two_call")
    jcfg, tcfg = windowed(jcfg, **inf), windowed(tcfg, **inf)
    rng = np.random.default_rng(12)
    img = rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    wav = (0.1 * rng.standard_normal((1, 16000 * (frames + 4) // 25))).astype(np.float32)
    ctrl = rng.uniform(0, 1, (1, frames, IMAGE, IMAGE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    ide = JEMOPipeline(JEMOModel(jcfg), jcfg).encode_identity(params, jnp.asarray(img))
    want = JEMOPipeline(JEMOModel(jcfg), jcfg).generate_latents(
        params, jnp.asarray(img), jnp.asarray(wav), video_length=frames, num_inference_steps=STEPS,
        guidance_scale=GUIDANCE, key=key, control_cond=jnp.asarray(ctrl), identity_embed=ide)
    lat = IMAGE // tcfg.vae.downscale
    latents, _ = jax_draws(key, (1, frames, lat, lat, 4), STEPS)
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 2)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    got = pipe.generate_latents(_t(img), _t(wav), video_length=frames, num_inference_steps=STEPS,
                                guidance_scale=GUIDANCE, latents=_t(latents), control_cond=_t(ctrl),
                                identity_embed=pipe.encode_identity(_t(img)))
    assert got.shape == want.shape == (1, frames, lat, lat, 4)
    assert rel_err(got, want) <= TOL


# ---- stage 4 ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", [0, 1, 2, 3, 4, 5])
def test_trainable_mask_with_the_side_models_partitions_like_the_reference(stage):
    """Every leaf, the ControlNet's and the CLIP vision encoder's included:
    the ControlNet trains at stage 4 alone, CLIP never, the identity
    projection with the spatial stack at stage 1."""
    _, params, tm = side_pair()
    want = dict(zip(port_leaves(params), (bool(m) for m in jax.tree.leaves(jstages.trainable_mask(params, stage)))))
    got = trainable_mask(tm.modules, stage)
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    assert not any(v for k, v in got.items() if k.startswith("clip_vision."))
    assert got["denoiser.identity_embed_proj.weight"] == (stage == 1)


def test_stage4_loss_and_grads_match_the_reference():
    """The stage-4 loss on per-frame control renders with the identity
    embedding: the ControlNet's gradients come back through the frozen
    denoiser's mid and up path."""
    loss, want_loss, got, want = loss_and_grads_against_the_reference(4, side_batch(4), seed=45)
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= GRAD_TOL


def _stage_config(cfg, stage, tmp_path):
    return cfg.replace(train=dataclasses.replace(cfg.train, stage=stage, compute_dtype="float32",
                                                 checkpoint_dir=str(tmp_path), learning_rate=1e-3))


def test_stage4_train_step_changes_the_controlnet_alone(tmp_path):
    _, _, tcfg = model_params("tiny_side")
    tr = Trainer(_stage_config(tcfg, 4, tmp_path), device="cpu")
    before = {n: p.detach().clone() for n, p in tr.model.modules.named_parameters()}
    batch = {k: _t(v) for k, v in side_batch(4, seed=50).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):  # the first step moves the zero convs, the second the rest
        assert np.isfinite(float(tr.train_step(batch, gen)["loss"]))
    changed = {n for n, p in tr.model.modules.named_parameters() if not torch.equal(p, before[n])}
    assert changed and all(n.startswith("controlnet.") for n in changed)
    assert {n for n in before if n.startswith("controlnet.zero_conv")} <= changed
    tr.close()


def test_stage4_from_a_checkpoint_without_the_controlnet_raises(tmp_path):
    """A stage-3 checkpoint of a model without the ControlNet cannot seed a
    stage-4 run: the missing tree is named, no fresh init stands in."""
    _, _, tcfg = model_params("tiny")
    prev = Trainer(_stage_config(tcfg, 3, tmp_path), device="cpu")
    prev.ckpt.save(1, prev._payload())
    prev.close()
    cn = tcfg.replace(model=dataclasses.replace(tcfg.model, use_controlnet=True))
    tr = Trainer(_stage_config(cn, 4, tmp_path), device="cpu")
    with pytest.raises(ValueError, match=r"lacks the submodels \['controlnet'\]"):
        tr.load_params_from_stage(3)
    tr.close()


def test_the_ports_init_makes_the_controlnet_an_exact_no_op():
    """Built from one seed, a model with the ControlNet and one without
    share every weight, and the zero convs add exactly nothing: the same
    bits with or without control renders."""
    _, tcfg = configs("tiny")
    on = EMOModel(tcfg.replace(model=dataclasses.replace(tcfg.model, use_controlnet=True)), device="cpu", seed=6)
    off = EMOModel(tcfg, device="cpu", seed=6)
    own, other = on.modules.state_dict(), off.modules.state_dict()
    assert {k.split(".")[0] for k in set(own) - set(other)} == {"controlnet"}
    assert all(torch.equal(other[k], own[k]) for k in other)
    zero = [k for k in own if k.startswith(("controlnet.zero_conv", "controlnet.cond_embed.conv_out"))]
    assert len(zero) == 2 * (on.modules.controlnet.num_zero_convs + 1) and not any(own[k].any() for k in zero)
    rng = np.random.default_rng(13)
    lat = IMAGE // tcfg.vae.downscale
    noisy = _t(rng.standard_normal((2, FRAMES, lat, lat, 4)).astype(np.float32))
    ts = torch.tensor([600, 20])
    ref = off.encode_images(_t(rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)))
    ctrl = _t(rng.uniform(0, 1, (2, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32))
    assert torch.equal(on.predict_noise(noisy, ts, ref, control_cond=ctrl), off.predict_noise(noisy, ts, ref))


def test_launches_of_the_control_paths_match_the_code(monkeypatch):
    """chip_smoke.py's exact counts with the ControlNet, at the side models'
    tiny widths with the K/V cutoff lowered to 64 so that the ControlNet's
    sites (64 tokens), the writer's and the VAE's reach the kernels' routes:
    the attention forwards and FF sub-layers of a CFG request with control
    renders and the identity embedding, then the attention backwards and FF
    sub-layers of one stage-4 loss-and-gradient step, counted."""
    import chip_smoke
    from emox_torch.nn import attention_blocks
    from emox_torch.ops import attention as tattn
    from tests.test_torch_512 import _count_routes

    jm, params, tm = side_pair()
    tcfg = model_params("tiny_side")[2]
    attn = _count_routes(monkeypatch, cutoff=64)
    ff, bwd = [], []
    inner_ff = attention_blocks.fused_ln_geglu_ff
    monkeypatch.setattr(attention_blocks, "fused_ln_geglu_ff", lambda *a, **k: ff.append(1) or inner_ff(*a, **k))
    for name in ("flash_attention_nlc_bwd", "flash_attention_bwd"):  # either layout's backward (head dim 4: strided)
        inner = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, inner=inner, **k: bwd.append(1) or inner(*a, **k))
    rng = np.random.default_rng(14)
    img = _t(rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32))
    wav = _t((0.1 * rng.standard_normal((1, 16000 * (FRAMES + 4) // 25))).astype(np.float32))
    ctrl = _t(rng.uniform(0, 1, (1, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32))
    steps = 2
    video = EMOPipeline(tm)(img, wav, video_length=FRAMES, num_inference_steps=steps, guidance_scale=2.0,
                            use_identity=True, control_cond=ctrl)
    assert bool(video.isfinite().all())
    assert attn == chip_smoke.attn_launches_per_request(tcfg, steps, control=True)
    # the reader's 4 sites and the ControlNet's 2 (level 1, mid) a call; the writer's 4, the VAE's 2
    assert sum(attn.values()) == (4 + 2) * steps + 4 + 2
    assert len(ff) == chip_smoke.ff_launches_per_request(tcfg, steps, control=True)
    assert chip_smoke.ff_launches_per_request(tcfg, steps, control=True) - chip_smoke.ff_launches_per_request(
        tcfg, steps) == 2 * steps

    ff.clear()
    _, cfg = configs("tiny_side")  # remat on, as by default
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, stage=4, uncond_ratio=0.5, compute_dtype="float32"))
    model = EMOModel(cfg, device="cpu").load_flax(params)
    model.set_trainable(trainable_mask(model.modules, 4))
    from emox_torch.diffusion import schedule as tschedule
    from emox_torch.train import sample_draws, stage_loss_fn

    sched = tschedule.make_schedule(cfg.diffusion)
    batch = {k: _t(v) for k, v in side_batch(4, seed=60).items()}
    loss, _ = stage_loss_fn(model, cfg, sched, 4)(batch, sample_draws(cfg, sched, 4, batch,
                                                                      torch.Generator().manual_seed(1)))
    named = dict(model.modules.named_parameters())
    torch.autograd.grad(loss, [p for p in named.values() if p.requires_grad])
    assert len(bwd) == chip_smoke.stage4_bwd_per_step(cfg) == 2 + 2  # the reader's up sites, the ControlNet's
    assert len(ff) == chip_smoke.train_step_sublayers(cfg, stage=4)
