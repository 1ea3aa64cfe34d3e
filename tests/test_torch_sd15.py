"""The SD-1.5 head layout through the port, against the reference, on the CPU.

flagship-sd15 is the flagship with 8 heads (head dim C/8), the ResNet time
embedding added, and text cross-attention fed by the CLIP text encoder.
Here the same overrides run at tiny widths ('tiny_sd15': 2 heads of dim 8,
a 2-layer CLIP text encoder), float32, with the reference's param tree
carried over. The K/V cutoff is lowered so the reader's self-attention
sites (reference tokens appended, Lk 128) take the strided kernels' route
(`flash_attention` and its backward; their plain versions on the CPU), as
the level-0 sites do at full size; everything else stays plain, as there.
Tolerances: predict_noise, the prompt-conditioned 3-step CFG DDIM
trajectory and the VAE decode, the stage-2 loss and its trainable
gradients, each <= 1e-5 relative.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.diffusion import schedule as jsched
from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.train import stages as jstages
from emox_torch.diffusion import schedule as tschedule
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from emox_torch.ops import attention as tattn
from emox_torch.train import stage_loss_fn, trainable_mask
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_train import _batch, _reference_draws

TOL = 1e-5
PROMPT = "a person talking, studio lighting, 4k, x² ½"
NAME = "tiny_sd15"
# the reader's self-attention sites of the tiny preset with attention at
# level 1 (down_1_0, mid, up_1_0, up_1_1): 8x8 tokens + 64 reference tokens
READER_SITES = 4
CUTOFF = 128


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def _pair():
    jm, params, tcfg = model_params(NAME)
    return jm, params, EMOModel(tcfg, device="cpu", seed=1).load_flax(params)


@pytest.fixture
def strided_route(monkeypatch):
    """Lower the K/V cutoff to the reader's self-attention sites and count
    the calls that take the strided kernels' route (forward and backward)."""
    calls = {"fwd": 0, "bwd": 0}

    def count(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "auto")  # the card's default (tests/conftest.py pins xla)
    monkeypatch.setattr(tattn, "KERNEL_MIN_KV", CUTOFF)
    monkeypatch.setattr(tattn, "flash_attention", count("fwd", tattn.flash_attention))
    monkeypatch.setattr(tattn, "flash_attention_bwd", count("bwd", tattn.flash_attention_bwd))
    return calls


def test_tiny_sd15_has_the_sd15_layout():
    jm, params, tm = _pair()
    cfg = tm.config
    heads = cfg.model.attention_heads
    assert heads > 1 and (cfg.model.base_channels * 2 // heads) % 64 != 0
    assert cfg.model.resnet_temb_mode == "add" and cfg.model.use_cross_attention and cfg.clip.text_enabled
    assert cfg.model.cross_attention_dim == cfg.clip.text_hidden_dim
    assert "attn2" in dict(tm.modules.denoiser.named_modules())["down_1_0_attn.block_0"]._modules
    assert jm.config.model.attention_heads == heads


def _ids(jm, *texts):
    from emox_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer().encode(list(texts), max_length=jm.config.clip.max_positions)


def test_predict_noise_with_clip_context(strided_route):
    """The CFG-shaped batch (uncond row: no reference, zero audio, the empty
    prompt's context; cond row: the prompt's) through the whole model, the
    CLIP text context on both sides from the same token ids."""
    from tests.test_torch_models import _inputs

    jm, params, tm = _pair()
    x = _inputs(jm.config, seed=6)
    ids = _ids(jm, "", PROMPT)
    ctx_want = jm.encode_text(params, jnp.asarray(ids))
    ctx_got = tm.encode_text(_t(ids))
    assert ctx_got.shape == (2, jm.config.clip.max_positions, 16)
    assert rel_err(ctx_got, ctx_want) <= TOL
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    audio = np.array(jm.encode_audio(params, jnp.asarray(x["wav"]), FRAMES))
    audio[0] = 0.0
    drop = np.array([True, False])
    want = jm.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref,
                            audio_windows=jnp.asarray(audio), speeds=jnp.asarray(x["speeds"]), context=ctx_want,
                            ref_dropout=jnp.asarray(drop))
    got = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), _t(ref), audio_windows=_t(audio),
                           speeds=_t(x["speeds"]), context=ctx_got, ref_dropout=_t(drop))
    assert strided_route["fwd"] == READER_SITES
    assert rel_err(got, want) <= TOL
    # the context reaches the output: the null context gives another result
    plain = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), _t(ref), audio_windows=_t(audio),
                             speeds=_t(x["speeds"]), ref_dropout=_t(drop))
    assert rel_err(plain, want) > 100 * TOL


def test_encode_prompt_matches_reference_and_checks_the_vocabulary():
    jm, params, tm = _pair()
    want = JEMOPipeline(jm).encode_prompt(params, PROMPT, "blurry")
    pipe = EMOPipeline(tm)
    got = pipe.encode_prompt(PROMPT, "blurry")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, jm.config.clip.max_positions, 16)
        assert rel_err(g, w) <= TOL

    class WideTokenizer:
        def encode(self, texts, max_length):
            return np.full((len(texts), max_length), 49408, np.int32)

    with pytest.raises(ValueError, match="vocab_size"):
        pipe.encode_prompt(PROMPT, tokenizer=WideTokenizer())
    with pytest.raises(ValueError, match="uncond_context"):
        pipe._model_out(torch.zeros(1, FRAMES, 16, 16, 4), torch.tensor([10]), None, None, None, None, 2.0,
                        context=got[0])


def test_prompt_cfg_trajectory_and_decode_match_reference(strided_route):
    """A 3-step CFG-batched DDIM trajectory (eta 0, injected latents) with a
    prompt, then the VAE decode: EMOPipeline.__call__ against the
    reference's encode_prompt, _model_out and ddim_step in a loop."""
    from tests.test_torch_pipeline import _request

    steps, guidance = 3, 3.5
    jm, params, tm = _pair()
    req = _request(jm.config, seed=2)
    jpipe = JEMOPipeline(jm)
    ctx, uctx = jpipe.encode_prompt(params, PROMPT)
    ref, audio = jpipe._prepare(params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), FRAMES)
    face = jm.encode_face_mask(params, jnp.asarray(req["mask"]), ref.shape[1])
    ts = jsched.inference_timesteps(jpipe.sched.num_train_timesteps, steps)
    feats, _ = jpipe._precompute_banks(params, ref, ts)
    ts = [int(t) for t in ts]
    lat = jnp.asarray(req["latents"])
    for i, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        out = jpipe._model_out(params, lat, jnp.full((1,), t, jnp.int32), ref, audio, jnp.asarray(req["speeds"]),
                               face, guidance, context=ctx, uncond_context=uctx,
                               ref_features=jax.tree.map(lambda x: x[i], feats))
        lat = jsched.ddim_step(jpipe.sched, out, lat, jnp.full((1,), t, jnp.int32), jnp.full((1,), t_prev, jnp.int32))
    want_video = jm.decode_latents(params, lat)

    pipe = EMOPipeline(tm)
    kw = dict(video_length=FRAMES, num_inference_steps=steps, guidance_scale=guidance,
              speeds=_t(req["speeds"]), face_mask=_t(req["mask"]), latents=_t(req["latents"]))
    timings = {}
    got_video = pipe(_t(req["image"]), _t(req["wav"]), prompt=PROMPT, timings=timings, **kw)
    # one CFG-batched call per reader site and step, plus the VAE's
    # mid-attention at encode and decode (one head of dim 16, Lk 256 here)
    assert strided_route["fwd"] == READER_SITES * steps + 2
    assert got_video.shape == want_video.shape == (1, FRAMES, IMAGE, IMAGE, 3)
    assert rel_err(got_video, want_video) <= TOL
    assert "prompt_s" in timings
    got_lat = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), context=_t(np.asarray(ctx)),
                                    uncond_context=_t(np.asarray(uctx)), **kw)
    assert rel_err(got_lat, lat) <= TOL
    # the prompt steers the result: another prompt moves the latents
    other = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), context=pipe.encode_prompt("a cat")[0],
                                  uncond_context=_t(np.asarray(uctx)), **kw)
    assert rel_err(other, lat) > 100 * TOL


def _stage2_configs():
    """Reference and port configs of tiny_sd15 with the stage-2 loss shaping
    on (min-SNR 5, noise offset 0.05, CFG dropout 0.5, v-prediction)."""
    jm, _, tm = _pair()
    diff = dict(snr_gamma=5.0, noise_offset=0.05, prediction_type="v_prediction")
    train = dict(stage=2, uncond_ratio=0.5, compute_dtype="float32")
    return [cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, **diff),
                        train=dataclasses.replace(cfg.train, **train)) for cfg in (jm.config, tm.config)]


def _named_leaves(tree, like=None):
    """{port parameter name: leaf} over every submodel the port carries,
    clip_text included: leaves of a param-shaped tree in the port's layout,
    or of `like` (a tree of the same structure, e.g. a mask) as they are."""
    from emox_torch.interop.from_flax import OPTIONAL_SUBMODELS, SUBMODELS, _convert

    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    others = [None] * len(leaves) if like is None else jax.tree_util.tree_leaves(like)
    for (path, leaf), other in zip(leaves, others):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        if keys[0] in SUBMODELS + OPTIONAL_SUBMODELS:
            name, value = _convert(keys[1:], np.asarray(leaf))
            out[f"{keys[0]}.{name}"] = value if like is None else other
    return out


def test_stage2_mask_keeps_clip_text_frozen():
    jm, params, tm = _pair()
    want = {n: bool(v) for n, v in _named_leaves(params, like=jstages.trainable_mask(params, 2)).items()}
    got = trainable_mask(tm.modules, 2)
    assert got == want
    assert any(n.startswith("clip_text.") for n in got) and not any(
        v for n, v in got.items() if n.startswith("clip_text.") or ".attn2." in n or "null_context" in n)


def test_stage2_loss_and_grads_match_the_reference(strided_route):
    """The stage-2 loss (motion frames, v-prediction, CFG dropout) and every
    trainable gradient against jax.value_and_grad, fed the reference's own
    draws; the strided route's backward runs at the reader's sites."""
    from emox.models.emo import EMOModel as JEMOModel

    _, params, _ = _pair()
    jcfg, tcfg = _stage2_configs()
    jm = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jsched.make_schedule(jcfg.diffusion), 2)
    key = jax.random.PRNGKey(202)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in _batch(2).items()}, key)

    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, 2)
    model.set_trainable(mask)
    loss, _ = stage_loss_fn(model, tcfg, tschedule.make_schedule(tcfg.diffusion), 2)(
        {k: _t(v) for k, v in _batch(2).items()}, _reference_draws(jcfg, 2, _batch(2), key))
    names = [n for n, m in mask.items() if m]
    own = dict(model.modules.named_parameters())
    grads = torch.autograd.grad(loss, [own[n] for n in names])
    assert strided_route["fwd"] >= READER_SITES and strided_route["bwd"] > 0
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    want = _named_leaves(want_grads)
    got_flat = torch.cat([g.reshape(-1) for g in grads]).double()
    want_flat = torch.cat([torch.from_numpy(want[n]).reshape(-1) for n in names]).double()
    assert float(want_flat.norm()) > 0
    assert float((got_flat - want_flat).norm() / want_flat.norm()) <= TOL
