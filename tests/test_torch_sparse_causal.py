"""Sparse-causal self-attention (model.use_sparse_causal) against the reference, on the CPU.

Each frame's self-attention takes its keys and values from the normed
tokens of the clip's first frame and of the frame before it, the reference
tokens appended; a batch with per-row reference dropout runs both branches
and selects per row. One seeded flax param tree carried into both packages
(the tiny preset: the option adds no parameter), float32, <= 1e-5 relative
L2 unless stated:

  * the three properties tests/test_nn.py holds the reference to, on the
    port: frame t depends on frames 0 and t-1 only, a dropped row equals
    the program without a reference exactly, one frame gathers nothing;
  * SpatialTransformer without a reference, with one, and with a mixed
    reference dropout;
  * predict_noise, and the CFG trajectory through the reference's own
    EMOPipeline (batched, two calls, windowed), its draws injected;
  * the stage-2 loss (<= 1e-5) and its gradients (<= 1e-4), the reference's
    draws replayed, the reference dropped on one row;
  * on the kernels' plain versions ("pallas") against the reference's
    Pallas kernels in interpret mode.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.diffusion import schedule as jschedule
from emox.infer.pipeline import EMOPipeline as JEMOPipeline
from emox.models.emo import EMOModel as JEMOModel
from emox.nn import attention_blocks as jab
from emox.train import stages as jstages
from emox_torch.diffusion import schedule as tschedule
from emox_torch.infer import pipeline as tpipeline
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.emo import EMOModel
from emox_torch.nn import attention_blocks as tab
from emox_torch.train import stage_loss_fn, trainable_mask
from tests.test_torch_bridge import (IMAGE, flax_module_params, model_params,  # noqa: F401 (autouse fixture)
                                     no_kernel_launches, rel_err, torch_module)
from tests.test_torch_identity import port_leaves, reference_draws
from tests.test_torch_windowed import GUIDANCE, STEPS, jax_draws, request, windowed

TOL = 1e-5
GRAD_TOL = 1e-4
C, HEADS, HEAD_DIM, GROUPS = 8, 2, 4, 4


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def sparse(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, use_sparse_causal=True))


@functools.lru_cache(maxsize=None)
def sc_pair():
    """(reference EMOModel, params, port EMOModel) of the tiny preset with
    sparse-causal attention, one param tree in both."""
    jm, params, tcfg = model_params("tiny")
    return JEMOModel(sparse(jm.config)), params, EMOModel(sparse(tcfg), device="cpu").load_flax(params)


def _transformers(t: int, with_ref: bool, seed: int = 0):
    """(reference SpatialTransformer, params, port SpatialTransformer, x, ref)
    over clips of t frames, batch 2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * t, 4, 4, C)).astype(np.float32)
    ref = [rng.standard_normal((2, 5, C)).astype(np.float32)] if with_ref else None
    jst = jab.SpatialTransformer(HEADS, HEAD_DIM, groups=GROUPS, use_cross=False, sparse_causal=True, num_frames=t)
    params = flax_module_params(jst, jnp.asarray(x), ref_kv=None if ref is None else [jnp.asarray(ref[0])],
                                seed=seed + 1)
    tst = torch_module(tab.SpatialTransformer(C, HEADS, HEAD_DIM, groups=GROUPS, use_cross=False,
                                              sparse_causal=True), params)
    return jst, params, tst, x, ref


def _port(tst, x, t, ref=None, drop=None):
    with torch.no_grad():
        return tst(_t(x), ref_kv=None if ref is None else [_t(ref[0])], ref_drop=_t(drop), num_frames=t)[0]


# ---- the reference's own properties, on the port ------------------------------------------
def test_sparse_causal_kv_layout():
    """Frame 1's output does not depend on frame 2's input; frame 2's does."""
    _, _, tst, x, _ = _transformers(3, with_ref=False)
    out = _port(tst, x, 3)
    x2 = x.copy()
    x2[2] += 1.0  # frame 2 of clip 0
    out2 = _port(tst, x2, 3)
    torch.testing.assert_close(out2[:2], out[:2], rtol=0, atol=1e-6)
    assert not torch.allclose(out2[2], out[2])
    assert torch.equal(out2[3:], out[3:])  # the other clip


def test_sparse_causal_ref_dropout_exact():
    """A row with its reference dropped equals the program without a
    reference, through the two-branch select; kept rows differ."""
    _, _, tst, x, ref = _transformers(3, with_ref=True)
    n = x.shape[0]
    dropped = _port(tst, x, 3, ref, np.ones(n, bool))
    torch.testing.assert_close(dropped, _port(tst, x, 3), rtol=0, atol=1e-6)
    assert not torch.allclose(_port(tst, x, 3, ref, np.zeros(n, bool)), dropped)


def test_off_for_one_frame_matches_plain():
    """One frame gathers nothing: the same bits as plain self-attention."""
    _, params, tst, x, _ = _transformers(1, with_ref=False)
    plain = torch_module(tab.SpatialTransformer(C, HEADS, HEAD_DIM, groups=GROUPS, use_cross=False), params)
    torch.testing.assert_close(_port(tst, x, 1), _port(plain, x, 1), rtol=0, atol=0)


def test_sc_gather_layout():
    """Each frame's row: the first frame's tokens, then the previous frame's."""
    tok = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(6, 2, 1)
    got = tab.sc_gather(tok, 3).reshape(2, 3, 4)
    v = tok.reshape(2, 3, 2)
    for b in range(2):
        for f in range(3):
            torch.testing.assert_close(got[b, f], torch.cat([v[b, 0], v[b, max(f - 1, 0)]]))


# ---- against the reference -----------------------------------------------------------------
@pytest.mark.parametrize("case", ["no_ref", "ref", "mixed_drop"])
def test_spatial_transformer_matches_the_reference(case):
    t = 3
    jst, params, tst, x, ref = _transformers(t, with_ref=case != "no_ref", seed=3)
    drop = np.array([True, False, False, True, False, True]) if case == "mixed_drop" else None
    want, banks = jst.apply({"params": params}, jnp.asarray(x), ref_kv=None if ref is None else [jnp.asarray(ref[0])],
                            ref_drop=None if drop is None else jnp.asarray(drop))
    assert rel_err(_port(tst, x, t, ref, drop), want) <= TOL


def test_predict_noise_matches_the_reference():
    """The denoiser with sparse-causal sites over 3 frames, the reference
    tokens appended, the reference dropped on one row (both branches)."""
    jm, params, tm = sc_pair()
    rng = np.random.default_rng(5)
    lat = IMAGE // jm.config.vae.downscale
    noisy = rng.standard_normal((2, 3, lat, lat, 4)).astype(np.float32)
    ts = np.array([870, 60], np.int32)
    img = rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jm.encode_images(params, jnp.asarray(img))
    drop = np.array([False, True])
    want = jm.predict_noise(params, jnp.asarray(noisy), jnp.asarray(ts), ref, ref_dropout=jnp.asarray(drop))
    got = tm.predict_noise(_t(noisy), _t(ts).long(), _t(ref), ref_dropout=_t(drop))
    assert rel_err(got, want) <= TOL
    plain = EMOModel(model_params("tiny")[2], device="cpu").load_flax(params)
    assert rel_err(plain.predict_noise(_t(noisy), _t(ts).long(), _t(ref), ref_dropout=_t(drop)), want) > 100 * TOL


@pytest.mark.parametrize("program,frames", [("batched", 3), ("two_call", 3), ("windowed", 7)])
def test_cfg_trajectory_matches_the_reference(program, frames, monkeypatch):
    """generate_latents at CFG 2: one batched call a step (both branches at
    every site), two calls (the uncond call without a reference), and T 7
    through the windowed sampler (context 4, overlap 1), two windows a call,
    each window gathering over its own frames."""
    jm, params, _ = sc_pair()
    jcfg, tcfg = jm.config, sparse(model_params("tiny")[2])
    inf = dict(cfg_batching=program != "two_call")
    jcfg, tcfg = windowed(jcfg, **inf), windowed(tcfg, **inf)
    req = request(tcfg, frames, seed=13)
    key = jax.random.PRNGKey(13)
    want = JEMOPipeline(JEMOModel(jcfg), jcfg).generate_latents(
        params, jnp.asarray(req["image"]), jnp.asarray(req["wav"]), video_length=frames, num_inference_steps=STEPS,
        guidance_scale=GUIDANCE, speeds=jnp.asarray(req["speeds"]), face_mask=jnp.asarray(req["mask"]), key=key)
    lat = IMAGE // tcfg.vae.downscale
    latents, _ = jax_draws(key, (1, frames, lat, lat, 4), STEPS)
    monkeypatch.setattr(tpipeline, "WINDOWS_PER_CALL", 2)
    pipe = EMOPipeline(EMOModel(tcfg, device="cpu").load_flax(params), tcfg)
    got = pipe.generate_latents(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=STEPS,
                                guidance_scale=GUIDANCE, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]),
                                latents=_t(latents))
    assert got.shape == want.shape == (1, frames, lat, lat, 4)
    assert rel_err(got, want) <= TOL


def test_stage2_loss_and_grads_match_the_reference():
    """Stage 2 with reference dropout (uncond_ratio 0.5, both rows' draws
    different): the loss takes both branches at every site, and the
    temporal and audio layers' gradients come back through both."""
    jm, params, _ = sc_pair()
    tcfg = sparse(model_params("tiny")[2])
    train = dict(stage=2, uncond_ratio=0.5, compute_dtype="float32")
    jcfg, tcfg = (c.replace(train=dataclasses.replace(c.train, **train)) for c in (jm.config, tcfg))
    rng = np.random.default_rng(22)
    frames = 3
    img = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    batch = {"ref_image": img(2, IMAGE, IMAGE, 3), "frames": img(2, frames, IMAGE, IMAGE, 3),
             "wav": (0.1 * rng.standard_normal((2, 16000 * (frames + 4) // 25))).astype(np.float32)}
    # remat changes no value, and compiles slower on the CPU
    jmodel = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jmodel, jcfg, jschedule.make_schedule(jcfg.diffusion), 2)
    key = jax.random.PRNGKey(3)  # drops the reference of row 0 alone
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = reference_draws(jcfg, batch, key)
    assert draws["ref_drop"].any() and not draws["ref_drop"].all()
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, 2)
    model.set_trainable(mask)
    loss, _ = stage_loss_fn(model, tcfg, tschedule.make_schedule(tcfg.diffusion), 2)(
        {k: _t(v) for k, v in batch.items()}, draws)
    named = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    grads = torch.autograd.grad(loss, [named[n] for n in names], allow_unused=True)
    got = torch.cat([(torch.zeros_like(named[n]) if g is None else g).reshape(-1) for n, g in zip(names, grads)])
    want_tree = port_leaves(want_grads)
    want = torch.cat([torch.from_numpy(want_tree[n]).reshape(-1) for n in names]).double()
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    assert float(want.norm()) > 0
    assert float((got.double() - want).norm() / want.norm()) <= GRAD_TOL


def test_on_the_kernels_matches_the_references_kernels(monkeypatch):
    """The transformer with the reference on its Pallas kernels in
    interpret mode and the port on its kernels' plain versions at every
    site, both branches of the reference dropout included."""
    t = 3
    jst, params, tst, x, ref = _transformers(t, with_ref=True, seed=9)
    drop = np.array([False, True, False, True, True, False])
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas_interpret")
    want, _ = jst.apply({"params": params}, jnp.asarray(x), ref_kv=[jnp.asarray(ref[0])], ref_drop=jnp.asarray(drop))
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas")
    assert rel_err(_port(tst, x, t, ref, drop), want) <= TOL


def test_launches_of_the_sparse_causal_paths_match_the_code(monkeypatch):
    """chip_smoke.py's counts under sparse-causal attention, the K/V cutoff
    lowered to 128 (the reader's sites reach it, the writer's do not): a
    CFG-batched request launches the forward twice at each reader site a
    step (with and without the reference), attn_launches_per_request's
    count; a stage-2 loss-and-gradient step launches twice the backward of
    the plain model's (BWD_PER_STEP's 8 against 4 on the flagship)."""
    import chip_smoke
    from emox_torch.ops import attention as tattn
    from tests.test_torch_512 import _count_routes
    from tests.test_torch_pipeline import _request

    jm, params, tm = sc_pair()
    tcfg = tm.config
    frames, steps = 3, 2
    req = _request(tcfg, seed=42)
    calls = _count_routes(monkeypatch, cutoff=128)
    video = EMOPipeline(tm)(_t(req["image"]), _t(req["wav"]), video_length=frames, num_inference_steps=steps,
                            guidance_scale=3.0)
    assert bool(video.isfinite().all())
    want = chip_smoke.attn_launches_per_request(tcfg, steps)
    assert calls == want and sum(want.values()) == 2 * 4 * steps + 2

    bwd = []
    for name in ("flash_attention_nlc_bwd", "flash_attention_bwd"):
        inner = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, inner=inner, **k: bwd.append(1) or inner(*a, **k))
    rng = np.random.default_rng(23)
    img = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    batch = {"ref_image": img(2, IMAGE, IMAGE, 3), "frames": img(2, frames, IMAGE, IMAGE, 3),
             "wav": torch.from_numpy((0.1 * rng.standard_normal((2, 16000 * (frames + 4) // 25))).astype(np.float32))}
    counts = []
    for cfg in (tcfg, model_params("tiny")[2]):
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, stage=2, compute_dtype="float32"))
        model = EMOModel(cfg, device="cpu").load_flax(params)
        model.set_trainable(trainable_mask(model.modules, 2))
        sched = tschedule.make_schedule(cfg.diffusion)
        from emox_torch.train import sample_draws

        loss, _ = stage_loss_fn(model, cfg, sched, 2)(batch, sample_draws(cfg, sched, 2, batch,
                                                                          torch.Generator().manual_seed(2)))
        bwd.clear()
        torch.autograd.grad(loss, [p for p in model.modules.parameters() if p.requires_grad])
        counts.append(len(bwd))
    assert counts[0] == 2 * counts[1] > 0
