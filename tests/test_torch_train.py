"""The port's training against the reference's, on the CPU, in float32.

The tiny preset's reference param tree (seeded, every leaf nonzero) is
loaded into both packages. Each stage's loss is fed the reference's own
random draws, replayed from its key splits, so loss and gradients can be
compared: loss <= 1e-5 and the trainable gradients, flattened, <= 1e-5
relative L2 (measured at most 1.3e-6 and 1.9e-6; float32 sums in other
orders). The optimizer is held to the reference's optax chain over three
updates to <= 1e-6. The trainer tests check what a step may touch and that
a checkpoint resumes exactly.
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
from emox.models.vae import DiagonalGaussian as JGaussian
from emox.train import stages as jstages
from emox.train.trainer import make_optimizer as j_make_optimizer
from emox_torch.diffusion import schedule as tschedule
from emox_torch.interop.from_flax import SUBMODELS, _convert
from emox_torch.models.emo import EMOModel
from emox_torch.models.vae import DiagonalGaussian as TGaussian
from emox_torch.train import Trainer, downsample_mask, make_optimizer, stage_loss_fn, trainable_mask
from emox_torch.train.stages import is_trainable
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
OPT_TOL = 1e-6
MOTION = 2


def _submodel_leaves(tree):
    """(path keys, leaf) over the submodels the port carries, in the tree's
    flattening order."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        if keys[0] in SUBMODELS:
            yield keys, leaf


def _port_leaves(tree):
    """{port parameter name: leaf in the port's layout} of a param-shaped tree."""
    out = {}
    for keys, leaf in _submodel_leaves(tree):
        name, value = _convert(keys[1:], np.asarray(leaf))
        out[f"{keys[0]}.{name}"] = value
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3, 5])
def test_trainable_mask_partitions_like_the_reference(stage):
    _, params, tcfg = model_params("tiny")
    names = list(_port_leaves(params))
    flags = [bool(m) for _, m in _submodel_leaves(jstages.trainable_mask(params, stage))]
    got = trainable_mask(EMOModel(tcfg, device="cpu").modules, stage)
    assert got == dict(zip(names, flags))
    assert 0 < sum(got.values()) < len(got)


def test_stages_outside_the_slice_raise():
    """Every stage of the reference is ported: stage 4 trains the ControlNet
    alone (test_torch_controlnet.py), stages 0 and 5 the face nets and the
    VAE (test_torch_stage0.py, test_torch_stage5.py); a stage outside 0-5
    raises."""
    assert is_trainable("controlnet.conv_in.weight", 4) and not is_trainable("denoiser.conv_in.weight", 4)
    assert is_trainable("face_locator.conv0.weight", 0) and not is_trainable("vae.encoder.conv_in.weight", 0)
    assert is_trainable("vae.encoder.conv_in.weight", 5) and not is_trainable("denoiser.conv_in.weight", 5)
    with pytest.raises(ValueError, match="bad stage"):
        is_trainable("denoiser.conv_in.weight", 6)


# ---- loss helpers ------------------------------------------------------------------
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_velocity_and_min_snr_match(prediction_type):
    from emox.core.config import DiffusionConfig as JDiffusion
    from emox_torch.core.config import DiffusionConfig as TDiffusion

    js = jschedule.make_schedule(JDiffusion(prediction_type=prediction_type))
    ts_ = tschedule.make_schedule(TDiffusion(prediction_type=prediction_type))
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999], np.int32)
    want = jschedule.get_velocity(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = tschedule.get_velocity(ts_, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t).long())
    assert rel_err(got, want) <= 1e-6
    for gamma in (0.0, 5.0):
        want = jschedule.min_snr_loss_weight(js, jnp.asarray(t), gamma)
        got = tschedule.min_snr_loss_weight(ts_, torch.from_numpy(t).long(), gamma)
        assert rel_err(got, want) <= 1e-6


def test_posterior_sample_and_kl_match():
    rng = np.random.default_rng(1)
    moments = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jd, td = JGaussian(jnp.asarray(moments)), TGaussian(torch.from_numpy(moments))
    assert rel_err(td.sample(torch.from_numpy(eps)), jd.mean + jd.std * jnp.asarray(eps)) <= 1e-6
    assert rel_err(td.kl(), jd.kl()) <= 1e-6


def test_face_mask_downsample_matches_jax_resize():
    mask = (np.random.default_rng(2).uniform(size=(2, 32, 32, 1)) > 0.5).astype(np.float32)
    for h in (16, 8, 4):
        want = jstages._downsample_mask(jnp.asarray(mask), h, h)
        assert rel_err(downsample_mask(torch.from_numpy(mask), h, h), want) <= 1e-6


# ---- the stage losses against the reference --------------------------------------------
def _loss_configs(stage: int):
    """Reference and port configs of the tiny preset with the loss shaping
    switched on: min-SNR 5, noise offset 0.05, CFG dropout 0.5, and
    v-prediction in stage 2."""
    jm, _, tcfg = model_params("tiny")
    diff = dict(snr_gamma=5.0, noise_offset=0.05, prediction_type="v_prediction" if stage == 2 else "epsilon")
    train = dict(stage=stage, uncond_ratio=0.5, compute_dtype="float32")
    out = []
    for cfg in (jm.config, tcfg):
        out.append(cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, **diff),
                               train=dataclasses.replace(cfg.train, **train)))
    return out


def _batch(stage: int, batch: int = 2):
    rng = np.random.default_rng(10 + stage)
    img = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    out = {"images": img(batch, IMAGE, IMAGE, 3), "ref_image": img(batch, IMAGE, IMAGE, 3)}
    if stage >= 2:
        out["frames"] = img(batch, FRAMES, IMAGE, IMAGE, 3)
        motion = MOTION if stage == 2 else 0
        out["wav"] = (0.1 * rng.standard_normal((batch, 16000 * (FRAMES + motion + 4) // 25))).astype(np.float32)
    if stage == 2:
        out["motion_frames"] = img(batch, MOTION, IMAGE, IMAGE, 3)
    if stage == 3:
        out["speeds"] = rng.uniform(0, 1, (batch, FRAMES)).astype(np.float32)
        yy, xx = np.mgrid[:IMAGE, :IMAGE]
        disc = (((yy - IMAGE / 2) ** 2 + (xx - IMAGE / 3) ** 2) < (IMAGE / 3) ** 2).astype(np.float32)
        out["masks"] = np.broadcast_to(disc[None, :, :, None], (batch, IMAGE, IMAGE, 1)).copy()
    return out


def _reference_draws(jcfg, stage: int, batch, key):
    """The reference loss's random numbers, replayed from its key splits
    (emox/train/stages.py denoise_loss), as the port's draws."""
    k_enc, k_noise, k_t, k_off, k_drop = jax.random.split(key, 5)
    b = batch["ref_image"].shape[0]
    t = 1 if stage == 1 else FRAMES + (batch["motion_frames"].shape[1] if "motion_frames" in batch else 0)
    lat = IMAGE // jcfg.vae.downscale
    shape = (lat, lat, jcfg.vae.latent_channels)
    p = jcfg.train.uncond_ratio
    k_drop, k_rdrop = jax.random.split(k_drop)
    draws = {
        "posterior_eps": jax.random.normal(k_enc, (b * t, *shape), jnp.float32),
        "noise": jax.random.normal(k_noise, (b, t, *shape)),
        "noise_offset": jax.random.normal(k_off, (b, 1, 1, 1, 1)),
        "timesteps": jax.random.randint(k_t, (b,), 0, 1000),
        "ref_drop": jax.random.bernoulli(k_rdrop, p, (b,)),
    }
    if stage >= 2:
        draws["audio_keep"] = jax.random.bernoulli(k_drop, 1.0 - p, (b, 1, 1, 1)).astype(jnp.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(stage: int):
    from emox.models.emo import EMOModel as JEMOModel

    _, params, _ = model_params("tiny")
    jcfg, _ = _loss_configs(stage)
    # remat changes no value, and compiles slower on the CPU
    jm = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), stage)
    key = jax.random.PRNGKey(100 + stage)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(stage).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jbatch, key)
    return key, float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("stage", [1, 2, 3], ids=["stage1", "stage2_motion_vpred", "stage3_face_loss"])
def test_stage_loss_and_grads_match_the_reference(stage):
    key, want_loss, want_metrics, want_grads = _reference_loss_and_grads(stage)
    jm, params, _ = model_params("tiny")
    jcfg, tcfg = _loss_configs(stage)
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, stage)
    model.set_trainable(mask)
    loss_fn = stage_loss_fn(model, tcfg, tschedule.make_schedule(tcfg.diffusion), stage)
    batch = {k: torch.from_numpy(v) for k, v in _batch(stage).items()}
    draws = _reference_draws(jcfg, stage, _batch(stage), key)
    assert draws["ref_drop"].any() or stage != 1  # the CFG drop path is exercised
    loss, metrics = loss_fn(batch, draws)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        assert abs(v.item() - want_metrics[k]) <= LOSS_TOL * abs(want_metrics[k]), k
    params_t = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    # leaves that do not reach the loss (ReferenceNet layers past its last
    # bank) get zeros, as jax.grad gives them
    grads = torch.autograd.grad(loss, [params_t[n] for n in names], allow_unused=True)
    grads = [torch.zeros_like(params_t[n]) if g is None else g for n, g in zip(names, grads)]
    want = _port_leaves(want_grads)
    got_flat = torch.cat([g.reshape(-1) for g in grads]).double()
    want_flat = torch.cat([torch.from_numpy(want[n]).reshape(-1) for n in names]).double()
    assert float(want_flat.norm()) > 0
    assert float((got_flat - want_flat).norm() / want_flat.norm()) <= GRAD_TOL
    assert abs(loss.item() - want_loss) <= LOSS_TOL * abs(want_loss)


# ---- the optimizer against optax ---------------------------------------------------
def _opt_grads(rng, shapes, scale, nan=False):
    out = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    if nan:
        out[0][0, 0] = np.nan
    return out


@pytest.mark.parametrize("accumulate", [1, 2], ids=["nonfinite_skip", "accumulation_and_skip"])
def test_optimizer_matches_optax(accumulate):
    """Three updates of the reference's chain (clip 1.0 with one clipped and
    one unclipped update, AdamW with decay, warmup-cosine) on the same
    gradients. With accumulate 1 the second update is non-finite and
    skipped; with 2, six micro-steps make three updates, the last window
    holding a NaN and skipped."""
    import optax

    jm, _, tcfg = model_params("tiny")
    train = dict(learning_rate=0.1, weight_decay=0.05, warmup_steps=2, num_steps=6,
                 gradient_accumulation=accumulate, grad_clip_norm=1.0)
    jcfg = jm.config.replace(train=dataclasses.replace(jm.config.train, **train))
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **train))
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if accumulate == 1:
        steps = [_opt_grads(rng, shapes, 1.0), _opt_grads(rng, shapes, 1.0, nan=True), _opt_grads(rng, shapes, 0.05)]
    else:
        steps = [_opt_grads(rng, shapes, s, nan=(i == 5)) for i, s in enumerate((1.0, 0.5, 0.02, 0.05, 1.0, 1.0))]
    jopt = j_make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    masters = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(tcfg, masters)
    applied = []
    for g in steps:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied.append(topt.step([torch.from_numpy(x.copy()) for x in g]))
        for a, b in zip(masters, jparams):
            assert rel_err(a, b) <= OPT_TOL
    assert applied == ([True, False, True] if accumulate == 1 else [False, True, False, True, False, False])
    assert topt.count == 2  # the skipped update moved neither the schedule nor AdamW
    assert not all(np.array_equal(a.numpy(), p) for a, p in zip(masters, params))


# ---- the trainer ---------------------------------------------------------------------
def _trainer(tmp_path, stage=2, **train):
    _, params, tcfg = model_params("tiny")
    cfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, stage=stage, compute_dtype="float32", checkpoint_dir=str(tmp_path), learning_rate=1e-3,
        **train))
    return Trainer(cfg, model=EMOModel(cfg, device="cpu").load_flax(params))


def _train_batch(stage=2):
    return {k: torch.from_numpy(v) for k, v in _batch(stage).items() if k != "motion_frames"}


def test_train_step_updates_only_trainable_leaves(tmp_path):
    tr = _trainer(tmp_path)
    before = {n: p.detach().clone() for n, p in tr.model.modules.named_parameters()}
    metrics = tr.train_step(_train_batch(), torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    trainable = set(tr.trainable_names())
    changed = {n for n, p in tr.model.modules.named_parameters() if not torch.equal(p, before[n])}
    assert changed and changed <= trainable
    assert all(p.grad is None for p in tr.model.modules.parameters())  # no gradient buffers kept
    assert tr.state.step == 1
    tr.close()


def test_checkpoint_resume_restores_step_params_and_optimizer(tmp_path):
    """fit() saves at step 2; a fresh trainer resumes from it, and the next
    step of both is the same."""
    batch = _train_batch()
    tr = _trainer(tmp_path, ema_decay=0.9, checkpoint_every=2, log_every=1)
    tr.fit(iter([batch, batch]), num_steps=2)
    assert tr.ckpt.latest_step() == 2
    tr2 = _trainer(tmp_path, ema_decay=0.9, checkpoint_every=2)
    tr2.model.modules.load_state_dict({k: torch.zeros_like(v) for k, v in tr2.model.modules.state_dict().items()})
    assert tr2.resume() == 2 and tr2.state.step == 2
    for (n, p), (_, p2) in zip(tr.model.modules.named_parameters(), tr2.model.modules.named_parameters()):
        assert torch.equal(p, p2), n
    for n in tr.state.masters:
        assert torch.equal(tr.state.masters[n], tr2.state.masters[n])
        assert torch.equal(tr.state.ema[n], tr2.state.ema[n])
    s1, s2 = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    assert s1["count"] == s2["count"] == 2
    for i, st in s1["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], s2["adamw"]["state"][i][k])
    m1 = tr.train_step_with_draws(batch, tr2_draws := _draws(tr2, batch))
    m2 = tr2.train_step_with_draws(batch, tr2_draws)
    assert float(m1["loss"]) == float(m2["loss"])
    for n in tr.state.masters:
        assert torch.equal(tr.state.masters[n], tr2.state.masters[n])
    # restore_params: the EMA of the trainable leaves when asked
    saved = tr.ckpt.restore(2)
    ema_params = tr.ckpt.restore_params(use_ema=True)
    name = tr.trainable_names()[0]
    assert torch.equal(ema_params[name], saved["ema_params"][name])
    # a later stage starts from this one's checkpoint
    tr3 = _trainer(tmp_path, stage=3)
    assert tr3.load_params_from_stage(2)
    for n, p in tr3.model.modules.named_parameters():
        assert torch.equal(p, saved["params"][n]), n
    lines = open(tr.logger.path).read().splitlines()
    assert any('"compile_s"' in ln for ln in lines) and any('"loss"' in ln for ln in lines)
    for t in (tr, tr2, tr3):
        t.close()


def _draws(trainer, batch):
    from emox_torch.train import sample_draws

    return sample_draws(trainer.config, trainer.sched, trainer.stage, batch, torch.Generator().manual_seed(5))
