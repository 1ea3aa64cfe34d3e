"""Stage 5, VAE pretraining, against the reference on the CPU, in float32.

The tiny preset's reference param tree is loaded into both packages. The
reference's loss draws the posterior noise inside, jax.random.normal(key,
mean.shape); the test rebuilds that draw and hands it to the port's loss as
`posterior_eps`. Loss and metrics <= 1e-5 relative (latent_std is the
population std of the posterior means), the VAE's gradients, flattened,
<= 1e-5 relative L2 (float32 sums in other orders; measured at most 6.4e-7
and 3.5e-7).
Then the trainer: stage 5 checkpoints its VAE, and stage 1 started from that
checkpoint holds the VAE frozen, bit for bit, as the reference's stage 1
does with the stage-5 params.
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
from emox.train import stages as jstages
from emox_torch.diffusion import schedule as tschedule
from emox_torch.models.emo import EMOModel
from emox_torch.train import Trainer, sample_draws, stage_loss_fn, trainable_mask
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_train import _port_leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


def _configs():
    jm, _, tcfg = model_params("tiny")
    train = dict(stage=5, compute_dtype="float32", vae_kl_weight=1e-2)  # a KL term the gradients can see
    return tuple(c.replace(train=dataclasses.replace(c.train, **train)) for c in (jm.config, tcfg))


def _batch(kind: str, batch: int = 2):
    rng = np.random.default_rng(50)
    if kind == "images":
        return {"images": rng.uniform(-1, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32)}
    return {"frames": rng.uniform(-1, 1, (batch, FRAMES, IMAGE, IMAGE, 3)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _reference(kind: str):
    from emox.models.emo import EMOModel as JEMOModel

    _, params, _ = model_params("tiny")
    jcfg, _ = _configs()
    jm = JEMOModel(jcfg)
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), 5)
    key = jax.random.PRNGKey(5)
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), batch, key)
    n = (batch["images"] if kind == "images" else batch["frames"].reshape(-1, IMAGE, IMAGE, 3)).shape[0]
    lat = IMAGE // jcfg.vae.downscale
    eps = jax.random.normal(key, (n, lat, lat, jcfg.vae.latent_channels))  # the VAE's own draw
    return np.array(eps), float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("kind", ["images", "frames"])
def test_stage5_loss_and_grads_match_the_reference(kind):
    eps, want_loss, want_metrics, want_grads = _reference(kind)
    _, params, _ = model_params("tiny")
    _, tcfg = _configs()
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, 5)
    model.set_trainable(mask)
    sched = tschedule.make_schedule(tcfg.diffusion)
    batch = {k: torch.from_numpy(v) for k, v in _batch(kind).items()}
    draws = sample_draws(tcfg, sched, 5, batch, torch.Generator().manual_seed(0))
    assert set(draws) == {"posterior_eps"} and draws["posterior_eps"].shape == eps.shape
    loss, metrics = stage_loss_fn(model, tcfg, sched, 5)(batch, {"posterior_eps": torch.from_numpy(eps)})
    assert set(metrics) == set(want_metrics) == {"loss", "recon_mse", "recon_l1", "kl", "latent_std"}
    for k, v in metrics.items():
        assert abs(v.item() - want_metrics[k]) <= LOSS_TOL * abs(want_metrics[k]), k
    assert abs(loss.item() - want_loss) <= LOSS_TOL * abs(want_loss)
    params_t = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    assert names and all(n.startswith("vae.") for n in names)
    grads = torch.autograd.grad(loss, [params_t[n] for n in names])
    want = _port_leaves(want_grads)
    got_flat = torch.cat([g.reshape(-1) for g in grads]).double()
    want_flat = torch.cat([torch.from_numpy(want[n]).reshape(-1) for n in names]).double()
    assert float(want_flat.norm()) > 0
    assert float((got_flat - want_flat).norm() / want_flat.norm()) <= GRAD_TOL


def test_vae_forward_samples_the_posterior_with_eps():
    """AutoencoderKL.forward decodes mean + std * eps when eps is given and
    the posterior mean otherwise (the reference's key / no key)."""
    _, params, tcfg = model_params("tiny")
    vae = EMOModel(tcfg, device="cpu").load_flax(params).modules.vae
    x = torch.from_numpy(_batch("images")["images"])
    with torch.no_grad():
        mode_img, dist = vae(x)
        eps = torch.randn(dist.mean.shape, generator=torch.Generator().manual_seed(1))
        sample_img, _ = vae(x, eps=eps)
        assert torch.equal(mode_img, vae.decode(dist.mean))
        assert torch.equal(sample_img, vae.decode(dist.mean + dist.std * eps))


def _trainer(tmp_path, stage: int) -> Trainer:
    _, params, tcfg = model_params("tiny")
    cfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, stage=stage, compute_dtype="float32", checkpoint_dir=str(tmp_path), learning_rate=1e-3,
        checkpoint_every=2, log_every=1))
    return Trainer(cfg, model=EMOModel(cfg, device="cpu", seed=stage).load_flax(params) if stage == 5
                   else EMOModel(cfg, device="cpu", seed=stage))


def test_stage5_chains_into_stage1(tmp_path):
    """Stage 5 trains the VAE alone and checkpoints it under stage5/; stage 1
    starts from that checkpoint (load_params_from_stage(5)) and holds the
    pretrained VAE frozen, bit for bit, through its steps, as the
    reference's stage 1 does with the stage-5 params."""
    rng = np.random.default_rng(51)
    img = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    t5 = _trainer(tmp_path, 5)
    before = {n: p.detach().clone() for n, p in t5.model.modules.named_parameters()}
    metrics = t5.fit(iter([{"images": img(2, IMAGE, IMAGE, 3)} for _ in range(2)]), num_steps=2)
    assert np.isfinite(metrics["loss"]) and metrics["latent_std"] > 0
    changed = {n for n, p in t5.model.modules.named_parameters() if not torch.equal(p, before[n])}
    assert changed and all(n.startswith("vae.") for n in changed)
    assert t5.ckpt.directory.endswith("stage5") and t5.ckpt.latest_step() == 2
    vae5 = {n: p.detach().clone() for n, p in t5.model.modules.vae.named_parameters()}

    t1 = _trainer(tmp_path, 1)
    assert t1.load_params_from_stage(5)
    for n, p in t1.model.modules.vae.named_parameters():
        assert torch.equal(p, vae5[n]), n
    batch = {"images": img(2, IMAGE, IMAGE, 3), "ref_image": img(2, IMAGE, IMAGE, 3)}
    m1 = t1.fit(iter([batch, batch]), num_steps=2)
    assert np.isfinite(m1["loss"])
    for n, p in t1.model.modules.vae.named_parameters():
        assert torch.equal(p, vae5[n]), n
    assert not any(n.startswith("vae.") for n in t1.trainable_names())
    for t in (t5, t1):
        t.close()


def test_stage5_launches_match_the_code(monkeypatch, tmp_path):
    """chip_smoke.stage05_launches against the attention calls one stage-5
    train step makes on the packed kernel's route: a VAE whose mid-attention
    is one head of dim 512 (test_torch_512's cut of the flagship VAE), the
    K/V cutoff lowered to its latent tokens: one forward and one backward at
    the encoder's and at the decoder's mid-attention."""
    import chip_smoke
    from emox_torch.core.config import VAEConfig
    from emox_torch.ops import attention as tattn
    from tests.test_torch_512 import VAE_512, VAE_IMAGE, _count_routes

    calls = _count_routes(monkeypatch, cutoff=(VAE_IMAGE // 2) ** 2)
    calls["flash_attn_nlc_bwd"] = 0
    bwd = tattn.flash_attention_nlc_bwd

    def counted(*a, **kw):
        calls["flash_attn_nlc_bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_nlc_bwd", counted)
    _, tcfg = _configs()
    cfg = tcfg.replace(vae=VAEConfig(**VAE_512, sample_size=VAE_IMAGE),
                       train=dataclasses.replace(tcfg.train, checkpoint_dir=str(tmp_path)))
    tr = Trainer(cfg, model=EMOModel(cfg, device="cpu"))
    images = torch.from_numpy(np.random.default_rng(52).uniform(-1, 1, (2, VAE_IMAGE, VAE_IMAGE, 3)).astype(np.float32))
    assert np.isfinite(float(tr.train_step({"images": images}, torch.Generator().manual_seed(0))["loss"]))
    want = chip_smoke.stage05_launches(5)
    assert calls == {k: want[k] for k in calls} == {"flash_attn_nlc_fwd": 2, "flash_attn_fwd": 0, "flash_attn_nlc_bwd": 2}
    assert sum(chip_smoke.stage05_launches(0).values()) == 0
    tr.close()
