"""The whole model under the fused-norm switches against the reference, on
the CPU: EMOX_GROUPNORM_IMPL (pallas or fast), EMOX_LN_QKV=1 and
EMOX_FUSED_QKV=1 together.

The port reads the switches at call time and runs its kernels' plain
versions here; the reference, which reads them when it traces, is given
"pallas_interpret" / "fast_interpret" for its GroupNorm kernels on the CPU
(its LN + q/k/v kernel interprets itself off the TPU). The tiny preset's
seeded param tree goes into both. Tolerances as tests/test_torch_models.py
(predict_noise <= 1e-5 relative L2) and tests/test_torch_train.py (stage-2
loss <= 1e-5, trainable gradients <= 1e-5 relative L2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.diffusion import schedule as jschedule
from emox.models.emo import EMOModel as JEMOModel
from emox.train import stages as jstages
from emox_torch.diffusion import schedule as tschedule
from emox_torch.models.emo import EMOModel
from emox_torch.nn import attention_blocks as tab
from emox_torch.ops import groupnorm as tgn
from emox_torch.ops import ln_qkv as tln
from emox_torch.train import stage_loss_fn, trainable_mask
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_models import TOL, _inputs, _pair, _t
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, _batch, _loss_configs, _port_leaves, _reference_draws


def _switch(monkeypatch, side: str, gn: str) -> None:
    """All three switches on; the GroupNorm impl named for `side`."""
    monkeypatch.setenv("EMOX_GROUPNORM_IMPL", f"{gn}_interpret" if side == "ref" else gn)
    monkeypatch.setenv("EMOX_LN_QKV", "1")
    monkeypatch.setenv("EMOX_FUSED_QKV", "1")


def _count_paths(monkeypatch) -> dict:
    """Count the port's calls of each GroupNorm path and of the two fused
    projections."""
    calls = dict.fromkeys(("xla", "pallas", "fast", "ln_qkv", "fused_qkv"), 0)

    def count(label, fn):
        def run(*a, **kw):
            calls[label] += 1
            return fn(*a, **kw)
        return run

    for mod, name, label in ((tgn, "group_norm_xla", "xla"), (tgn, "group_norm_plain", "pallas"),
                             (tgn, "group_norm_stats_plain", "fast"), (tln, "ln_qkv_plain", "ln_qkv"),
                             (tab, "_fused_qkv_apply", "fused_qkv")):
        monkeypatch.setattr(mod, name, count(label, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("gn", ["pallas", "fast"])
def test_predict_noise_under_the_switches(monkeypatch, gn):
    """The reader with reference banks (CFG drop on one row), audio, speeds
    and the face mask, and the VAE encode before it, under all three
    switches."""
    _, jm, params, tm = _pair("tiny")
    x = _inputs(jm.config, seed=7)
    lat = IMAGE // jm.config.vae.downscale
    drop = np.array([True, False])
    _switch(monkeypatch, "ref", gn)
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    audio = jm.encode_audio(params, jnp.asarray(x["wav"]), FRAMES)
    face = jm.encode_face_mask(params, jnp.asarray(x["mask"]), lat)
    want = jm.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref,
                            audio_windows=audio, speeds=jnp.asarray(x["speeds"]), face_feat=face,
                            ref_dropout=jnp.asarray(drop))
    _switch(monkeypatch, "port", gn)
    calls = _count_paths(monkeypatch)
    ref_t = tm.encode_images(_t(x["images"]))
    assert rel_err(ref_t, ref) <= TOL
    got = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), ref_t,
                           audio_windows=tm.encode_audio(_t(x["wav"]), FRAMES), speeds=_t(x["speeds"]),
                           face_feat=tm.encode_face_mask(_t(x["mask"]), lat), ref_dropout=_t(drop))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    # every GroupNorm took the switch's kernel path (its plain version here),
    # every bias-free self-attention the LN + q/k/v one, the biased ones (VAE
    # mid-attention, audio encoder) the concatenated projection
    assert calls["xla"] == 0 and calls["pallas" if gn == "pallas" else "fast"] > 0, calls
    assert calls["ln_qkv"] > 0 and calls["fused_qkv"] > 0, calls


def test_stage2_loss_and_grads_under_the_switches(monkeypatch):
    """The stage-2 loss (motion frames, v-prediction, CFG dropout) and its
    trainable gradients, with the reference's own draws, against
    jax.value_and_grad of the reference's loss under the same switches
    (GroupNorm "pallas"): the kernels' autograd functions recompute their
    backward through the plain formulas, as the reference's custom VJPs do."""
    stage = 2
    _, params, _ = model_params("tiny")
    jcfg, tcfg = _loss_configs(stage)
    _switch(monkeypatch, "ref", "pallas")
    jm = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), stage)
    key = jax.random.PRNGKey(100 + stage)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(stage).items()}
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jbatch, key)

    _switch(monkeypatch, "port", "pallas")
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    mask = trainable_mask(model.modules, stage)
    model.set_trainable(mask)
    loss, _ = stage_loss_fn(model, tcfg, tschedule.make_schedule(tcfg.diffusion), stage)(
        {k: torch.from_numpy(v) for k, v in _batch(stage).items()}, _reference_draws(jcfg, stage, _batch(stage), key))
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    params_t = dict(model.modules.named_parameters())
    names = [n for n, m in mask.items() if m]
    grads = torch.autograd.grad(loss, [params_t[n] for n in names], allow_unused=True)
    got = torch.cat([(torch.zeros_like(params_t[n]) if g is None else g).reshape(-1) for n, g in zip(names, grads)])
    want = _port_leaves(want_grads)
    want_flat = torch.cat([torch.from_numpy(want[n]).reshape(-1) for n in names]).double()
    assert float(want_flat.norm()) > 0
    assert float((got.double() - want_flat).norm() / want_flat.norm()) <= GRAD_TOL
