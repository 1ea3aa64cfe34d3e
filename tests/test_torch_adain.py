"""The port's AdaIN reference statistics (model.use_gn_ref) against the
reference's.

The writer emits each attention site's fp32 spatial (mean, var) of its
activations; the reader renormalises its activations to them after each
spatial transformer, the uncond rows keeping style_fidelity of their own
statistics. Held at the tiny preset, float32: `_adain` itself, the writer's
banks, and the sampler under both CFG programs (the batched one and the
two-call one, which the reference deliberately leaves unequal under AdaIN)
and on the windowed sampler, each against the reference's own
generate_latents to <= 1e-5 relative L2.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.models import unet as junet
from emox.models.emo import EMOModel as JEMOModel
from emox_torch.models import unet as tunet
from emox_torch.models.emo import EMOModel
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_windowed import inputs, port_latents, reference_latents, windowed

TRAJ_TOL = 1e-5


def gn_ref(cfg, **inference):
    return windowed(cfg.replace(model=dataclasses.replace(cfg.model, use_gn_ref=True)), **inference)


@pytest.mark.parametrize("style_fidelity", [0.5, 1.0])
@pytest.mark.parametrize("drop", [None, [True, False]], ids=["no_drop", "cfg_drop"])
def test_adain_matches_reference(style_fidelity, drop):
    rng = np.random.default_rng(0)
    t = 3
    h = rng.standard_normal((2 * t, 4, 5, 8)).astype(np.float32) * 2 + 0.5
    stats = np.stack([rng.standard_normal((2, 1, 1, 8)), rng.uniform(0.1, 3, (2, 1, 1, 8))], -1).astype(np.float32)
    d = None if drop is None else np.repeat(np.array(drop), t)
    want = junet._adain(jnp.asarray(h), jnp.asarray(stats), t, style_fidelity, None if d is None else jnp.asarray(d))
    got = tunet._adain(torch.from_numpy(h), torch.from_numpy(stats), t, style_fidelity,
                       None if d is None else torch.from_numpy(d))
    assert rel_err(got, want) <= 1e-6


def test_writer_banks_match_reference():
    """reference_outputs_for_steps: the K/V banks and the AdaIN banks [S, B,
    1, 1, C, 2] of every site."""
    jm, params, tcfg = model_params("tiny")
    jcfg, tcfg = gn_ref(jm.config), gn_ref(tcfg)
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((1, IMAGE // 8, IMAGE // 8, 4)).astype(np.float32)
    ts = np.array([900, 500, 100])
    want_f, want_gn = JEMOModel(jcfg).reference_outputs_for_steps(params, jnp.asarray(ref), jnp.asarray(ts))
    got_f, got_gn = EMOModel(tcfg, device="cpu").load_flax(params).reference_outputs_for_steps(
        torch.from_numpy(ref), torch.from_numpy(ts))
    assert len(got_gn) == len(want_gn) == len(got_f)
    for g, w in zip(got_gn, want_gn):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (3, 1, 1, 1, w.shape[-2], 2)
        assert rel_err(g, w) <= TRAJ_TOL
    for gs, ws in zip(got_f, want_f):
        for g, w in zip(gs, ws):
            assert rel_err(g, w) <= TRAJ_TOL


@pytest.mark.parametrize("frames,cfg_batching", [(3, True), (3, False), (7, True)],
                         ids=["batched", "two_call", "windowed_batched"])
def test_gn_ref_trajectory_matches_reference(frames, cfg_batching):
    """Each CFG program against its own counterpart: the batched program
    doubles the banks, the two-call one runs its uncond call with no
    reference and no AdaIN; the windowed sampler repeats them per window."""
    jm, params, tcfg = model_params("tiny")
    jcfg, tcfg = gn_ref(jm.config, cfg_batching=cfg_batching), gn_ref(tcfg, cfg_batching=cfg_batching)
    req = inputs(tcfg, frames, seed=9)
    want = reference_latents(jcfg, params, req, frames)
    got = port_latents(tcfg, params, req, frames)
    assert rel_err(got, want) <= TRAJ_TOL
    # AdaIN moved the result: not the plain model's trajectory
    plain = port_latents(windowed(model_params("tiny")[2], cfg_batching=cfg_batching), params, req, frames)
    assert rel_err(plain, got) > 1e-3
