"""Gradient accumulation after a non-finite micro-step, held micro-step by
micro-step against the reference's optax chain
MultiSteps(apply_if_finite(chain(clip_by_global_norm, adamw(schedule)),
max_consecutive_errors=10)).

optax.MultiSteps resets a window's running mean as (1 - emit) * acc, so a
NaN or an inf (which 0 * inf turns into NaN) stays in every later window:
apply_if_finite skips ten windows, and the eleventh is applied and turns
the parameters NaN. Before that, on the last non-final micro-step, the
inner chain has already given up and MultiSteps' 0 * update puts NaN in
the parameters. The port's Optimizer must do the same, NaN positions
included, on the tiny preset's optimizer settings (lr 0.1, accumulation
2), over 24 micro-steps. Parameters agree to <= 1e-6 (float32 sums in
another order), as tests/test_torch_train.py's optimizer test.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emox.train.trainer import make_optimizer as j_make_optimizer
from emox_torch.train import make_optimizer
from tests.test_torch_bridge import configs

OPT_TOL = 1e-6
MICRO_STEPS = 24
SHAPES = [(3, 4), (5,)]


def _reference_applied(state) -> bool:
    """Whether the reference's last micro-step applied an update: it ended a
    window and apply_if_finite took it (finite, or past 10 in a row)."""
    guard = state.inner_opt_state
    return bool(state.mini_step == 0) and bool(guard.last_finite or guard.notfinite_count > 10)


@pytest.mark.parametrize("bad, at", [(np.nan, 0), (np.nan, 1), (np.inf, 3)],
                         ids=["nan_at_0", "nan_at_1", "inf_at_3"])
def test_accumulation_matches_optax_after_a_nonfinite_micro_step(bad, at):
    jcfg, tcfg = configs("tiny")
    train = dict(learning_rate=0.1, weight_decay=0.05, warmup_steps=2, num_steps=6,
                 gradient_accumulation=2, grad_clip_norm=1.0)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **train))
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **train))
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jopt = j_make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    masters = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(tcfg, masters)
    want, got = [], []
    for i in range(MICRO_STEPS):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        if i == at:
            grads[0][0, 0] = bad
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(_reference_applied(jstate))
        got.append(topt.step([torch.from_numpy(g.copy()) for g in grads]))
        for m, p in zip(masters, jparams):
            np.testing.assert_allclose(m.numpy(), np.asarray(p), rtol=OPT_TOL, atol=OPT_TOL, equal_nan=True,
                                       err_msg=f"micro-step {i}")
    assert got == want
    # the non-finite windows are skipped ten times, then applied
    assert sum(want) < MICRO_STEPS // 2
    assert all(np.isnan(np.asarray(p)).all() for p in jparams)
