"""Adafactor and train.frozen_dtype="param" against the reference, on the CPU.

The port's Optimizer with train.optimizer="adafactor" is stepped side by
side with the reference's optax chain
MultiSteps(apply_if_finite(chain(clip_by_global_norm, adafactor(schedule,
weight_decay_rate)))) on the same gradients (as tests/test_torch_accumulation.py
does for AdamW). The parameters live in the flax layout on the reference's
side and in the port's (Dense [O, I], Conv OIHW, 1-D Conv (O, I, k)) on the
port's, so every leaf must be factored over the dims the reference factors:
factored and unfactored leaves, both orientations of a Dense kernel, Conv
kernels, equal dims, warm-up with weight decay, gradient accumulation 3, a
non-finite micro-step (whose NaN spreads through the factored moments and
the block RMS as the reference's does). Masters <= 1e-5 relative after at
least 8 updates; the optimizer's state survives a state_dict round trip.

frozen_dtype="param": with bf16 compute the trainer keeps fp32 copies of
the frozen leaves, checkpoints them with the values of the reference's
_place_params, and a later stage that unfreezes a leaf starts from those
exact bits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emox.core.dtypes import policy_from_names
from emox.train import stages as jstages
from emox.train.trainer import Trainer as JTrainer
from emox.train.trainer import make_optimizer as j_make_optimizer
from emox_torch.models.emo import EMOModel
from emox_torch.nn.layers import Conv, Dense
from emox_torch.train import Trainer, make_optimizer
from emox_torch.train.trainer import Adafactor, flax_layouts
from tests.test_torch_bridge import configs, model_params, no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_identity import port_leaves

TOL = 1e-5
# (flax shape, the port's flax axis of each of its axes)
LEAVES = [
    ((160, 130), (1, 0)),  # Dense [I, O], factored over (O, I)
    ((130, 200), (1, 0)),  # the other orientation
    ((128, 128), (1, 0)),  # equal dims: np.argsort's order decides
    ((3, 3, 128, 144), (3, 2, 0, 1)),  # Conv HWIO, factored over (I, O)
    ((3, 3, 16, 300), (3, 2, 0, 1)),  # Conv, second-largest dim below 128: unfactored
    ((3, 130, 150), (2, 1, 0)),  # 1-D Conv (k, I, O)
    ((64, 40), (1, 0)),  # small Dense: unfactored
    ((200,), (0,)),  # bias
]


def _port(a: np.ndarray, axes) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, axes))


def _configs(**train):
    jcfg, tcfg = configs("tiny")
    train = dict(optimizer="adafactor", grad_clip_norm=1.0, **train)
    return (jcfg.replace(train=dataclasses.replace(jcfg.train, **train)),
            tcfg.replace(train=dataclasses.replace(tcfg.train, **train)))


def _pair(jcfg, tcfg, rng):
    params = [rng.standard_normal(s).astype(np.float32) * 0.05 for s, _ in LEAVES]
    params[-1][:] = 0.0  # a zero bias: the parameter scale's 1e-3 floor
    jopt = j_make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in params]
    masters = [torch.from_numpy(_port(p, ax)) for p, (_, ax) in zip(params, LEAVES)]
    topt = make_optimizer(tcfg, masters, [ax for _, ax in LEAVES])
    # one compiled update (the chain's many small programs compile once)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(*jopt.update(g, st, p)))
    return update, jparams, jopt.init(jparams), masters, topt


def _grads(rng, scale=1.0, bad=None):
    g = [(rng.standard_normal(s) * scale).astype(np.float32) for s, _ in LEAVES]
    if bad is not None:
        g[0][5, 7] = bad
    return g


def _step(update, jparams, jstate, topt, grads):
    # jnp.asarray reads a numpy array in place, and the jitted update runs
    # asynchronously; the port's step scales its gradients (the clip) and
    # writes its masters in place, on the same buffers where _port gives a
    # view. So the reference's update is waited for before the port's step.
    jparams, jstate = jax.block_until_ready(update([jnp.asarray(x) for x in grads], jstate, jparams))
    applied = topt.step([torch.from_numpy(_port(x, ax)) for x, (_, ax) in zip(grads, LEAVES)])
    return jparams, jstate, applied


def _check(masters, jparams, tol=TOL, what=""):
    for (_, ax), m, p in zip(LEAVES, masters, jparams):
        want = _port(np.asarray(p), ax)
        got = m.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want)), what
        ok = ~np.isnan(want)
        err = np.linalg.norm((got - want)[ok]) / max(np.linalg.norm(want[ok]), 1e-30)
        assert err <= tol, (what, err)


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for s, _ in LEAVES + [((128, 127), None), ((5, 256, 256), None), ((256,), None)]:
        assert Adafactor.factored_dims(s) == _factored_dims(s, True, 128), s


def test_adafactor_needs_the_flax_layouts():
    """Without the flax layouts a leaf would be factored over the port's
    dims, not the reference's: adafactor refuses, AdamW does not need them."""
    _, tcfg = _configs()
    masters = [torch.zeros(_port(np.zeros(s, np.float32), ax).shape) for s, ax in LEAVES]
    with pytest.raises(ValueError, match="pass layouts"):
        make_optimizer(tcfg, masters)
    with pytest.raises(ValueError, match="one flax layout per tensor"):
        Adafactor(masters, [ax for _, ax in LEAVES][:-1])
    adamw = tcfg.replace(train=dataclasses.replace(tcfg.train, optimizer="adamw"))
    assert make_optimizer(adamw, masters).adamw is not None


@pytest.mark.parametrize("accumulate,warmup,decay", [(1, 0, 0.0), (1, 3, 0.01), (3, 2, 0.0)],
                         ids=["constant", "warmup_decay", "accumulation_3"])
def test_adafactor_matches_optax(accumulate, warmup, decay):
    """10 updates (30 micro-steps at accumulation 3), some clipped by the
    global norm, the learning rate through warm-up and cosine decay."""
    jcfg, tcfg = _configs(learning_rate=0.05, warmup_steps=warmup, num_steps=10, weight_decay=decay,
                          gradient_accumulation=accumulate)
    rng = np.random.default_rng(7)
    jopt, jparams, jstate, masters, topt = _pair(jcfg, tcfg, rng)
    applied = []
    for i in range(10 * accumulate):
        grads = _grads(rng, scale=(0.01 if i % 4 == 1 else 0.2))
        jparams, jstate, a = _step(jopt, jparams, jstate, topt, grads)
        applied.append(a)
        _check(masters, jparams, what=f"micro-step {i}")
    assert sum(applied) == topt.count == 10
    # the factored leaves hold row and column moments, the rest full ones
    assert [d is not None for d in topt.adafactor.dims] == [True, True, True, True, False, True, False, False]


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_nonfinite_micro_step_under_accumulation_matches_optax(bad):
    """A non-finite gradient at micro-step 1 stays in every later window:
    apply_if_finite skips ten windows, then gives up; the eleventh window's
    mid micro-steps already put 0 * the chain's update into the masters, NaN
    wherever the chain's arithmetic spreads it, positions checked at every
    micro-step. Two finite windows come first."""
    jcfg, tcfg = _configs(learning_rate=0.05, warmup_steps=0, num_steps=20, gradient_accumulation=3)
    rng = np.random.default_rng(8)
    jopt, jparams, jstate, masters, topt = _pair(jcfg, tcfg, rng)
    for i in range(6):  # two finite windows
        jparams, jstate, _ = _step(jopt, jparams, jstate, topt, _grads(rng, 0.2))
    for i in range(39):
        jparams, jstate, _ = _step(jopt, jparams, jstate, topt, _grads(rng, 0.2, bad=bad if i == 1 else None))
        _check(masters, jparams, what=f"micro-step {i}")
    # the window's reset turns an inf into NaN, and a NaN global norm every leaf
    assert all(np.isnan(np.asarray(p)).all() for p in jparams)


def test_state_dict_round_trip():
    """Stepped 4 times, saved, loaded into a fresh optimizer on copies of the
    masters: both give the same bits over 4 more updates."""
    _, tcfg = _configs(learning_rate=0.05, warmup_steps=2, num_steps=10, weight_decay=0.01,
                       gradient_accumulation=2)
    rng = np.random.default_rng(9)
    masters = [torch.from_numpy(_port(rng.standard_normal(s).astype(np.float32), ax)) for s, ax in LEAVES]
    layouts = [ax for _, ax in LEAVES]
    a = make_optimizer(tcfg, masters, layouts)
    port_grads = lambda: [torch.from_numpy(_port(g, ax)) for g, (_, ax) in zip(_grads(rng, 0.2), LEAVES)]
    for _ in range(9):
        a.step(port_grads())
    state = a.state_dict()
    copies = [m.clone() for m in masters]
    b = make_optimizer(tcfg, copies, layouts)
    b.load_state_dict(state)
    for _ in range(8):
        g = port_grads()
        a.step([x.clone() for x in g])
        b.step(g)
    assert a.count == b.count == 8
    for m, c in zip(masters, copies):
        assert torch.equal(m, c)


# ---- the trainer ------------------------------------------------------------------------
def _trainer_config(tcfg, tmp_path, stage=2, **train):
    return tcfg.replace(train=dataclasses.replace(
        tcfg.train, stage=stage, checkpoint_dir=str(tmp_path), num_steps=2, checkpoint_every=2, log_every=1,
        learning_rate=1e-3, **train))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    size, frames = cfg.data.height, cfg.data.num_frames
    img = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    return {"ref_image": img(2, size, size, 3), "frames": img(2, frames, size, size, 3),
            "wav": torch.from_numpy((0.1 * rng.standard_normal((2, 16000 * (frames + 4) // 25))).astype(np.float32))}


def test_trainer_factors_leaves_in_the_flax_layout(tmp_path):
    """flax_layouts gives every Dense and Conv weight the bridge's transpose
    (so a leaf is factored as the reference factors it); a fit with
    adafactor trains, checkpoints and resumes its moments."""
    _, params, tcfg = model_params("tiny")
    cfg = _trainer_config(tcfg, tmp_path, optimizer="adafactor", compute_dtype="float32")
    tr = Trainer(cfg, model=EMOModel(cfg, device="cpu").load_flax(params))
    names = tr.trainable_names()
    for name, axes in zip(names, flax_layouts(tr.model.modules, names)):
        mod = tr.model.modules.get_submodule(name.rsplit(".", 1)[0])
        if name.endswith(".weight") and isinstance(mod, (Dense, Conv)):
            assert axes == {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[len(axes)]
        else:
            assert axes == tuple(range(len(axes)))
    # the reference factors exactly these leaves, at their flax shapes
    flax = port_leaves(params)
    want = [Adafactor.factored_dims(np.transpose(flax[n], np.argsort(ax)).shape) is not None
            for n, ax in zip(names, flax_layouts(tr.model.modules, names))]
    assert [d is not None for d in tr.state.optimizer.adafactor.dims] == want
    batch = _batch(cfg)
    before = {n: m.clone() for n, m in tr.state.masters.items()}
    tr.fit(iter([batch] * 2))
    assert any(not torch.equal(before[n], m) for n, m in tr.state.masters.items())
    adafactor_bytes = tr.state.optimizer.state_bytes()
    # the tiny preset has no leaf with two dims of 128: one full moment each
    assert adafactor_bytes == 4 * sum(m.numel() for m in tr.state.masters.values())
    tr2 = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, resume=True)),
                  model=EMOModel(cfg, device="cpu").load_flax(params))
    assert tr2.resume() == 2
    for x, y in zip(tr.state.optimizer.adafactor.v + tr.state.optimizer.adafactor.v_row,
                    tr2.state.optimizer.adafactor.v + tr2.state.optimizer.adafactor.v_row):
        assert (x is None and y is None) or torch.equal(x, y)
    tr.close()
    tr2.close()


def _placed(jcfg, params, stage):
    """The reference's _place_params of a flax tree: every floating leaf in
    the param dtype if trainable, else in train.frozen_dtype's."""
    ref = object.__new__(JTrainer)
    ref.config = jcfg
    ref.policy = policy_from_names(jcfg.train.param_dtype, jcfg.train.compute_dtype)
    tree = jax.tree.map(jnp.asarray, params)
    ref.mask = jstages.trainable_mask(tree, stage)
    return port_leaves(jax.tree.map(np.asarray, ref._place_params(tree)))


@pytest.mark.parametrize("frozen", ["param", "compute"])
def test_frozen_leaves_are_checkpointed_as_the_reference_places_them(frozen, tmp_path):
    """bf16 compute, stage 2: a model handed in fp32 (the flax tree's values)
    is cast to bf16 for the forward; after a step the checkpoint holds every
    frozen leaf as _place_params places it: fp32, the tree's own bits, under
    "param"; rounded to bf16 under "compute". A later stage (1) that
    unfreezes the reference net's leaves starts its masters from the saved
    bits."""
    jm, params, tcfg = model_params("tiny")
    train = dict(compute_dtype="bfloat16", frozen_dtype=frozen)
    jcfg = jm.config.replace(train=dataclasses.replace(jm.config.train, stage=2, **train))
    cfg = _trainer_config(tcfg, tmp_path, **train)
    tr = Trainer(cfg, model=EMOModel(cfg, device="cpu").load_flax(params))
    assert tr.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in tr.model.modules.parameters())
    tr.fit(iter([_batch(cfg)] * 2))
    saved = tr.ckpt.restore(2)["params"]
    want = _placed(jcfg, params, 2)
    frozen_names = [n for n, m in tr.mask.items() if not m]
    for n in frozen_names:
        w = torch.from_numpy(np.asarray(want[n].astype(np.float32)))
        assert saved[n].dtype == (torch.float32 if frozen == "param" else torch.bfloat16), n
        assert torch.equal(saved[n].float(), w), n
    # the modules hold the frozen leaves' bf16 rounding, as cast_to_compute gives
    own = dict(tr.model.modules.named_parameters())
    n = frozen_names[0]
    assert torch.equal(own[n], saved[n].to(torch.bfloat16))
    tr.close()
    later = Trainer(_trainer_config(tcfg, tmp_path, stage=1, **train), model=EMOModel(cfg, device="cpu"))
    assert later.load_params_from_stage(2)
    unfrozen = [n for n in later.trainable_names() if n in frozen_names]
    assert any(n.startswith("reference_net.") for n in unfrozen)
    for n in unfrozen:
        assert torch.equal(later.state.masters[n], saved[n].float()), n
    rounded = sum(not torch.equal(later.state.masters[n], saved[n].to(torch.bfloat16).float()) for n in unfrozen)
    assert (rounded > 0) == (frozen == "param")  # fp32 bits, not a bf16 rounding widened
    later.close()


def test_a_trainer_built_model_keeps_the_inits_fp32_values(tmp_path):
    """Without a model the trainer draws it in fp32 (the port's init) and
    casts it to bf16: the masters, and under frozen_dtype="param" the frozen
    copies, hold the init's fp32 values; the modules their bf16 rounding."""
    _, _, tcfg = model_params("tiny")
    cfg = _trainer_config(tcfg, tmp_path, compute_dtype="bfloat16", frozen_dtype="param")
    tr = Trainer(cfg, device="cpu")
    fp32 = dict(EMOModel(cfg, device="cpu", seed=cfg.train.seed).modules.named_parameters())
    own = dict(tr.model.modules.named_parameters())
    for n, m in tr.state.masters.items():
        assert m.dtype == torch.float32 and torch.equal(m, fp32[n]), n
    for n, f in tr.frozen.items():
        assert torch.equal(f, fp32[n]) and torch.equal(own[n], fp32[n].to(torch.bfloat16)), n
    assert set(tr.frozen) | set(tr.state.masters) == set(own)
    tr.close()
