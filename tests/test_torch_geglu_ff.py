"""The port's GEGLU feed-forward without LN or residual (K6) and its FF impl
switch against the reference's, on the CPU.

`geglu_ff_plain` (what `fused_geglu_ff` runs for CPU tensors) is held
against the reference's `_ff_kernel` in interpret mode, and the autograd
function's backward against jax.grad through it. Then the dispatcher
`geglu_ff` with each of the reference's impl names and EMOX_FF_IMPL,
GEGLUFeedForward(impl=...), the FF sub-layer under EMOX_FF_IMPL=xla, and the
tiny model's predict_noise under it. Tolerances: float32 <= 1e-5 relative
L2 (gradients <= 1e-4), bf16 two bf16 steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.nn import attention_blocks as jab
from emox.ops import ff as jff
from emox_torch import ops
from emox_torch.nn import attention_blocks as tab
from emox_torch.ops import ff as tff
from tests.test_torch_bridge import flax_module_params, no_kernel_launches, torch_module  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, _ff_inputs, j, rel, t

GRAD_TOL = 1e-4
IMPLS = ("auto", "fused", "fused_interpret", "xla")


def _ref_args(p, dtype=jnp.float32):
    """The reference's layout: flax kernels w1 [C, 2F], w2 [F, C]."""
    return tuple(j(p[k], dtype) for k in ("x", "w1", "b1", "w2", "b2"))


def _port_args(p, dtype=torch.float32):
    """The port's layout: Linear weights w1 [2F, C], w2 [C, F]."""
    return (t(p["x"], dtype), t(p["w1"].T.copy(), dtype), t(p["b1"], dtype), t(p["w2"].T.copy(), dtype),
            t(p["b2"], dtype))


@pytest.mark.parametrize("m,c", [(200, 64), (37, 32), (64, 128)], ids=["m200_c64", "ragged_m37", "c128"])
def test_plain_matches_pallas_interpret(m, c):
    p = _ff_inputs(m, c, seed=20)
    want = jff.fused_geglu_ff(*_ref_args(p), block_m=64, interpret=True)
    for got in (tff.geglu_ff_plain(*_port_args(p)), ops.fused_geglu_ff(*_port_args(p))):
        assert got.shape == want.shape
        assert rel(got, want) <= FP32_TOL
    assert rel(ops.geglu_ff_xla(*_port_args(p)), jff.geglu_ff_xla(*_ref_args(p))) <= FP32_TOL


def test_plain_bf16():
    """bf16: the gated activation rounded to bf16 before the fp32 product
    with W2, the output rounded once, as the TPU kernel does (its erf
    approximation can move a value across a bf16 rounding boundary)."""
    p = _ff_inputs(128, 64, seed=21)
    want = jff.fused_geglu_ff(*_ref_args(p, jnp.bfloat16), block_m=64, interpret=True)
    got = ops.fused_geglu_ff(*_port_args(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_TOL


def test_grads_match_jax_grad():
    """The autograd function (plain forward on CPU tensors, backward by
    recompute through geglu_ff_xla, as the reference's `_ff_bwd`) against
    jax.grad through the reference's kernel in interpret mode, for x and all
    four weights."""
    p = _ff_inputs(48, 32, seed=22)
    w = np.random.default_rng(23).standard_normal((48, 32)).astype(np.float32)
    loss = lambda *a: jnp.sum(jff.fused_geglu_ff(*a, block_m=16, interpret=True) * w)
    want = jax.grad(loss, argnums=tuple(range(5)))(*_ref_args(p))
    args = [a.requires_grad_() for a in _port_args(p)]
    y = ops.fused_geglu_ff(*args)
    assert type(y.grad_fn).__name__ == "_GegluFFBackward"
    got = torch.autograd.grad((y * t(w)).sum(), args)
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        b = np.asarray(b)
        assert rel(a, b.T if name in ("w1", "w2") else b) <= GRAD_TOL, name


def _spy(monkeypatch) -> dict:
    """Count the dispatcher's routes: the kernel's wrapper, its plain
    version called directly, the plain formula."""
    calls = dict.fromkeys(("fused_geglu_ff", "geglu_ff_plain", "geglu_ff_xla"), 0)

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(tff, name, count(name, getattr(tff, name)))
    return calls


@pytest.mark.parametrize("impl", IMPLS)
def test_dispatcher_routes_like_the_reference(monkeypatch, impl):
    """geglu_ff(impl=...) takes the route the impl names and computes what
    the reference's geglu_ff computes under the same name (its "auto" and
    "fused" interpret the Pallas kernel off the TPU)."""
    p = _ff_inputs(40, 64, seed=24)
    want = jff.geglu_ff(*_ref_args(p), impl=impl)
    calls = _spy(monkeypatch)
    got = tff.geglu_ff(*_port_args(p), impl=impl)
    assert rel(got, want) <= FP32_TOL
    # the kernel's wrapper runs its plain version for these CPU tensors
    fused = dict(fused_geglu_ff=1, geglu_ff_plain=1, geglu_ff_xla=0)
    assert calls == {"auto": fused, "fused": fused,
                     "fused_interpret": dict(fused_geglu_ff=0, geglu_ff_plain=1, geglu_ff_xla=0),
                     "xla": dict(fused_geglu_ff=0, geglu_ff_plain=0, geglu_ff_xla=1)}[impl]


def test_default_impl_resolution(monkeypatch):
    """EMOX_FF_IMPL when set, else "auto" with a card and "xla" without, as
    the reference resolves by platform; an unknown name raises on both."""
    monkeypatch.delenv("EMOX_FF_IMPL", raising=False)
    assert tff.ff_default_impl() == jff._default_impl() == "xla"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tff.ff_default_impl() == "auto"
    for value in IMPLS:
        monkeypatch.setenv("EMOX_FF_IMPL", value)
        assert tff.ff_default_impl() == jff._default_impl() == value
    monkeypatch.setenv("EMOX_FF_IMPL", "bogus")
    p = _ff_inputs(8, 32, seed=25)
    with pytest.raises(ValueError, match="unknown ff impl 'bogus'"):
        tff.geglu_ff(*_port_args(p))
    with pytest.raises(ValueError, match="unknown ff impl 'bogus'"):
        jff.geglu_ff(*_ref_args(p))


def test_wrapper_checks_before_launching():
    x, w1, b1, w2, b2 = _port_args(_ff_inputs(16, 32, seed=26))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tff._geglu_kernel(x.half(), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="in x's type"):
        tff._geglu_kernel(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="C % 4"):
        tff._geglu_kernel(x[:, :22], w1[:, :22], b1, w2[:22], b2[:22])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.fused_geglu_ff(x.to("meta"), w1, b1, w2, b2)


@pytest.mark.parametrize("env", [None, "fused"], ids=["impl_arg", "env_fused"])
def test_module_matches_the_reference(monkeypatch, env):
    """GEGLUFeedForward(impl="fused") against the reference's module with
    impl="fused_interpret" on bridged weights; with EMOX_FF_IMPL=fused the
    port's module with no impl takes the same route."""
    x = (0.5 * np.random.default_rng(27).standard_normal((2, 10, 32))).astype(np.float32)
    jmod = jab.GEGLUFeedForward(impl="fused_interpret")
    params = flax_module_params(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    if env:
        monkeypatch.setenv("EMOX_FF_IMPL", env)
    calls = _spy(monkeypatch)
    tmod = torch_module(tab.GEGLUFeedForward(32, impl=None if env else "fused"), params)
    with torch.no_grad():
        got = tmod(t(x))
    assert rel(got, want) <= FP32_TOL
    assert calls["fused_geglu_ff"] == 1 and calls["geglu_ff_xla"] == 0


def test_ff_sublayer_under_xla_takes_the_plain_route(monkeypatch):
    """TransformerBlock under EMOX_FF_IMPL=xla: the FF sub-layer is the
    plain LayerNorm + geglu_ff_xla (no call of the fused op), and the block
    matches the reference's under the same switch; unset, the fused op runs
    as before."""
    rng = np.random.default_rng(28)
    x = (0.4 * rng.standard_normal((2, 12, 64))).astype(np.float32)
    jmod = jab.TransformerBlock(heads=2, head_dim=32, use_cross=False)
    params = flax_module_params(jmod, jnp.asarray(x))
    tmod = torch_module(tab.TransformerBlock(64, 2, 32, use_cross=False), params)
    fused = {"n": 0}

    def spy(*a, **kw):
        fused["n"] += 1
        return tff.fused_ln_geglu_ff(*a, **kw)

    monkeypatch.setattr(tab, "fused_ln_geglu_ff", spy)
    calls = _spy(monkeypatch)
    monkeypatch.delenv("EMOX_FF_IMPL", raising=False)
    with torch.no_grad():
        default, _ = tmod(t(x))
    assert fused["n"] == 1 and calls["geglu_ff_xla"] == 0
    monkeypatch.setenv("EMOX_FF_IMPL", "xla")
    want, _ = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tmod(t(x))
    assert fused["n"] == 1 and calls["geglu_ff_xla"] == 1
    assert rel(got, want) <= FP32_TOL and rel(default, want) <= FP32_TOL


def test_predict_noise_under_xla(monkeypatch):
    """The tiny model's predict_noise (reader with reference banks and a CFG
    drop, audio, speeds, face mask) under EMOX_FF_IMPL=xla against the
    reference's under it: every FF sub-layer takes the plain formulas."""
    from tests.test_torch_bridge import FRAMES, IMAGE, rel_err
    from tests.test_torch_models import TOL, _inputs, _pair, _t

    _, jm, params, tm = _pair("tiny")
    x = _inputs(jm.config, seed=29)
    lat = IMAGE // jm.config.vae.downscale
    drop = np.array([True, False])
    monkeypatch.setenv("EMOX_FF_IMPL", "xla")
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    audio = jm.encode_audio(params, jnp.asarray(x["wav"]), FRAMES)
    face = jm.encode_face_mask(params, jnp.asarray(x["mask"]), lat)
    want = jm.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref,
                            audio_windows=audio, speeds=jnp.asarray(x["speeds"]), face_feat=face,
                            ref_dropout=jnp.asarray(drop))
    calls = _spy(monkeypatch)
    got = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), tm.encode_images(_t(x["images"])),
                           audio_windows=tm.encode_audio(_t(x["wav"]), FRAMES), speeds=_t(x["speeds"]),
                           face_feat=tm.encode_face_mask(_t(x["mask"]), lat), ref_dropout=_t(drop))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    assert calls["geglu_ff_xla"] > 0 and calls["fused_geglu_ff"] == calls["geglu_ff_plain"] == 0
