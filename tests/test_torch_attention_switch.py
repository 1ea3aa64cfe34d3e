"""The reference's attention switch in the port, on the CPU.

EMOX_ATTENTION_IMPL and the dispatchers' `impl` take the reference's names
("auto", "pallas", "pallas_interpret", "xla"; emox/ops/attention.py:815-893),
Attention(impl=...) passes its impl on, and a UNet whose config sets
flash_attention=False pins its attention to "xla" unless the variable is set
(emox/models/unet.py:125-129). Each route is spied on the port's side and
every value held against the reference at float32, 1e-5 relative L2; the
reference's kernels run in interpret mode. The GroupNorm interpret names
(EMOX_GROUPNORM_IMPL=pallas_interpret|fast_interpret) are held against the
reference's at the same tolerance.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.models.emo import EMOModel as JEMOModel
from emox.ops import attention as jattn
from emox.ops import groupnorm as jgn
from emox_torch import ops
from emox_torch.models.emo import EMOModel
from emox_torch.nn.attention_blocks import Attention
from emox_torch.ops import attention as tattn
from tests.test_torch_bridge import FRAMES, IMAGE, configs, model_params, rel_err

TOL = 1e-5  # float32 on both sides, relative L2
SPIED = {"flash_attention_nlc": "packed", "flash_attention": "strided", "attention_nlc_plain": "packed_plain",
         "attention_plain": "strided_plain", "attention_xla": "xla"}


@pytest.fixture
def taken(monkeypatch):
    """The routes the port's dispatchers take, in call order (a kernel's
    wrapper on a CPU tensor then also runs its plain version)."""
    calls = []

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(SPIED[name])
            return fn(*a, **kw)
        return run

    for name in SPIED:
        monkeypatch.setattr(tattn, name, spy(name, getattr(tattn, name)))
    monkeypatch.setattr(tattn, "KERNEL_MIN_KV", 64)  # the reference's cutoff is lowered to match
    monkeypatch.setattr(jattn, "_PALLAS_MIN_KV", 64)
    return calls


def _reference(q, k, v, heads, impl, lk):
    """The reference's dispatcher on the same inputs, its kernels interpreted
    where the port's route takes a kernel."""
    impl = {"pallas": "pallas_interpret", "auto": "pallas_interpret" if lk >= 64 else "xla"}.get(impl, impl)
    return jattn.dot_product_attention_nlc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, impl=impl)


# impl -> (route at d 64, route at d 40), for Lk below and at the lowered cutoff
ROUTES = {
    "auto": {16: ("xla", "xla"), 64: ("packed", "strided")},
    "pallas": {16: ("packed", "strided"), 64: ("packed", "strided")},
    "pallas_interpret": {16: ("packed_plain", "strided_plain"), 64: ("packed_plain", "strided_plain")},
    "xla": {16: ("xla", "xla"), 64: ("xla", "xla")},
}
CASES = [(impl, lk, d, how) for impl in ROUTES for lk in (16, 64) for d in (64, 40) for how in ("env", "arg")]


@pytest.mark.parametrize("impl,lk,d,how", CASES, ids=[f"{i}-lk{lk}-d{d}-{h}" for i, lk, d, h in CASES])
def test_switch_routes_like_the_reference(monkeypatch, taken, impl, lk, d, how):
    """Under each impl, by EMOX_ATTENTION_IMPL or by `impl=`, the port's
    dot_product_attention_nlc takes the reference's route: a kernel (its
    plain version on CPU tensors) under "pallas" at every Lk and under
    "auto" from the cutoff on, the packed one for d % 64 == 0 and the strided
    one on head-split views otherwise; the plain versions under
    "pallas_interpret"; attention_xla under "xla". Values match the
    reference's dispatcher."""
    rng = np.random.default_rng(21)
    n, lq, heads = 2, 24, 2
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    if how == "env":
        monkeypatch.setenv("EMOX_ATTENTION_IMPL", impl)
        got = tattn.dot_product_attention_nlc(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    else:
        monkeypatch.setenv("EMOX_ATTENTION_IMPL", "xla")  # the argument beats the variable
        got = tattn.dot_product_attention_nlc(*(torch.from_numpy(a) for a in (q, k, v)), heads, impl=impl)
    assert taken[0] == ROUTES[impl][lk][0 if d == 64 else 1], taken
    assert rel_err(got, _reference(q, k, v, heads, impl, lk)) <= TOL


def test_pallas_reaches_a_kernel_at_lk_5(taken):
    """The audio sites' length: "pallas" takes the strided kernel (d 40) at
    Lk 5, where "auto" takes the plain path."""
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, l, 40)).astype(np.float32)) for l in (16, 5, 5))
    want = jattn.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True)
    assert rel_err(tattn.dot_product_attention(q, k, v, impl="pallas"), want) <= TOL
    assert taken[0] == "strided"
    tattn.dot_product_attention(q, k, v, impl="auto")
    assert taken[-1] == "xla"


@pytest.mark.parametrize("value", ["triton", "PALLAS", "flash"])
def test_unknown_impl_raises(monkeypatch, value):
    """Any other name raises ValueError, from the variable and from impl=,
    in both dispatchers."""
    x = torch.zeros(1, 8, 64)
    xh = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match=f"unknown attention impl '{value}'"):
        tattn.dot_product_attention_nlc(x, x, x, 1, impl=value)
    with pytest.raises(ValueError, match=f"unknown attention impl '{value}'"):
        tattn.dot_product_attention(xh, xh, xh, impl=value)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", value)
    with pytest.raises(ValueError, match="EMOX_ATTENTION_IMPL"):
        tattn.dot_product_attention_nlc(x, x, x, 1)


def test_default_impl(monkeypatch):
    """EMOX_ATTENTION_IMPL when set, else "auto" with a CUDA card and "xla"
    without one, as the reference resolves by platform."""
    monkeypatch.delenv("EMOX_ATTENTION_IMPL", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ops.attention_default_impl() == "xla"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ops.attention_default_impl() == "auto"
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas_interpret")
    assert ops.attention_default_impl() == "pallas_interpret"


@pytest.mark.parametrize("module_impl,call_impl,route", [
    ("pallas_interpret", None, "packed_plain"), ("xla", None, "xla"), ("xla", "pallas", "packed"),
])
def test_attention_module_passes_its_impl(monkeypatch, taken, module_impl, call_impl, route):
    """Attention(impl=...) reaches the dispatcher (beating the variable), and
    an impl given to forward beats the module's."""
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas")
    torch.manual_seed(0)
    attn = Attention(64, heads=1, head_dim=64, impl=module_impl)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(0.1 * torch.randn(p.shape))
    x = torch.randn(2, 8, 64)
    want = Attention(64, heads=1, head_dim=64)
    want.load_state_dict(attn.state_dict())
    ref = want(x, impl="xla")
    taken.clear()
    got = attn(x, impl=call_impl)
    assert taken[0] == route
    assert rel_err(got, ref.detach().numpy()) <= TOL


def _unet_pair(flash: bool):
    """The tiny preset with model.flash_attention set, on both sides, with the
    cached tiny weights."""
    jm, params, _ = model_params("tiny")
    jcfg, tcfg = configs("tiny")
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, flash_attention=flash)) for c in (jcfg, tcfg))
    return JEMOModel(jcfg), params, EMOModel(tcfg, device="cpu", seed=1).load_flax(params)


@pytest.mark.parametrize("env,flash,routes", [
    (None, False, {"xla"}),
    ("pallas_interpret", False, {"packed_plain", "strided_plain"}),
    (None, True, {"packed", "strided", "packed_plain", "strided_plain"}),
], ids=["config_off", "config_off_env_wins", "config_on"])
def test_unet_flash_attention_flag(monkeypatch, taken, env, flash, routes):
    """A UNet whose config has flash_attention=False runs every attention
    through "xla" even where the dispatcher's default would take a kernel
    (here made "pallas"); EMOX_ATTENTION_IMPL, where set, beats the config;
    with the flag on, the default holds. predict_noise (writer and reader)
    matches the reference under the same config and variable."""
    if env:
        monkeypatch.setenv("EMOX_ATTENTION_IMPL", env)
    else:
        monkeypatch.delenv("EMOX_ATTENTION_IMPL", raising=False)
        monkeypatch.setattr(tattn, "attention_default_impl", lambda: "pallas")
    jm, params, tm = _unet_pair(flash)
    rng = np.random.default_rng(5)
    lat = IMAGE // jm.config.vae.downscale
    noisy = rng.standard_normal((2, FRAMES, lat, lat, jm.config.model.in_channels)).astype(np.float32)
    ref = rng.standard_normal((2, lat, lat, jm.config.model.in_channels)).astype(np.float32)
    ts = np.array([900, 100], np.int32)
    taken.clear()
    got = tm.predict_noise(torch.from_numpy(noisy), torch.from_numpy(ts).long(), torch.from_numpy(ref))
    assert taken and set(taken) <= routes, taken
    if flash:
        assert {"packed", "strided"} & set(taken), taken
    want = jm.predict_noise(params, jnp.asarray(noisy), jnp.asarray(ts), jnp.asarray(ref))
    assert rel_err(got, want) <= TOL


GN_CASES = [(impl, silu, how) for impl in ("pallas_interpret", "fast_interpret") for silu in (False, True)
            for how in ("env", "arg")]


@pytest.mark.parametrize("impl,silu,how", GN_CASES, ids=[f"{i}-silu{int(s)}-{h}" for i, s, h in GN_CASES])
def test_groupnorm_interpret_names(monkeypatch, impl, silu, how):
    """EMOX_GROUPNORM_IMPL=pallas_interpret and =fast_interpret (and impl=)
    run the kernels' plain versions on any device, against the reference's
    kernels in interpret mode under the same name; 4-D input, as the UNet's
    [B, H, W, C] sites give."""
    rng = np.random.default_rng(7)
    x = (2 * rng.standard_normal((2, 4, 8, 64)) + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jgn.group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 16, silu=silu, impl=impl)
    args = [torch.from_numpy(a) for a in (x, gamma, beta)]
    if how == "env":
        monkeypatch.setenv("EMOX_GROUPNORM_IMPL", impl)
        got = ops.group_norm(*args, 16, silu=silu)
    else:
        got = ops.group_norm(*args, 16, silu=silu, impl=impl)
    assert got.shape == x.shape
    assert rel_err(got, want) <= TOL
