"""The port's fused LayerNorm + q/k/v projection (K7) and the two fused
projection switches against the reference's, on the CPU.

`ln_qkv_plain` (what the kernel wrapper runs for CPU tensors) is held
against the reference's `_ln_qkv_kernel` in interpret mode at the
reference's own test shapes, and the autograd function's backward against
jax.grad. Then the blocks that take the switches: TransformerBlock (with
reference K/V and per-row ref_drop; the writer's bank stays the plain
LayerNorm output, bit for bit) and TemporalTransformer (output and
gradients), each under EMOX_LN_QKV=1 and under EMOX_FUSED_QKV=1, against
the reference's modules under the same switch. Tolerances: float32 <= 1e-5
relative L2, bf16 two bf16 steps.
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
from emox_torch.ops import ln_qkv as tln
from tests.test_torch_bridge import flax_module_params, no_kernel_launches, torch_module  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, j, rel, t

SWITCHES = ("EMOX_LN_QKV", "EMOX_FUSED_QKV")


def _args(m, c, inner, seed=11):
    """x [2, m/2, C], LN scale and bias, and three [C, inner] flax kernels
    (tests/test_ops.py TestFusedLNQKV._args, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((2, m // 2, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(c)).astype(np.float32)
    ws = [(rng.standard_normal((c, inner)) * c ** -0.5).astype(np.float32) for _ in range(3)]
    return x, gamma, beta, *ws


def _port(args, dtype=torch.float32):
    """The port's layout: Linear weights [inner, C]."""
    x, gamma, beta, *ws = args
    return (t(x, dtype), t(gamma, dtype), t(beta, dtype), *(t(w.T.copy(), dtype) for w in ws))


@pytest.mark.parametrize("m,c,inner", [(64, 64, 64), (128, 320, 320), (64, 128, 256)])
def test_plain_matches_pallas_interpret(m, c, inner):
    args = _args(m, c, inner)
    want = jff.fused_ln_qkv(*(j(a) for a in args), interpret=True)
    for got in (tln.ln_qkv_plain(*_port(args)), ops.fused_ln_qkv(*_port(args))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert rel(g, w) <= FP32_TOL
    for g, w in zip(tln.ln_qkv_xla(*_port(args)), jff.ln_qkv_xla(*(j(a) for a in args))):
        assert rel(g, w) <= FP32_TOL


def test_plain_bf16():
    """bf16: the normalised x rounded to bf16 before fp32 products, each
    output rounded once, as the TPU kernel does."""
    args = _args(128, 320, 320, seed=12)
    want = jff.fused_ln_qkv(*(j(a, jnp.bfloat16) for a in args), interpret=True)
    got = ops.fused_ln_qkv(*_port(args, torch.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel(g, w) <= BF16_TOL


def test_grads_match_jax_grad():
    """The autograd function (plain forward on CPU tensors, backward by
    recompute through ln_qkv_xla) against jax.grad through the reference's
    kernel in interpret mode, for x, the LN scale and bias and the three
    weights (tests/test_ops.py TestFusedLNQKV.test_grad_matches_xla)."""
    args = _args(64, 128, 128)
    rng = np.random.default_rng(13)
    ws = [rng.standard_normal((2, 32, 128)).astype(np.float32) for _ in range(3)]
    loss = lambda *a: sum(jnp.sum(o * w) for o, w in zip(jff.fused_ln_qkv(*a, interpret=True), ws))
    want = jax.grad(loss, argnums=tuple(range(6)))(*(j(a) for a in args))
    inputs = [a.requires_grad_() for a in _port(args)]
    outs = ops.fused_ln_qkv(*inputs)
    assert type(outs[0].grad_fn).__name__ == "_LnQKVBackward"
    got = torch.autograd.grad(sum((o * t(w)).sum() for o, w in zip(outs, ws)), inputs)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert rel(a, b.T if i >= 3 else b) <= FP32_TOL, i  # flax [C, inner] -> Linear [inner, C]


@pytest.mark.parametrize("name", SWITCHES)
def test_switch_values(monkeypatch, name):
    """Off when unset, empty or "0"; on for anything else, as the reference."""
    ref = {"EMOX_LN_QKV": jff._ln_qkv_enabled, "EMOX_FUSED_QKV": jab._fused_qkv_enabled}[name]
    port = {"EMOX_LN_QKV": tln._ln_qkv_enabled, "EMOX_FUSED_QKV": tab._fused_qkv_enabled}[name]
    monkeypatch.delenv(name, raising=False)
    assert not port() and not ref()
    for value, on in (("", False), ("0", False), ("1", True), ("true", True)):
        monkeypatch.setenv(name, value)
        assert port() == ref() == on, value


def test_wrapper_checks_before_launching():
    x, gamma, beta, wq, wk, wv = _port(_args(64, 64, 64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tln._qkv_kernel(x.half(), gamma, beta, wq, wk, wv, 1e-5)
    with pytest.raises(TypeError, match="in x's type"):
        tln._qkv_kernel(x, gamma.bfloat16(), beta, wq, wk, wv, 1e-5)
    with pytest.raises(ValueError, match="C % 4"):
        tln._qkv_kernel(x[..., :42], gamma[:42], beta[:42], wq[:, :42], wk[:, :42], wv[:, :42], 1e-5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.fused_ln_qkv(x.to("meta"), gamma, beta, wq, wk, wv)
    with pytest.raises(ValueError, match="self-attention path"):
        tab.Attention(64, 2, 32)(None, context=x, qkv=(x, x, x))


# ---- the blocks under the switches ------------------------------------------------
def _block_inputs():
    rng = np.random.default_rng(14)
    x = (0.4 * rng.standard_normal((4, 24, 64))).astype(np.float32)
    ref_kv = (0.4 * rng.standard_normal((2, 24, 64))).astype(np.float32)  # Lr == L: the duplication trick
    return x, dict(ref_kv=ref_kv, ref_drop=np.array([True, False, False, True]), ref_tile=2)


def _jkw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _tkw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


@pytest.mark.parametrize("switch", SWITCHES)
def test_transformer_block_matches_the_reference(monkeypatch, switch):
    """TransformerBlock with reference K/V and per-row ref_drop (tests/
    test_ops.py TestFusedLNQKV.test_transformer_block_parity): output
    against the reference's block under the same switch, the bank identical
    to the plain path's bit for bit; the reader's emit_bank=False returns no
    bank and the same output."""
    x, kw = _block_inputs()
    jmod = jab.TransformerBlock(heads=2, head_dim=32, use_cross=False)
    monkeypatch.delenv("EMOX_LN_QKV", raising=False)
    monkeypatch.delenv("EMOX_FUSED_QKV", raising=False)
    params = flax_module_params(jmod, jnp.asarray(x), **_jkw(kw))
    tmod = torch_module(tab.TransformerBlock(64, 2, 32, use_cross=False), params)
    with torch.no_grad():
        _, bank_plain = tmod(t(x), **_tkw(kw))
    monkeypatch.setenv(switch, "1")
    want, want_bank = jmod.apply({"params": params}, jnp.asarray(x), **_jkw(kw))
    with torch.no_grad():
        got, bank = tmod(t(x), **_tkw(kw))
        got_reader, no_bank = tmod(t(x), emit_bank=False, **_tkw(kw))
    assert rel(got, want) <= FP32_TOL
    assert torch.equal(bank, bank_plain) and rel(bank, want_bank) <= FP32_TOL
    assert torch.equal(got_reader, got)
    assert (no_bank is None) == (switch == "EMOX_LN_QKV")


@pytest.mark.parametrize("switch", SWITCHES)
def test_temporal_transformer_output_and_grads(monkeypatch, switch):
    """TemporalTransformer under the switch: output and the gradients of x,
    the attention's LN scale and q/k/v weights against jax.grad through the
    reference's module (every leaf seeded nonzero, proj_out included, so
    the gradient reaches the fused projection)."""
    rng = np.random.default_rng(15)
    x = (0.4 * rng.standard_normal((1, 4, 6, 6, 64))).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jmod = jab.TemporalTransformer(heads=2, head_dim=32)
    params = flax_module_params(jmod, jnp.asarray(x))
    tmod = torch_module(tab.TemporalTransformer(64, 2, 32), params)
    monkeypatch.setenv(switch, "1")
    loss = lambda p, a: jnp.sum(jmod.apply({"params": p}, a) * w)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = t(x).requires_grad_()
    leaves = [tmod.norm_0.weight, tmod.norm_0.bias, tmod.attn_0.to_q.weight, tmod.attn_0.to_k.weight,
              tmod.attn_0.to_v.weight]
    for p in tmod.parameters():
        p.requires_grad_(True)
    out = tmod(xt)
    assert rel(out.detach(), want) <= FP32_TOL
    got = torch.autograd.grad((out * t(w)).sum(), [xt, *leaves])
    want_g = [gx, gp["norm_0"]["scale"], gp["norm_0"]["bias"],
              *(np.asarray(gp["attn_0"][n]["kernel"]).T for n in ("to_q", "to_k", "to_v"))]
    for name, a, b in zip(("x", "ln_scale", "ln_bias", "wq", "wk", "wv"), got, want_g):
        assert rel(a, b) <= FP32_TOL, name
