"""The port's ops against the reference's, on the CPU.

The kernels' plain versions (what the wrappers run for CPU tensors) are
held against the reference's Pallas kernels in interpret mode and against
its XLA formulas. Tolerances: fp32 <= 1e-5 relative (L2); bf16 cases
allow the rounding of the bf16 result (a few bf16 steps, 2^-8 relative).
The CUDA kernels themselves are checked on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.ops import attention as jattn
from emox.ops import ff as jff
from emox.ops import groupnorm as jgn
from emox_torch import ops
from emox_torch.ops.attention import (
    attention_bwd_plain,
    attention_nlc_bwd_plain,
    attention_nlc_plain,
    attention_plain,
    attention_xla,
    dot_product_attention_nlc,
    flash_attention,
    flash_attention_bwd,
    flash_attention_nlc_bwd,
)
from emox_torch.ops.ff import fused_ln_geglu_ff, geglu_ff_xla, ln_geglu_ff_plain, ln_geglu_ff_xla
from emox_torch.ops.groupnorm import group_norm_xla
from tests.test_torch_bridge import no_kernel_launches  # noqa: F401 (autouse fixture)

FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -8 * 2  # two bf16 steps, relative


def rel(got, want) -> float:
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# ---- K1: packed flash attention -------------------------------------------------
@pytest.mark.parametrize("lk", [100, 128], ids=["ragged_lk", "aligned_lk"])
def test_flash_plain_matches_pallas_interpret(lk):
    """lk=100 pads to 112 and runs the TPU kernel's masked path; lk=128 the
    unmasked one."""
    rng = np.random.default_rng(0)
    n, lq, heads, d = 2, 64, 2, 64
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    scale = d ** -0.5
    want, want_lse = jattn._flash_impl_nlc(j(q), j(k), j(v), heads, scale, interpret=True, return_lse=True)
    got, got_lse = attention_nlc_plain(t(q), t(k), t(v), heads, scale)
    assert rel(got, want) <= FP32_TOL
    assert rel(got_lse, np.asarray(want_lse)[:, :lq]) <= FP32_TOL
    # the public wrapper takes the plain version for CPU tensors
    assert rel(ops.flash_attention_nlc(t(q), t(k), t(v), heads), want) <= FP32_TOL


def test_flash_plain_matches_attention_xla():
    rng = np.random.default_rng(1)
    b, h, lq, lk, d = 2, 3, 16, 40, 64
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32) for l in (lq, lk, lk))
    want = jattn.attention_xla(j(q), j(k), j(v))
    got = attention_xla(t(q), t(k), t(v))
    assert rel(got, want) <= FP32_TOL
    packed = lambda a: t(a.transpose(0, 2, 1, 3).reshape(b, a.shape[2], h * d))
    got_nlc, _ = attention_nlc_plain(packed(q), packed(k), packed(v), h, d ** -0.5)
    assert rel(got_nlc, np.asarray(want).transpose(0, 2, 1, 3).reshape(b, lq, h * d)) <= FP32_TOL


def test_flash_plain_bf16():
    """bf16 inputs: fp32 inside, one rounding of the output."""
    rng = np.random.default_rng(2)
    n, lq, lk, heads, d = 2, 64, 96, 2, 64
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    want = jattn.flash_attention_nlc(j(q, jnp.bfloat16), j(k, jnp.bfloat16), j(v, jnp.bfloat16), heads,
                                     interpret=True)
    got = attention_nlc_plain(t(q, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16), heads, d ** -0.5)[0]
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("lk,d", [(2048, 64), (2048, 32), (64, 64)], ids=["kernel_site", "d32", "short_kv"])
def test_dispatch_matches_reference_dispatch(lk, d):
    """dot_product_attention_nlc takes the kernel path exactly where the
    reference takes Pallas (Lk >= 2048, d % 64 == 0); every path computes
    the same function."""
    rng = np.random.default_rng(3)
    n, lq, heads = 1, 8, 2
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    want = jattn.dot_product_attention_nlc(j(q), j(k), j(v), heads, impl="xla")
    assert rel(dot_product_attention_nlc(t(q), t(k), t(v), heads, impl="auto"), want) <= FP32_TOL
    assert ops.KERNEL_MIN_KV == jattn._PALLAS_MIN_KV


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.flash_attention_nlc(q, q, q, 1)


# ---- K4: packed flash attention backward ----------------------------------------
@pytest.mark.parametrize("lq,lk,d", [(50, 200, 64), (64, 64, 64), (50, 200, 128)],
                         ids=["ragged_lq_lk", "aligned", "d128_ragged"])
def test_flash_bwd_plain_matches_pallas_interpret(lq, lk, d):
    """The reference's backward kernels in interpret mode (ragged Lk pads and
    takes the masked path) against the plain version, from the reference's
    own forward output and lse."""
    rng = np.random.default_rng(5)
    n, heads = 1, 2
    q, g = (rng.standard_normal((n, lq, heads * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((n, lk, heads * d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    o, lse = jattn._flash_impl_nlc(j(q), j(k), j(v), heads, scale, interpret=True, return_lse=True)
    want = jattn._flash_bwd_impl_nlc(j(q), j(k), j(v), o, lse, j(g), heads, scale, interpret=True)
    lse_q = t(np.asarray(lse)[:, :lq])
    got = attention_nlc_bwd_plain(t(q), t(k), t(v), t(o), lse_q, t(g), heads, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        assert rel(a, b) <= FP32_TOL, name
    # the public wrapper runs the plain version for CPU tensors and returns
    # only the gradients asked for
    dq, dk, dv = flash_attention_nlc_bwd(t(q), t(k), t(v), t(o), lse_q, t(g), heads, need_dkv=False)
    assert dk is None and dv is None and rel(dq, want[0]) <= FP32_TOL


def _loss_weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_flash_autograd_matches_jax_grad():
    """Gradients through dot_product_attention_nlc at a kernel site (Lk >=
    2048, d 64): the autograd function's backward on CPU tensors against
    jax.grad of the reference's dispatcher."""
    import jax

    rng = np.random.default_rng(6)
    n, lq, lk, heads, d = 1, 16, 2048, 2, 64
    q = rng.standard_normal((n, lq, heads * d)).astype(np.float32)
    k, v = (rng.standard_normal((n, lk, heads * d)).astype(np.float32) for _ in range(2))
    w = _loss_weights((n, lq, heads * d), 7)
    loss = lambda a, b, c: jnp.sum(jattn.dot_product_attention_nlc(a, b, c, heads, impl="xla") * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    out = dot_product_attention_nlc(qt, kt, vt, heads, impl="auto")
    assert type(out.grad_fn).__name__ == "_FlashNLCBackward"  # the kernel's autograd function
    got = torch.autograd.grad((out * t(w)).sum(), (qt, kt, vt))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert rel(a, b) <= FP32_TOL, name
    # only q needs a gradient: the backward asks for dq alone
    (dq,) = torch.autograd.grad((dot_product_attention_nlc(qt, t(k), t(v), heads, impl="auto") * t(w)).sum(), (qt,))
    assert rel(dq, want[0]) <= FP32_TOL


# ---- K5: strided flash attention on [B, H, L, D] -------------------------------------
K5_CASES = [(128, 256, 40), (128, 256, 80), (1000, 2100, 40)]
K5_IDS = ["d40", "d80", "ragged_lq1000_lk2100"]


def _k5_inputs(lq, lk, d, seed, b=1, h=2):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, h, lq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, lk, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _lse_bhl(lse, b, h, lq):
    """The reference's lse (B*H, 1, Lq_pad) -> the port's [B, H, Lq]."""
    return np.asarray(lse)[:, 0, :lq].reshape(b, h, lq)


def _head_split_view(a):
    """[B, H, L, D] numpy -> the same values as a strided head-split view of
    packed [B, L, H*D] tokens, as the nn modules pass them."""
    b, h, l, d = a.shape
    packed = t(a.transpose(0, 2, 1, 3).reshape(b, l, h * d))
    view = packed.view(b, l, h, d).transpose(1, 2)
    assert not view.is_contiguous()
    return view


@pytest.mark.parametrize("lq,lk,d", K5_CASES, ids=K5_IDS)
def test_flash_strided_plain_matches_pallas_interpret(lq, lk, d):
    """The plain version of flash_attn_fwd against the reference's _flash_kernel
    in interpret mode (head dim padded to 128 there, Lk padded and masked on
    the ragged case): out and lse."""
    q, k, v, _ = _k5_inputs(lq, lk, d, seed=11)
    scale = d ** -0.5
    want, want_lse = jattn._flash_impl(j(q), j(k), j(v), scale, interpret=True, return_lse=True)
    got, got_lse = attention_plain(t(q), t(k), t(v), scale)
    assert rel(got, want) <= FP32_TOL
    assert got_lse.shape == (1, 2, lq)
    assert rel(got_lse, _lse_bhl(want_lse, 1, 2, lq)) <= FP32_TOL
    # the public wrapper on head-split views of packed tokens (CPU: the plain version)
    out, lse = flash_attention(*(_head_split_view(a) for a in (q, k, v)), return_lse=True)
    assert rel(out, want) <= FP32_TOL and rel(lse, _lse_bhl(want_lse, 1, 2, lq)) <= FP32_TOL


@pytest.mark.parametrize("lq,lk,d", K5_CASES, ids=K5_IDS)
def test_flash_strided_bwd_plain_matches_pallas_interpret(lq, lk, d):
    """The plain version of flash_attn_bwd against the reference's dq and dk/dv
    kernels in interpret mode, from the reference's own forward output and
    lse; the wrapper returns only the gradients asked for."""
    q, k, v, g = _k5_inputs(lq, lk, d, seed=12)
    scale = d ** -0.5
    o, lse = jattn._flash_impl(j(q), j(k), j(v), scale, interpret=True, return_lse=True)
    want = jattn._flash_bwd_impl(j(q), j(k), j(v), o, lse, j(g), scale, interpret=True)
    lse_t = t(_lse_bhl(lse, 1, 2, lq))
    got = attention_bwd_plain(t(q), t(k), t(v), t(o), lse_t, t(g), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        assert rel(a, b) <= FP32_TOL, name
    dq, dk, dv = flash_attention_bwd(t(q), t(k), t(v), t(o), lse_t, t(g), need_dq=False)
    assert dq is None and rel(dk, want[1]) <= FP32_TOL and rel(dv, want[2]) <= FP32_TOL


def test_flash_strided_autograd_matches_jax_grad():
    """The autograd function flash_attention (forward and backward plain on
    CPU tensors) against jax.grad through the reference's flash_attention,
    its Pallas kernels in interpret mode; inputs are head-split views."""
    import jax

    q, k, v, _ = _k5_inputs(96, 160, 40, seed=13, b=2)
    w = _loss_weights(q.shape, 14)
    loss = lambda a, b, c: jnp.sum(jattn.flash_attention(a, b, c, interpret=True) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    qt, kt, vt = (_head_split_view(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(qt, kt, vt)
    assert type(out.grad_fn).__name__ == "_FlashBackward"  # the kernels' autograd function
    got = torch.autograd.grad((out * t(w)).sum(), (qt, kt, vt))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert rel(a, b) <= FP32_TOL, name
    # only k and v need gradients: the backward asks for dk/dv alone
    dk, dv = torch.autograd.grad((flash_attention(t(q), kt, vt) * t(w)).sum(), (kt, vt))
    assert rel(dk, want[1]) <= FP32_TOL and rel(dv, want[2]) <= FP32_TOL


# (Lk, head dim) -> the route the reference's impl="auto" dispatch takes with
# the cutoff lowered to 64: the packed kernel (d % 64 == 0), the strided
# kernel (other head dims), or plain XLA (Lk below the cutoff)
ROUTE_CASES = [(64, 64, "packed"), (64, 40, "strided"), (96, 80, "strided"), (32, 40, "plain"), (32, 64, "plain")]


@pytest.mark.parametrize("lk,d,route", ROUTE_CASES, ids=[f"lk{a}_d{b}_{c}" for a, b, c in ROUTE_CASES])
def test_dispatch_routes_like_the_reference_auto_dispatch(monkeypatch, lk, d, route):
    """With both cutoffs lowered, the port's dot_product_attention_nlc takes
    the kernel the reference's dot_product_attention_nlc(impl="auto") takes
    (spied on both sides), and both compute the same values."""
    from emox_torch.ops import attention as tattn

    taken = {"ref": [], "port": []}

    def spy(side, label, fn):
        def run(*a, **kw):
            taken[side].append(label)
            return fn(*a, **kw)
        return run

    ref_nlc, ref_flash = jattn.flash_attention_nlc, jattn.flash_attention  # run in interpret mode
    monkeypatch.setattr(jattn, "_PALLAS_MIN_KV", 64)
    monkeypatch.setattr(jattn, "flash_attention_nlc", spy(
        "ref", "packed", lambda q, k, v, heads, scale=None, interpret=False: ref_nlc(q, k, v, heads, scale, True)))
    monkeypatch.setattr(jattn, "flash_attention", spy(
        "ref", "strided", lambda q, k, v, scale=None, interpret=False: ref_flash(q, k, v, scale, True)))
    monkeypatch.setattr(jattn, "attention_xla", spy("ref", "plain", jattn.attention_xla))
    monkeypatch.setattr(tattn, "KERNEL_MIN_KV", 64)
    monkeypatch.setattr(tattn, "flash_attention_nlc", spy("port", "packed", tattn.flash_attention_nlc))
    monkeypatch.setattr(tattn, "flash_attention", spy("port", "strided", tattn.flash_attention))
    monkeypatch.setattr(tattn, "attention_xla", spy("port", "plain", tattn.attention_xla))
    rng = np.random.default_rng(15)
    n, lq, heads = 2, 24, 2
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    want = jattn.dot_product_attention_nlc(j(q), j(k), j(v), heads, impl="auto")
    got = tattn.dot_product_attention_nlc(t(q), t(k), t(v), heads, impl="auto")
    assert taken["ref"] == taken["port"] == [route]
    assert rel(got, want) <= FP32_TOL


def test_strided_wrapper_checks_head_dim_and_row_alignment():
    """What the kernels still refuse is refused before any launch: rows that
    are not contiguous and 16-byte aligned where the head dim itself would
    keep them aligned (a head dim that would not is zero-padded instead).
    Every head dim passes the checks on either layout, as the reference
    computes every one: 257-511 are padded to 512 for the d-512 kernels, and
    above 512 the wide kernels take them."""
    from emox_torch.ops.attention import _check_kernel_inputs, _check_rows, _check_strided_inputs

    for d in (4, 40, 64, 160, 256, 300, 320, 512):
        y = torch.zeros(1, 2, 8, d)
        assert _check_strided_inputs("flash_attn_fwd", y, y, y) == (1, 2, 8, 8, d)
    x = torch.zeros(1, 2, 8, 640)
    assert _check_strided_inputs("flash_attn_fwd", x, x, x) == (1, 2, 8, 8, 640)
    p = torch.zeros(1, 8, 2 * 512)
    assert _check_kernel_inputs("flash_attn_nlc_fwd", p, p, p, 2) == (1, 8, 8, 512)
    # the backward takes head dim 512 too (VAE pretraining), and 384 (padded)
    assert _check_kernel_inputs("flash_attn_nlc_bwd", p, p, p, 2) == (1, 8, 8, 512)
    assert _check_kernel_inputs("flash_attn_nlc_bwd", p[..., :768], p[..., :768], p[..., :768], 2) == (1, 8, 8, 384)
    w = torch.zeros(1, 8, 1024)
    for name in ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd"):
        assert _check_kernel_inputs(name, w, w, w, 1) == (1, 8, 8, 1024)
    _check_rows("flash_attn_fwd", q=torch.zeros(1, 8, 2 * 40).view(1, 8, 2, 40).transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        _check_rows("flash_attn_fwd", q=torch.zeros(1, 2, 8, 41)[..., :40])  # row stride 41 floats
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        _check_rows("flash_attn_fwd", q=torch.zeros(1, 2, 40, 8).transpose(-1, -2))  # head dim not contiguous
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(*(torch.zeros(1, 2, 8, 40, device="meta"),) * 3)


# ---- K2/K3: fused LN + GEGLU + residual -----------------------------------------
def _ff_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    f = 4 * c
    return dict(
        x=rng.standard_normal((m, c)).astype(np.float32) * 2 + 0.5,
        ln_s=(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(c)).astype(np.float32),
        w1=(rng.standard_normal((c, 2 * f)) / np.sqrt(c)).astype(np.float32),  # flax [C, 2F]
        b1=(0.1 * rng.standard_normal(2 * f)).astype(np.float32),
        w2=(rng.standard_normal((f, c)) / np.sqrt(f)).astype(np.float32),  # flax [F, C]
        b2=(0.1 * rng.standard_normal(c)).astype(np.float32),
    )


def _ff_port_args(p, dtype=torch.float32):
    """Port layout: Linear weights [out, in]."""
    return (t(p["x"], dtype), t(p["ln_s"], dtype), t(p["ln_b"], dtype), t(p["w1"].T.copy(), dtype),
            t(p["b1"], dtype), t(p["w2"].T.copy(), dtype), t(p["b2"], dtype))


def _ff_ref_args(p, dtype=jnp.float32):
    return tuple(j(p[k], dtype) for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2"))


@pytest.mark.parametrize("block_f", [0, 128], ids=["narrow_K2", "wide_K3"])
def test_ff_plain_matches_pallas_interpret(block_f):
    p = _ff_inputs(m=200, c=64)
    want = jff.fused_ln_geglu_ff(*_ff_ref_args(p), block_m=64, block_f=block_f, interpret=True)
    assert rel(ln_geglu_ff_plain(*_ff_port_args(p)), want) <= FP32_TOL
    assert rel(fused_ln_geglu_ff(*_ff_port_args(p)), want) <= FP32_TOL


def test_ff_plain_matches_exact_erf_xla():
    p = _ff_inputs(m=37, c=48, seed=1)
    want = jff.ln_geglu_ff_xla(*_ff_ref_args(p))
    assert rel(ln_geglu_ff_plain(*_ff_port_args(p)), want) <= FP32_TOL


@pytest.mark.parametrize("block_f", [0, 128], ids=["narrow_K2", "wide_K3"])
def test_ff_plain_bf16(block_f):
    """bf16: both round xn and the gated activation to bf16 and accumulate
    in fp32; the reference's in-kernel erf approximation can move a value
    across a bf16 rounding boundary, so the bound is a few bf16 steps."""
    p = _ff_inputs(m=128, c=64, seed=2)
    want = jff.fused_ln_geglu_ff(*_ff_ref_args(p, jnp.bfloat16), block_m=64, block_f=block_f, interpret=True)
    got = ln_geglu_ff_plain(*_ff_port_args(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_TOL


def test_ff_autograd_matches_jax_grad():
    """The FF autograd function (plain forward on CPU tensors, backward by
    recompute through ln_geglu_ff_xla) against jax.grad of the reference's
    ln_geglu_ff_xla, for x and all six weights."""
    import jax

    p = _ff_inputs(m=40, c=32, seed=4)
    w = _loss_weights((40, 32), 8)
    names = ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")
    loss = lambda *a: jnp.sum(jff.ln_geglu_ff_xla(*a) * w)
    want = jax.grad(loss, argnums=tuple(range(7)))(*_ff_ref_args(p))
    args = [a.requires_grad_() for a in _ff_port_args(p)]
    y = fused_ln_geglu_ff(*args)
    assert type(y.grad_fn).__name__ == "_LnGegluFFBackward"
    got = torch.autograd.grad((y * t(w)).sum(), args)
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        if name in ("w1", "w2"):
            b = b.T  # flax [in, out] -> Linear [out, in]
        assert rel(a, b) <= FP32_TOL, name
    assert rel(ln_geglu_ff_xla(*_ff_port_args(p)), jff.ln_geglu_ff_xla(*_ff_ref_args(p))) <= FP32_TOL


def test_geglu_ff_xla_matches():
    p = _ff_inputs(m=21, c=32, seed=3)
    want = jff.geglu_ff_xla(j(p["x"]), j(p["w1"]), j(p["b1"]), j(p["w2"]), j(p["b2"]))
    got = geglu_ff_xla(t(p["x"]), t(p["w1"].T.copy()), t(p["b1"]), t(p["w2"].T.copy()), t(p["b2"]))
    assert rel(got, want) <= FP32_TOL


# ---- GroupNorm's plain path (its kernels: tests/test_torch_groupnorm.py) ---------
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches(silu, dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 50, 32)) * 3 + 1).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    b = (0.2 * rng.standard_normal(32)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jgn.group_norm_xla(j(x, jd), j(g), j(b), groups=8, silu=silu)
    got = group_norm_xla(t(x, td), t(g), t(b), groups=8, silu=silu)
    assert got.dtype == td
    assert rel(got, want) <= (FP32_TOL if dtype == "float32" else BF16_TOL)
