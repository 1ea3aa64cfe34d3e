"""The card path of the port's GEGLU feed-forward and of the head-dim-512
attention forward, on the CPU.

In bf16 both FF functions (`fused_ln_geglu_ff`, K2/K3; `fused_geglu_ff`,
K6) launch one C entry, `emox_ff_sm90` (emox_torch/csrc/ff_sm90.cu: an LN
pass, GEMM 1 with the GEGLU epilogue, GEMM 2 with the bias + residual
epilogue, split over F where its grid is small); in float32 they launch
`emox_ff_f32_sm90`, the same kernels on the two-part bf16 split (its card
path in detail: tests/test_torch_ff_f32_sm90.py). Here `build.kernel` hands the
wrappers stand-in C entries that read the tensors at the pointers they are
given, check what the kernels require (16-byte aligned pointers, the
scratch the wrapper allocates: xn [M, C], h [M, F], the fp32 partials
[splits, M, C]), and compute with the kernels' rounding points, GEMM 2's
split partials added in the kernel's order. The results are held against
the plain versions and against the reference's Pallas kernels in interpret
mode (bf16: two bf16 steps relative L2, float32 1e-5).

The attention forward at head dim 512 reaches flash_fwd_sm90 in bf16 and
flash_fwd_d512_f32 in float32, with stand-in launchers as in
tests/test_torch_head_dims.py.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emox.nn import attention_blocks as jab
from emox.ops import attention as jattn
from emox.ops import ff as jff
from emox_torch import ops
from emox_torch.nn import attention_blocks as tab
from emox_torch.ops import attention as tattn
from emox_torch.ops import build
from emox_torch.ops import ff as tff
from tests.test_torch_bridge import flax_module_params, no_kernel_launches, torch_module  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, _ff_inputs, _ff_port_args, _ff_ref_args, j, rel, t

SMS = 132  # the H100's SMs, which decide GEMM 2's split of F


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor of `shape` and `dtype` at host address `ptr` (CPU tensors'
    data_ptr), writable."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def _geglu(a, w1, b1):
    h = F.linear(a.float(), w1.float(), b1.float())
    v, g = h.chunk(2, dim=-1)
    return (v * F.gelu(g)).to(a.dtype)


@pytest.fixture
def card(monkeypatch):
    """The FF wrappers' card path on CPU tensors: `_on_card_or_cpu` says
    "card", and build.kernel hands out stand-in C entries for ff_sm90.cu's
    bf16 and float32 entries that record each call. Returns the calls."""
    calls = []

    def ff_sm90(x, ln_w, ln_b, w1, b1, w2, b2, xn, h, ws, y, m, c, f, splits, eps, stream):
        ptrs = (x, ln_w, ln_b, w1, b1, w2, b2, xn, h, ws, y)
        assert all(p is None or p % 16 == 0 for p in ptrs), ptrs
        assert c % 8 == 0 and f % 8 == 0 and 1 <= splits <= -(-f // 64)
        bf16 = torch.bfloat16
        X, W1, B1 = _view(x, (m, c), bf16), _view(w1, (2 * f, c), bf16), _view(b1, (2 * f,), bf16)
        W2, B2, H = _view(w2, (c, f), bf16), _view(b2, (c,), bf16), _view(h, (m, f), bf16)
        a = X
        if ln_w is not None:  # the LN pass writes xn, the A operand of GEMM 1
            XN = _view(xn, (m, c), bf16)
            XN.copy_(_ln(X, _view(ln_w, (c,), bf16), _view(ln_b, (c,), bf16), eps))
            a = XN
        else:
            assert ln_b is None and xn is None
        H.copy_(_geglu(a, W1, B1))
        # GEMM 2: each split sums its k-steps of 64 into an fp32 partial, and
        # the partials are added in split order, then b2 and the residual
        steps = -(-f // 64)
        per = -(-steps // splits)
        bounds = [(64 * k, min(f, 64 * (k + per))) for k in range(0, steps, per)]
        parts = [H[:, k0:k1].float() @ W2[:, k0:k1].float().T for k0, k1 in bounds]
        if splits > 1:
            WS = _view(ws, (splits, m, c), torch.float32)
            for z, part in enumerate(parts):
                WS[z].copy_(part)
            parts = list(WS[:len(parts)])
        else:
            assert ws is None
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        acc = acc + B2.float()
        if ln_w is not None:
            acc = acc + X.float()
        _view(y, (m, c), bf16).copy_(acc.to(bf16))
        calls.append(dict(entry="emox_ff_sm90", m=m, c=c, f=f, splits=splits, ln=ln_w is not None,
                          xn=None if xn is None else XN.clone(), h=H.clone()))
        return 0

    def ff_f32_sm90(x, ln_w, ln_b, w1, b1, w2, b2, xp, w1p, w2p, hp, ws, y, m, c, f, splits, eps, stream):
        assert all(p is None or p % 16 == 0 for p in (x, ln_w, ln_b, w1, b1, w2, b2, xp, w1p, w2p, hp, ws, y))
        assert c % 4 == 0 and f % 4 == 0
        f32 = torch.float32
        args = (_view(w1, (2 * f, c), f32), _view(b1, (2 * f,), f32), _view(w2, (c, f), f32), _view(b2, (c,), f32))
        X = _view(x, (m, c), f32)
        if ln_w is not None:
            y_ = tff.ln_geglu_ff_plain(X, _view(ln_w, (c,), f32), _view(ln_b, (c,), f32), *args, eps)
        else:
            y_ = tff.geglu_ff_plain(X, *args)
        _view(y, (m, c), f32).copy_(y_)
        calls.append(dict(entry="emox_ff_f32_sm90", m=m, c=c, f=f, splits=splits, ln=ln_w is not None))
        return 0

    entries = {"emox_ff_sm90": ff_sm90, "emox_ff_f32_sm90": ff_f32_sm90}
    monkeypatch.setattr(build, "kernel", lambda name, fn_name="": entries[fn_name or f"emox_{name}"])
    monkeypatch.setattr(tff, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tff, "_stream", lambda x: 0)
    monkeypatch.setattr(tff, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield calls
    ops.reset_launch_counts()


# rows below one 128-row tile, ragged, several tiles; widths whose GEMM 2
# grid fills the card (1 split) or does not (2, 4, 5 splits)
FF_SHAPES = [(37, 64), (100, 128), (300, 320), (500, 1280), (256, 40)]


@pytest.mark.parametrize("m,c", FF_SHAPES, ids=[f"m{m}_c{c}" for m, c in FF_SHAPES])
def test_ln_ff_card_path_bf16(card, m, c):
    """fused_ln_geglu_ff on bf16: one ff_sm90 entry with LN, the scratch the
    wrapper allocated (xn the LN of x rounded to bf16, h the gated
    activation), GEMM 2's split from ff_sm90_plan, the output against
    ln_geglu_ff_plain; one call counted on ln_geglu_ff and on ff_sm90."""
    f = 4 * c
    args = _ff_port_args(_ff_inputs(m, c, seed=m + c), torch.bfloat16)
    y = ops.fused_ln_geglu_ff(*args)
    want = tff.ln_geglu_ff_plain(*args)
    assert y.dtype == torch.bfloat16 and y.shape == (m, c)
    assert rel(y, want.float().numpy()) <= BF16_TOL
    (call,) = card
    splits = tff.ff_sm90_plan(m, c, f, SMS)["splits"]
    assert (call["entry"], call["m"], call["c"], call["f"], call["splits"], call["ln"]) == (
        "emox_ff_sm90", m, c, f, splits, True)
    assert torch.equal(call["xn"], _ln(args[0], args[1], args[2], 1e-5))
    assert call["h"].shape == (m, f) and rel(call["h"], _geglu(call["xn"], args[3], args[4]).float().numpy()) == 0
    counts = ops.launch_counts()
    assert counts["ln_geglu_ff"] == counts["ff_sm90"] == 1 and counts["ff_f32_sm90"] == counts["geglu_ff"] == 0


@pytest.mark.parametrize("m,c", [(37, 64), (100, 128)], ids=["below_one_tile", "split_f"])
def test_card_path_bf16_matches_pallas_interpret(card, m, c):
    """The card path's bf16 result (the stand-in computes as the kernel
    rounds) against the reference's Pallas kernels in interpret mode: the
    fused LN + FF + residual (K2 / K3) and the FF alone (K6)."""
    p = _ff_inputs(m, c, seed=7 * m)
    want = jff.fused_ln_geglu_ff(*_ff_ref_args(p, jnp.bfloat16), block_m=64, block_f=0, interpret=True)
    assert rel(ops.fused_ln_geglu_ff(*_ff_port_args(p, torch.bfloat16)), want) <= BF16_TOL
    x, _, _, w1, b1, w2, b2 = _ff_port_args(p, torch.bfloat16)
    want = jff.fused_geglu_ff(*(j(p[k], jnp.bfloat16) for k in ("x", "w1", "b1", "w2", "b2")), block_m=64,
                              interpret=True)
    assert rel(ops.fused_geglu_ff(x, w1, b1, w2, b2), want) <= BF16_TOL
    assert [c_["ln"] for c_ in card] == [True, False]


@pytest.mark.parametrize("m,c", [(37, 64), (500, 1280)], ids=["m37_c64", "m500_c1280"])
def test_geglu_ff_card_path_bf16(card, m, c):
    """fused_geglu_ff (K6) on bf16, on a [2, m, c] batch: the same entry
    with no LN pointers and no xn, no residual, [2m, c] rows; one call on
    geglu_ff and on ff_sm90."""
    x, _, _, w1, b1, w2, b2 = _ff_port_args(_ff_inputs(2 * m, c, seed=c), torch.bfloat16)
    x = x.view(2, m, c)
    y = ops.fused_geglu_ff(x, w1, b1, w2, b2)
    assert y.shape == x.shape and rel(y, tff.geglu_ff_plain(x, w1, b1, w2, b2).float().numpy()) <= BF16_TOL
    (call,) = card
    assert (call["m"], call["ln"], call["xn"]) == (2 * m, False, None)
    counts = ops.launch_counts()
    assert counts["geglu_ff"] == counts["ff_sm90"] == 1 and counts["ff_f32_sm90"] == counts["ln_geglu_ff"] == 0


@pytest.mark.parametrize("fn", ["ln_geglu_ff", "geglu_ff"])
def test_float32_takes_ff_f32_sm90(card, fn):
    """float32 reaches ff_sm90.cu's float32 entry (with LN and without),
    counted on ff_f32_sm90, never ff_sm90."""
    x, ln_w, ln_b, w1, b1, w2, b2 = _ff_port_args(_ff_inputs(70, 64, seed=3))
    if fn == "ln_geglu_ff":
        got, want = ops.fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2), tff.ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1,
                                                                                                 w2, b2)
    else:
        got, want = ops.fused_geglu_ff(x, w1, b1, w2, b2), tff.geglu_ff_plain(x, w1, b1, w2, b2)
    assert rel(got, want.numpy()) <= FP32_TOL
    assert [(c["entry"], c["ln"]) for c in card] == [("emox_ff_f32_sm90", fn == "ln_geglu_ff")]
    counts = ops.launch_counts()
    assert counts["ff_f32_sm90"] == counts[fn] == 1 and counts["ff_sm90"] == 0


def test_card_path_gradients(card):
    """The backward stays the reference's recompute through the plain
    formula: gradients of the card path's bf16 forward match those of
    ln_geglu_ff_xla, and the backward launches nothing."""
    args = [a.requires_grad_() for a in _ff_port_args(_ff_inputs(40, 64, seed=9), torch.bfloat16)]
    dy = torch.from_numpy(np.random.default_rng(10).standard_normal((40, 64)).astype(np.float32)).bfloat16()
    got = torch.autograd.grad(ops.fused_ln_geglu_ff(*args), args, dy)
    want = torch.autograd.grad(tff.ln_geglu_ff_xla(*args), args, dy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(card) == 1


def test_ff_switch_under_xla_launches_nothing(card, monkeypatch):
    """A bf16 TransformerBlock on the card path: its FF sub-layer is one
    ff_sm90 launch with EMOX_FF_IMPL unset, none under EMOX_FF_IMPL=xla;
    both match the reference's float32 block under the same switch within
    the bf16 block's rounding."""
    rng = np.random.default_rng(11)
    x = (0.4 * rng.standard_normal((2, 12, 64))).astype(np.float32)
    jmod = jab.TransformerBlock(heads=2, head_dim=32, use_cross=False)
    params = flax_module_params(jmod, jnp.asarray(x))
    tmod = torch_module(tab.TransformerBlock(64, 2, 32, use_cross=False), params).to(torch.bfloat16)
    xb = t(x, torch.bfloat16)
    for env, launches in ((None, 1), ("xla", 0)):
        if env:
            monkeypatch.setenv("EMOX_FF_IMPL", env)
        else:
            monkeypatch.delenv("EMOX_FF_IMPL", raising=False)
        ops.reset_launch_counts()
        with torch.no_grad():
            got, _ = tmod(xb)
        want, _ = jmod.apply({"params": params}, jnp.asarray(x))
        counts = ops.launch_counts()
        assert counts["ff_sm90"] == counts["ln_geglu_ff"] == launches and counts["ff_f32_sm90"] == 0, (env, counts)
        assert rel(got, want) <= 4 * BF16_TOL


def test_wrappers_raise_for_what_the_kernels_do_not_take(card):
    """The wrappers check before any launch: C and F each a multiple of 8 in
    bf16 and of 4 in float32 (16-byte rows for TMA and the split), 16-byte
    aligned inputs, one type for every weight."""
    p = _ff_inputs(16, 24, seed=12)
    x, ln_w, ln_b, w1, b1, w2, b2 = _ff_port_args(p, torch.bfloat16)
    ops.fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2)  # C 24 is taken in bf16
    with pytest.raises(ValueError, match="C % 8"):
        ops.fused_ln_geglu_ff(x[:, :12], ln_w[:12], ln_b[:12], w1[:, :12], b1, w2[:12], b2[:12])
    ops.fused_ln_geglu_ff(*_ff_port_args(p))  # C 24 is taken in float32
    with pytest.raises(ValueError, match="C % 4"):  # C 22 in float32
        ops.fused_ln_geglu_ff(*(a.float() for a in (x[:, :22], ln_w[:22], ln_b[:22], w1[:, :22], b1, w2[:22],
                                                     b2[:22])))
    with pytest.raises(ValueError, match="C % 8"):  # F 92: not a multiple of 8
        keep = torch.cat([torch.arange(92), torch.arange(96, 188)])
        ops.fused_geglu_ff(x, w1[keep], b1[keep], w2[:, :92], b2)
    misaligned = torch.empty(16 * 24 + 1, dtype=torch.bfloat16)[1:].view(16, 24)
    misaligned.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fused_ln_geglu_ff(misaligned, ln_w, ln_b, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="x's type"):
        ops.fused_geglu_ff(x, w1.float(), b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_geglu_ff(x.half(), w1.half(), b1.half(), w2.half(), b2.half())
    assert [c["entry"] for c in card] == ["emox_ff_sm90", "emox_ff_f32_sm90"]


def test_sm90_plan_at_the_model_shapes():
    """GEMM 2 splits F only where its grid would leave most of the card
    idle: the mid block (M 512, C 1280) at 256^2 in 4, nothing else the
    flagship runs; GEMM 1's grid covers (M / 128) x (F / 128) tiles."""
    plan = lambda m, c: tff.ff_sm90_plan(m, c, 4 * c, SMS)
    for m, c in ((32768, 320), (8192, 640), (2048, 1280), (131072, 320), (32768, 640), (8192, 1280), (2048, 1280)):
        assert plan(m, c)["splits"] == 1, (m, c)
    assert plan(512, 1280) == {"gemm1_blocks": 4 * 40, "gemm2_blocks": 4 * 8 * 4, "splits": 4}
    assert plan(32768, 320) == {"gemm1_blocks": 256 * 10, "gemm2_blocks": 256 * 2, "splits": 1}
    assert plan(37, 320)["splits"] == 5  # 20 stages of F, 4 a split


# ---- the attention forward at head dim 512 -------------------------------------------------
@pytest.fixture
def attn_card(monkeypatch):
    """The attention wrappers' card path with stand-in forward launchers."""
    seen = []

    def sm90(q, k, v, out, lse, scale):
        assert q.dtype == torch.bfloat16 and tattn._rows_aligned(q) and q.shape[-1] in (*range(8, 257, 8), 512)
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        ops.flash_fwd_sm90.launches += 1  # the launcher this stands in for counts its launches
        seen.append(("sm90", tuple(q.shape)))

    def d512_f32(q, k, v, out, lse, scale):
        assert q.dtype == torch.float32 and tattn._rows_aligned(q) and q.shape[-1] == 512
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        ops.flash_fwd_d512_f32.launches += 1
        seen.append(("d512_f32", tuple(q.shape)))

    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, t: True)
    monkeypatch.setattr(tattn, "flash_fwd_sm90", sm90)
    monkeypatch.setattr(tattn, "flash_fwd_d512_f32", d512_f32)
    yield seen
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_d512_forward_routes_by_type(attn_card, dtype):
    """flash_attention_nlc at head dim 512 (the VAE's single-head
    mid-attention, a ragged Lk): bf16 reaches flash_fwd_sm90 on a
    head-split view [N, 1, L, 512], float32 flash_fwd_d512_f32 on the same
    view; output and lse [N, Lq, 1] against the reference's packed kernel in
    interpret mode."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(41)
    n, lq, lk, d = 2, 40, 100, 512
    q, k, v = (rng.standard_normal((n, l, d)).astype(np.float32) for l in (lq, lk, lk))
    jt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    want, want_lse = jattn._flash_impl_nlc(j(q, jt), j(k, jt), j(v, jt), 1, d ** -0.5, interpret=True,
                                           return_lse=True)
    out, lse = ops.flash_attention_nlc(t(q, dt), t(k, dt), t(v, dt), 1, return_lse=True)
    assert out.dtype == dt and lse.shape == (n, lq, 1) and lse.dtype == torch.float32
    assert rel(out, want) <= (BF16_TOL if dt == torch.bfloat16 else FP32_TOL)
    assert rel(lse, np.asarray(want_lse)[:, :lq]) <= 1e-3
    assert attn_card == [("sm90" if dt == torch.bfloat16 else "d512_f32", (n, 1, lq, d))]
    counts = ops.launch_counts()
    assert counts["flash_attn_nlc_fwd"] == 1
    assert (counts["flash_fwd_sm90"], counts["flash_fwd_d512_f32"]) == ((1, 0) if dt == torch.bfloat16 else (0, 1))
