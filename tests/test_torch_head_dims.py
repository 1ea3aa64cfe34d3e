"""Every head dim up to 256 on the port's attention routes, on the CPU.

The kernels zero-pad the head dim: in shared memory (flash_fwd_sm90.cu and
flash_bwd_sm90.cu pad to a multiple of 64 columns, their float32 split to 64,
128 or 256, flash_bwd_d512_sm90.cu's pair at half width to 256) and, where a
row is not 16-byte aligned, in the wrapper
(`padded_attention`, the reference's `_pad_dim`). Zero columns change no
product and the scale comes from the true head dim, so padding is exact: the
padded plain versions are held against the reference's Pallas kernels in
interpret mode, forward and gradients, at head dims 4, 16, 40, 160 and 256
(float32, 1e-5 relative L2).

The wrappers' own work around the kernels (head-split views of packed
tokens, the padding, the lse layouts, the gradients cut back to the true
head dim) runs here as it runs on the card, with each CUDA launcher replaced
by a stand-in that checks what the kernel requires (16-byte aligned rows, a
head dim it takes, the lse and delta layouts) and computes with the plain
formulas; each test also asserts which kernel its (layout, dtype, head dim)
reaches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.ops import attention as jattn
from emox_torch import ops
from emox_torch.ops import attention as tattn
from tests.test_torch_bridge import rel_err

TOL = 1e-5  # float32, relative L2
BF16_TOL = 2.0 ** -7  # bf16 outputs and gradients: about two bf16 steps, relative L2
HEAD_DIMS = (4, 16, 40, 160, 256)


def _inputs(d, lq=24, lk=40, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed + d)
    return [rng.standard_normal((b, h, l, d)).astype(np.float32) for l in (lq, lk, lk, lq)]


@pytest.mark.parametrize("multiple", [8, 64], ids=["rows", "smem"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_plain_matches_pallas_interpret(d, multiple):
    """The plain forward on q, k, v zero-padded to a multiple of 8 (the
    wrapper's row padding in bf16) or 64 (the Hopper kernel's shared-memory
    padding), cut back to d, against the reference's kernel in interpret
    mode, which pads its own way; lse against the unpadded plain version."""
    q, k, v, _ = _inputs(d)
    scale = d ** -0.5
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)
    got, lse = ops.padded_attention(tattn.attention_plain, *(torch.from_numpy(a) for a in (q, k, v)), scale, multiple)
    assert got.shape == q.shape
    assert rel_err(got, want) <= TOL
    _, lse_plain = tattn.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert rel_err(lse, lse_plain.numpy()) <= TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_gradients_match_pallas_interpret(d):
    """Gradients through the padding (zero columns of q, k, v and dO add
    nothing to any product of the backward; the padded columns of the
    gradients are cut off) against jax.grad through the reference's kernels
    in interpret mode."""
    q, k, v, w = _inputs(d, seed=1)
    loss = lambda a, b, c: jnp.sum(jattn.flash_attention(a, b, c, interpret=True) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = ops.padded_attention(tattn.attention_plain, *args, d ** -0.5, 64)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (args[0] if name == "dq" else args[1]).shape
        assert rel_err(g, ref) <= TOL, name


def test_pad_head_dim_is_exact_and_lazy():
    """Zero columns appended up to the multiple; the tensor itself when its
    head dim already is one."""
    x = torch.randn(2, 3, 5, 40)
    assert ops.pad_head_dim(x, 8) is x
    y = ops.pad_head_dim(x, 64)
    assert y.shape == (2, 3, 5, 64) and torch.equal(y[..., :40], x) and not y[..., 40:].any()


# ---- the wrappers' work around the kernels, with stand-in launchers -------------------------
def _bwd_formulas(q, k, v, dout, lse, delta, scale):
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None])
    return ds @ kf * scale, ds.transpose(-1, -2) @ qf * scale, p.transpose(-1, -2) @ gf


@pytest.fixture
def card(monkeypatch):
    """Run the wrappers' card path on CPU tensors: every launcher replaced by
    a stand-in that asserts the kernel's preconditions and writes the plain
    result into the outputs the wrapper allocated. Returns the launches."""
    seen = []

    def aligned(*ts):
        for t in ts:
            assert tattn._rows_aligned(t), t.stride()
            assert t.shape[-1] % (16 // t.element_size()) == 0 and t.shape[-1] <= 256

    def sm90(q, k, v, out, lse, scale):
        assert q.dtype == torch.bfloat16
        aligned(q, k, v)
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        seen.append("sm90")

    def f32_sm90(q, k, v, out, lse, scale):
        assert q.dtype == torch.float32
        aligned(q, k, v)
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        seen.append("f32_sm90")

    def grads(q, k, v, dout, lse, delta, dq, dk, dv, scale):
        assert (dk is None) == (dv is None) and (dq is not None or dk is not None)
        for got, want in zip((dq, dk, dv), _bwd_formulas(q, k, v, dout, lse, delta, scale)):
            if got is not None:
                assert got.shape == want.shape
                got.copy_(want)

    def padded_rows(q, lse, delta, rows):
        # [B, H, Lq_pad] fp32 contiguous, padded to a multiple of `rows` rows
        # with lse = +inf and delta = 0
        b, h, lq, _ = q.shape
        for t in (lse, delta):
            assert t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0
            assert t.shape[:2] == (b, h) and t.shape[2] % rows == 0 and lq <= t.shape[2] < lq + rows
        assert torch.isposinf(lse[..., lq:]).all() and not delta[..., lq:].any()
        return lse[..., :lq], delta[..., :lq]

    def backward(name, dtypes, head_dims, rows):
        def launch(q, k, v, dout, lse, delta, dq, dk, dv, scale):
            assert q.dtype in dtypes and q.shape[-1] in head_dims, (q.dtype, q.shape)
            aligned(q, k, v, dout, *(t for t in (dq, dk, dv) if t is not None))
            grads(q, k, v, dout, *padded_rows(q, lse, delta, rows), dq, dk, dv, scale)
            seen.append(name)
        return launch

    both = (torch.bfloat16, torch.float32)
    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, t: True)
    monkeypatch.setattr(tattn, "flash_fwd_sm90", sm90)
    monkeypatch.setattr(tattn, "flash_fwd_f32_sm90", f32_sm90)
    monkeypatch.setattr(tattn, "flash_bwd_sm90", backward("bwd_sm90", (torch.bfloat16,), range(8, 129, 8), 128))
    monkeypatch.setattr(tattn, "flash_bwd_f32_sm90", backward("bwd_f32_sm90", (torch.float32,), range(4, 129, 4), 128))
    monkeypatch.setattr(tattn, "flash_bwd_d256_sm90", backward("bwd_d256_sm90", both, range(132, 257, 4), 64))
    yield seen
    ops.reset_launch_counts()


GLUE = [(layout, dtype, d) for layout in ("packed", "strided") for dtype in ("bfloat16", "float32")
        for d in (4, 6, 16, 40, 64, 80, 128, 160, 256)]


def _bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernel a (dtype, head dim) reaches on either layout: the
    Hopper pair up to head dim 128 (after row padding; float32 on its
    split), the cluster pair at half width at 129-256 in both types."""
    if d > 128:
        return "bwd_d256_sm90"
    return "bwd_sm90" if dtype == torch.bfloat16 else "bwd_f32_sm90"


@pytest.mark.parametrize("layout,dtype,d", GLUE, ids=[f"{a}-{b}-d{c}" for a, b, c in GLUE])
def test_card_path_wrappers(card, layout, dtype, d):
    """flash_attention_nlc (packed tokens, head-split views inside) and
    flash_attention (head-split views of packed tokens) on their card path:
    the forward reaches the bf16 Hopper kernel or the float32 one with
    aligned rows (padded where the head dim would not keep them aligned),
    lse comes back in the layout's shape, and output and gradients match the
    plain versions on the unpadded inputs."""
    dt = getattr(torch, dtype)
    tol = BF16_TOL if dt == torch.bfloat16 else TOL
    n, lq, lk, heads = 2, 24, 40, 3
    rng = np.random.default_rng(d)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((n, l, heads * d)).astype(np.float32)).to(dt)
                  for l in (lq, lk, lk, lq))
    scale = d ** -0.5
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    if layout == "packed":
        out, lse = ops.flash_attention_nlc(*args, heads, return_lse=True)
        want, want_lse = tattn.attention_nlc_plain(q, k, v, heads, scale)
        assert lse.shape == (n, lq, heads)
        grads_want = tattn.attention_nlc_bwd_plain(q, k, v, want, want_lse, w, heads, scale)
    else:
        split = lambda t: t.view(n, t.shape[1], heads, d).transpose(1, 2)
        out, lse = ops.flash_attention(*(split(t) for t in args), return_lse=True)
        want, want_lse = tattn.attention_plain(split(q), split(k), split(v), scale)
        assert lse.shape == (n, heads, lq)
        g = tattn.attention_bwd_plain(split(q), split(k), split(v), want, want_lse, split(w), scale)
        grads_want = [x.transpose(1, 2).reshape(n, -1, heads * d) for x in g]
        w = split(w)
    assert card[0] == ("sm90" if dt == torch.bfloat16 else "f32_sm90")
    assert out.dtype == dt and rel_err(out.float(), want.float().numpy()) <= tol
    assert rel_err(lse, want_lse.numpy()) <= TOL
    got = torch.autograd.grad((out.float() * w.float()).sum(), args)
    assert card[-1] == _bwd_route(dt, d) and len(card) == 2
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_want):
        assert a.shape == b.shape and rel_err(a.float(), b.float().numpy()) <= tol, name


SUBSETS = [(layout, dtype, d, need) for layout in ("packed", "strided") for dtype in ("bfloat16", "float32")
           for d in (40, 128, 160) for need in ("dq", "dkv")]


@pytest.mark.parametrize("layout,dtype,d,need", SUBSETS, ids=[f"{a}-{b}-d{c}-{e}" for a, b, c, e in SUBSETS])
def test_card_path_bwd_subsets(card, layout, dtype, d, need):
    """flash_attention_nlc_bwd and flash_attention_bwd on their card path with
    only dq asked for, or only dk and dv, at a ragged Lq (130: one row past a
    128-row tile of the lse padding): the gradients not asked for are None,
    the others match the plain version, and one launch reaches the kernel of
    the (dtype, head dim)."""
    dt = getattr(torch, dtype)
    tol = BF16_TOL if dt == torch.bfloat16 else TOL
    n, lq, lk, heads = 2, 130, 40, 2
    rng = np.random.default_rng(d + 7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, l, heads * d)).astype(np.float32)).to(dt)
                  for l in (lq, lk, lk, lq))
    scale = d ** -0.5
    need_dq = need == "dq"
    if layout == "packed":
        o, lse = tattn.attention_nlc_plain(q, k, v, heads, scale)
        got = ops.flash_attention_nlc_bwd(q, k, v, o, lse, g, heads, need_dq=need_dq, need_dkv=not need_dq)
        want = tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, heads, scale)
    else:
        split = lambda t: t.view(n, t.shape[1], heads, d).transpose(1, 2)
        q, k, v, g = (split(t) for t in (q, k, v, g))
        o, lse = tattn.attention_plain(q, k, v, scale)
        got = ops.flash_attention_bwd(q, k, v, o, lse, g, need_dq=need_dq, need_dkv=not need_dq)
        want = tattn.attention_bwd_plain(q, k, v, o, lse, g, scale)
    assert card == [_bwd_route(dt, d)]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if (name == "dq") != need_dq:
            assert a is None, name
        else:
            assert a.shape == b.shape and a.dtype == dt and rel_err(a.float(), b.float().numpy()) <= tol, name
