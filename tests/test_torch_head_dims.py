"""Every head dim up to 256 on the port's attention routes, on the CPU.

The kernels zero-pad the head dim: in shared memory (flash_fwd_sm90.cu pads to
a multiple of 64 columns, the backward and float32 kernels to a multiple of
16) and, where a row is not 16-byte aligned, in the wrapper
(`padded_attention`, the reference's `_pad_dim`). Zero columns change no
product and the scale comes from the true head dim, so padding is exact: the
padded plain versions are held against the reference's Pallas kernels in
interpret mode, forward and gradients, at head dims 4, 16, 40, 160 and 256
(float32, 1e-5 relative L2).

The wrappers' own work around the kernels (head-split views of packed
tokens, the padding, the lse layouts, the gradients cut back to the true
head dim) runs here as it runs on the card, with each CUDA launcher replaced
by a stand-in that checks what the kernel requires (16-byte aligned rows, a
head dim it takes, the lse layout) and computes with the plain formulas.
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

    def wmma(q, k, v, out, lse, scale):
        assert q.dtype == torch.float32 and lse.is_contiguous()
        aligned(q, k, v)
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        seen.append("wmma")

    def bwd(q, k, v, dout, lse, delta, dq, dk, dv, scale):
        aligned(q, k, v, dout)
        assert lse.is_contiguous() and delta.is_contiguous() and lse.shape == delta.shape == q.shape[:3]
        for got, want in zip((dq, dk, dv), _bwd_formulas(q, k, v, dout, lse, delta, scale)):
            if got is not None:
                got.copy_(want)
        seen.append("bwd")

    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, t: True)
    monkeypatch.setattr(tattn, "flash_fwd_sm90", sm90)
    monkeypatch.setattr(tattn, "flash_fwd_wmma", wmma)
    monkeypatch.setattr(tattn, "flash_bwd_strided", bwd)
    yield seen
    ops.reset_launch_counts()


GLUE = [(layout, dtype, d) for layout in ("packed", "strided") for dtype in ("bfloat16", "float32")
        for d in (4, 6, 16, 40, 160, 256)]


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
    assert card[0] == ("sm90" if dt == torch.bfloat16 else "wmma")
    assert out.dtype == dt and rel_err(out.float(), want.float().numpy()) <= tol
    assert rel_err(lse, want_lse.numpy()) <= TOL
    got = torch.autograd.grad((out.float() * w.float()).sum(), args)
    assert card[-1] == "bwd"
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_want):
        assert a.shape == b.shape and rel_err(a.float(), b.float().numpy()) <= tol, name
