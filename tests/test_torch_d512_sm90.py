"""Head dims 257-511 and the head-dim-512 Hopper kernels, on the CPU.

Part one holds the port against the reference at head dims the TPU path
computes and the port once refused: 320, 384 and 448 on the packed layout,
300 on [B, H, L, D] operands. The port's plain route and its card route (the
wrappers' own padding of the head dim to 512, with the d-512 launchers
replaced by stand-ins that check what the kernels take and compute with the
plain formulas) against the reference's `flash_attention_nlc` /
`flash_attention` and their gradients in interpret mode (float32, 1e-5
relative L2).

Part two checks the rest of what `flash_bwd_d512_sm90.cu` and
`flash_fwd_d512_f32.cu` rely on without running them: which launcher each
(layout, type, gradients asked for) reaches, the launch plans
(`bwd_d512_plan`, `fwd_d512_f32_plan`: every row and head-dim column owned by
exactly one block, shared memory and cluster size within the H100's
limits), the split of the head dim over a pair of blocks (the two partial
sums added in either order give the same bits), and a numpy twin of the
float32 forward's bf16 split, held against an fp64 truth.
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
from tests.test_torch_head_dims import _bwd_formulas
from tests.test_torch_ops import FP32_TOL, BF16_TOL, j, rel, t

SMEM_PER_BLOCK = 232448  # bytes a block may have on the H100 (227 KB)
MAX_CLUSTER = 8  # portable cluster size


def _refuse(*a, **kw):
    raise AssertionError("this head dim reached another kernel")


def _padded(x, d: int) -> None:
    """x is a d-512 kernel's operand: 512 columns, rows 16-byte aligned, the
    columns past the true head dim d zero."""
    assert x.shape[-1] == 512 and tattn._rows_aligned(x), (tuple(x.shape), x.stride())
    assert not x[..., d:].any()


@pytest.fixture
def wide_card(monkeypatch):
    """The wrappers' card path on CPU tensors for head dims 257-512: the
    d-512 launchers replaced by stand-ins (the padded columns must be zero;
    lse and delta [B, H, Lq_pad] padded with +inf and 0 to 64 rows) that
    write the plain result into the outputs the wrapper allocated; every
    other launcher fails. Yields a list the test sets to the true head dim
    (its first item) and that collects the launches."""
    seen = [512]

    def forward(name):
        def launch(q, k, v, out, lse, scale):
            for x in (q, k, v):
                _padded(x, seen[0])
            o, l = tattn.attention_plain(q, k, v, scale)
            out.copy_(o)
            lse.copy_(l)
            seen.append(name)
        return launch

    def backward(name):
        def launch(q, k, v, dout, lse, delta, dq, dk, dv, scale):
            for x in (q, k, v, dout):
                _padded(x, seen[0])
            b, h, lq, _ = q.shape
            for x in (lse, delta):
                assert x.dtype == torch.float32 and x.is_contiguous() and x.shape[:2] == (b, h)
                assert x.shape[2] % 64 == 0 and lq <= x.shape[2] < lq + 64
            assert torch.isposinf(lse[..., lq:]).all() and not delta[..., lq:].any()
            for out, want in zip((dq, dk, dv), _bwd_formulas(q, k, v, dout, lse[..., :lq], delta[..., :lq], scale)):
                if out is not None:
                    out.copy_(want)
            seen.append((name, dq is not None, dk is not None and dv is not None))
        return launch

    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tattn, "flash_fwd_d512_f32", forward("flash_fwd_d512_f32"))
    monkeypatch.setattr(tattn, "flash_fwd_sm90", forward("flash_fwd_sm90"))
    monkeypatch.setattr(tattn, "flash_bwd_d512_f32", backward("flash_bwd_d512_f32"))
    monkeypatch.setattr(tattn, "flash_bwd_d512_sm90", backward("flash_bwd_d512_sm90"))
    for name in ("flash_fwd_f32_sm90", "flash_fwd_wide", "flash_bwd_sm90", "flash_bwd_f32_sm90",
                 "flash_bwd_d256_sm90", "flash_bwd_wide"):
        monkeypatch.setattr(tattn, name, _refuse)
    yield seen
    ops.reset_launch_counts()


# ---- head dims 257-511: the reference's result on every kernel route ----------------------
PART_A = [(320, "packed"), (384, "packed"), (448, "packed"), (300, "strided")]


@pytest.mark.parametrize("route", ["plain", "card"])
@pytest.mark.parametrize("d,layout", PART_A, ids=[f"{layout}-d{d}" for d, layout in PART_A])
def test_head_dims_257_511_match_the_reference(request, d, layout, route):
    """Output and the gradients of q, k and v at a head dim the reference's
    kernels take above 256: the port's plain route, or its card route (the
    head dim zero-padded to 512 for the d-512 kernels, the scale from the
    true d, the output and gradients cut back to d), against the reference
    in interpret mode."""
    rng = np.random.default_rng(d)
    if layout == "packed":
        n, heads, lq, lk = 2, 2, 24, 40
        q, k, v, g = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention_nlc(a, b, c, heads, interpret=True)
        port = lambda a, b, c: tattn.flash_attention_nlc(a, b, c, heads)
    else:
        n, heads, lq, lk = 1, 2, 24, 40
        q, k, v, g = (rng.standard_normal((n, heads, l, d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True)
        port = tattn.flash_attention
    want = ref(j(q), j(k), j(v))
    want_grads = jax.grad(lambda a, b, c: jnp.sum(ref(a, b, c) * j(g)), argnums=(0, 1, 2))(j(q), j(k), j(v))
    if route == "card":
        launches = request.getfixturevalue("wide_card")
        launches[0] = d
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = port(tq, tk, tv)
    out.backward(t(g))
    if route == "card":
        assert launches[1:] == ["flash_fwd_d512_f32", ("flash_bwd_d512_f32", True, True)]
    assert out.shape == tq.shape and rel(out.detach(), want) <= FP32_TOL
    for name, got, ref_grad, x in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want_grads, (tq, tk, tv)):
        assert got.shape == x.shape and rel(got, ref_grad) <= FP32_TOL, name


def test_head_dims_above_512_are_refused(wide_card, monkeypatch):
    """Head dims above 512 are no longer refused: on both layouts they reach
    the wide kernels (flash_fwd_wide, a stand-in here that checks its
    operands are unpadded, aligned and above 512) and give the reference's
    result in interpret mode, where the port once raised; the d-512 kernels
    never see them."""
    def wide(q, k, v, out, lse, scale):
        assert q.shape[-1] > 512 and all(tattn._rows_aligned(x) for x in (q, k, v))
        o, l = tattn.attention_plain(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        wide_card.append("flash_fwd_wide")

    monkeypatch.setattr(tattn, "flash_fwd_wide", wide)
    rng = np.random.default_rng(640)
    x, x2, x3 = (rng.standard_normal((1, l, 640)).astype(np.float32) for l in (8, 12, 12))
    got = tattn.flash_attention_nlc(t(x), t(x2), t(x3), 1)
    assert got.shape == (1, 8, 640) and rel(got, jattn.flash_attention_nlc(j(x), j(x2), j(x3), 1, interpret=True)) <= FP32_TOL
    y, y2, y3 = (rng.standard_normal((1, 1, l, 576)).astype(np.float32) for l in (8, 12, 12))
    got = tattn.flash_attention(t(y), t(y2), t(y3))
    assert got.shape == (1, 1, 8, 576) and rel(got, jattn.flash_attention(j(y), j(y2), j(y3), interpret=True)) <= FP32_TOL
    assert wide_card == [512, "flash_fwd_wide", "flash_fwd_wide"]


# ---- the bf16 backward's routes ----------------------------------------------------------
ROUTES = [(layout, need) for layout in ("packed", "strided") for need in ("dq", "dkv", "both")]


@pytest.mark.parametrize("layout,need", ROUTES, ids=[f"{a}-{b}" for a, b in ROUTES])
def test_bf16_d512_backward_reaches_the_sm90_kernel(wide_card, layout, need):
    """bf16 at head dim 512 (packed, the VAE's mid-attention) and at 384
    ([B, H, L, D] operands, padded to 512) reaches flash_bwd_d512_sm90 once,
    with only the gradients asked for: dq alone runs only the dq kernel (dk
    and dv None), dk/dv alone only the dk/dv kernel. Each gradient against
    the plain backward."""
    rng = np.random.default_rng(7)
    need_dq, need_dkv = need != "dkv", need != "dq"
    if layout == "packed":
        d, heads, shape_q, shape_k = 512, 2, (2, 70, 1024), (2, 45, 1024)
    else:
        d, heads, shape_q, shape_k = 384, 2, (2, 2, 70, 384), (2, 2, 45, 384)
    wide_card[0] = d
    q, o, g = (t(rng.standard_normal(shape_q).astype(np.float32), torch.bfloat16) for _ in range(3))
    k, v = (t(rng.standard_normal(shape_k).astype(np.float32), torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    if layout == "packed":
        _, lse = tattn.attention_nlc_plain(q, k, v, heads, scale)
        got = tattn.flash_attention_nlc_bwd(q, k, v, o, lse, g, heads, need_dq=need_dq, need_dkv=need_dkv)
        want = tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, heads, scale)
    else:
        _, lse = tattn.attention_plain(q, k, v, scale)
        got = tattn.flash_attention_bwd(q, k, v, o, lse, g, need_dq=need_dq, need_dkv=need_dkv)
        want = tattn.attention_bwd_plain(q, k, v, o, lse, g, scale)
    assert wide_card[1:] == [("flash_bwd_d512_sm90", need_dq, need_dkv)]
    for name, a, b, asked in zip(("dq", "dk", "dv"), got, want, (need_dq, need_dkv, need_dkv)):
        if not asked:
            assert a is None, name
        else:
            assert a.dtype == torch.bfloat16 and a.shape == b.shape and rel(a, b.float().numpy()) <= BF16_TOL, name


# ---- the launch plans ---------------------------------------------------------------------
PLAN_SHAPES = [(4, 1, 4096, 4096), (2, 1, 2304, 2304), (2, 2, 1000, 1000)]


def _owned(grid, rows: int, half: int, n: int, h: int, length: int) -> np.ndarray:
    """How many blocks of the grid own each (sample, head, row, column) of a
    [n, h, length, 512] output: block (x, y, z) owns rows
    [rows (x // 2), rows (x // 2 + 1)) below length, columns
    [half (x % 2), half (x % 2 + 1))."""
    gx, gy, gz = grid
    assert (gy, gz) == (h, n)
    count = np.zeros((n, h, length, 512), np.int32)
    for x in range(gx):
        r0, c0 = rows * (x // 2), half * (x % 2)
        count[:, :, r0:min(r0 + rows, length), c0:c0 + half] += 1
    return count


@pytest.mark.parametrize("n,h,lq,lk", PLAN_SHAPES, ids=["stage5-4x4096", "384sq-2x2304", "ragged-1000"])
def test_d512_launch_plans_cover_every_row_once(n, h, lq, lk):
    """The launches of the bf16 backward (dq, dk/dv) and the float32 forward
    at stage 5's shape, at 384^2 (2304 tokens) and at a ragged L: every
    query row (dq, the forward) and key (dk, dv), each head-dim column, is
    written by exactly one block; a block's shared memory fits the H100's
    227 KB; the pairs are clusters of two (at most 8). The streamed tiles
    never read past lse's padding to 64 rows."""
    plan = tattn.bwd_d512_plan(n, h, lq, lk)
    fwd = tattn.fwd_d512_f32_plan(n, h, lq, lk)
    assert plan["cluster"] == fwd["cluster"] == 2 <= MAX_CLUSTER
    assert plan["half"] * plan["cluster"] == 512
    for launch, length in ((plan["dq"], lq), (plan["dkv"], lk), (fwd, lq)):
        assert launch["smem"] <= SMEM_PER_BLOCK
        assert launch["grid"][0] % plan["cluster"] == 0
        assert (_owned(launch["grid"], launch["rows"], plan["half"], n, h, length) == 1).all()
    lq_pad = -(-lq // 64) * 64
    assert lq_pad % plan["dkv"]["tile"] == 0 and -(-lq // plan["dkv"]["tile"]) * plan["dkv"]["tile"] <= lq_pad


# ---- the split of the head dim over a pair of blocks ------------------------------------------
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_pair_partial_sums_give_the_same_bits_in_both_ranks(kernel):
    """A numpy twin of the exchange: each block of the pair computes S over
    its 256 columns (fp32 sums of bf16 products), and S = its partial + the
    peer's. Rank 0 adds S_0 + S_1, rank 1 S_1 + S_0, and in the dk/dv kernel
    warpgroup 1 adds (0 + S_local) + S_peer: the same bits everywhere, so
    both blocks take the same softmax, and within fp32 rounding of the full
    product (fp64 truth)."""
    rng = np.random.default_rng(12)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    q, k = (bf(rng.standard_normal((64, 512)).astype(np.float32) * 3) for _ in range(2))
    s0 = q[:, :256] @ k[:, :256].T
    s1 = q[:, 256:] @ k[:, 256:].T
    rank0, rank1 = s0 + s1, s1 + s0
    if kernel == "dkv":
        rank1 = (np.float32(0) + s1) + s0
    assert rank0.dtype == np.float32 and np.array_equal(rank0.view(np.uint32), rank1.view(np.uint32))
    full = q.astype(np.float64) @ k.T.astype(np.float64)
    bound = 512 * np.finfo(np.float32).eps * (np.abs(q).astype(np.float64) @ np.abs(k).T.astype(np.float64))
    assert (np.abs(rank0 - full) <= bound).all()


# ---- the float32 forward's bf16 split ----------------------------------------------------------
def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _split(x: np.ndarray):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _twin_forward(q, k, v, scale, lk_valid):
    """flash_fwd_d512_f32's arithmetic in numpy: S = q_hi k_hi + q_hi k_lo +
    q_lo k_hi (fp32 sums), keys past lk_valid masked, an fp32 softmax in
    base 2, P split in two as the register operand, O = P_hi V_hi +
    P_hi V_lo + P_lo V_hi, divided by the row sum; lse in base e."""
    f32 = lambda a, b: a.astype(np.float32) @ b.astype(np.float32)
    (qh, ql), (kh, kl), (vh, vl) = _split(q), _split(k), _split(v)
    s = (f32(qh, kh.T) + f32(qh, kl.T) + f32(ql, kh.T)) * np.float32(scale * np.log2(np.e))
    s[:, lk_valid:] = -np.inf
    m = s.max(axis=1, keepdims=True)
    p = np.exp2(s - m).astype(np.float32)
    l = p.sum(axis=1, keepdims=True)
    ph, pl = _split(p)
    o = (f32(ph, vh) + f32(ph, vl) + f32(pl, vh)) / l
    return o, (m[:, 0] + np.log2(l[:, 0])) * np.log(2)


@pytest.mark.parametrize("lk", [1024, 1000], ids=["aligned", "ragged"])
def test_f32_split_meets_the_float32_bar(lk):
    """The numpy twin of the float32 d-512 forward at N 1, L 1024, d 512
    against an fp64 truth: the output within 2e-4 of its largest value (the
    bar chip_smoke.py holds the kernel to against the plain version), lse
    within 1e-3; the ragged case masks the keys past 1000 of the last
    64-key tile."""
    rng = np.random.default_rng(5)
    L, d = 1024, 512
    q, k, v = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    s64 = (q.astype(np.float64) @ k[:lk].T.astype(np.float64)) * scale
    m64 = s64.max(axis=1, keepdims=True)
    p64 = np.exp(s64 - m64)
    l64 = p64.sum(axis=1, keepdims=True)
    o64 = (p64 / l64) @ v[:lk].astype(np.float64)
    lse64 = m64[:, 0] + np.log(l64[:, 0])
    o, lse = _twin_forward(q, k, v, scale, lk)
    assert np.abs(o - o64).max() <= 2e-4 * np.abs(o64).max()
    assert np.abs(lse - lse64).max() <= 1e-3
    # the split keeps 16 bits: well inside the bar, far above bf16 alone
    assert np.abs(o - o64).max() <= 1e-4 * np.abs(o64).max()
