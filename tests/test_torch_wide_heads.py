"""Head dims above 512 (flash_attn_wide.cu), on the CPU.

The reference computes every head dim: its kernel route sends d % 64 == 0
to the packed kernel and any other d to the strided one, with no width
limit. The port takes d > 512 to `flash_fwd_wide` and `flash_bwd_wide`
(128-column slices of the outputs, a block a slice, S and dP over the whole
head dim in every block). Here:

  * the port's plain route and its card route (the wrappers' own work, with
    the two wide launchers replaced by stand-ins that check what the kernels
    take, unpadded 16-byte rows, lse and delta [B, H, Lq_pad] padded to 64
    rows with +inf and 0, and compute with the kernels' slice decomposition)
    against the reference's `flash_attention_nlc` / `flash_attention` and
    their gradients in interpret mode, at d 576, 640 and 1024 packed and 600
    strided (float32, 1e-5 relative L2);
  * which launcher each (layout, type, head dim, gradients asked for)
    reaches;
  * `wide_plan`: every row and head-dim column of each output owned by
    exactly one block, shared memory within the H100's 227 KB;
  * a numpy twin of the decomposition (S summed over 64-column chunks in one
    order in every slice, each slice's outputs concatenated) against fp64,
    in bf16 and on float32's two-part split.
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
from tests.test_torch_ops import BF16_TOL, FP32_TOL, j, rel, t

SMEM_PER_BLOCK = 232448  # bytes a block may have on the H100 (227 KB)
SLICE, CHUNK = 128, 64


def _slices(d: int):
    return [(c0, min(c0 + SLICE, d)) for c0 in range(0, d, SLICE)]


def _chunked(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T over the head dim as the kernels sum it: 64-column chunks, in
    order, into one fp32 accumulator."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
    for c0 in range(0, a.shape[-1], CHUNK):
        acc = acc + a[..., c0:c0 + CHUNK].float() @ b[..., c0:c0 + CHUNK].float().transpose(-1, -2)
    return acc


def _slice_forward(q, k, v, scale):
    """The wide forward's decomposition on [B, H, L, D]: every slice's block
    computes the whole S (the same bits in every slice) and its own slice of
    O; lse from the block of slice 0."""
    outs, s_first = [], None
    for c0, c1 in _slices(q.shape[-1]):
        s = _chunked(q, k) * scale
        if s_first is None:
            s_first = s
        assert torch.equal(s, s_first)
        lse = torch.logsumexp(s, dim=-1)
        outs.append(torch.exp(s - lse[..., None]) @ v[..., c0:c1].float())
    return torch.cat(outs, dim=-1), torch.logsumexp(s_first, dim=-1)


def _slice_backward(q, k, v, dout, lse, delta, scale):
    """The wide backward's decomposition: per slice, P and dS from the whole
    S and dP, and that slice's columns of dq, dk and dv."""
    p = torch.exp(_chunked(q, k) * scale - lse[..., None])
    ds = p * (_chunked(dout, v) - delta[..., None])
    parts = [(ds @ k[..., c0:c1].float() * scale, ds.transpose(-1, -2) @ q[..., c0:c1].float() * scale,
              p.transpose(-1, -2) @ dout[..., c0:c1].float()) for c0, c1 in _slices(q.shape[-1])]
    return tuple(torch.cat(g, dim=-1) for g in zip(*parts))


@pytest.fixture
def wide(monkeypatch):
    """The wrappers' card path on CPU tensors for head dims above 512: the
    wide launchers replaced by stand-ins that check their operands (the
    true head dim, unpadded but for 16-byte rows; lse and delta
    [B, H, Lq_pad] fp32, padded to 64 rows with +inf and 0) and compute with
    the slice decomposition into the outputs the wrapper allocated; every
    other launcher fails. Yields the launches."""
    seen = []

    def refuse(*a, **kw):
        raise AssertionError("a head dim above 512 reached another kernel")

    def checked(*xs):
        for x in xs:
            assert x.shape[-1] > 512 and tattn._rows_aligned(x) and x.shape[-1] % (16 // x.element_size()) == 0

    def forward(q, k, v, out, lse, scale):
        checked(q, k, v, out)
        o, l = _slice_forward(q, k, v, scale)
        out.copy_(o)
        lse.copy_(l)
        seen.append(("flash_fwd_wide", q.dtype))

    def backward(q, k, v, dout, lse, delta, dq, dk, dv, scale):
        checked(q, k, v, dout, *(x for x in (dq, dk, dv) if x is not None))
        b, h, lq, _ = q.shape
        for x in (lse, delta):
            assert x.dtype == torch.float32 and x.is_contiguous() and x.shape[:2] == (b, h)
            assert x.shape[2] % 64 == 0 and lq <= x.shape[2] < lq + 64
        assert torch.isposinf(lse[..., lq:]).all() and not delta[..., lq:].any()
        for out, want in zip((dq, dk, dv), _slice_backward(q, k, v, dout, lse[..., :lq], delta[..., :lq], scale)):
            if out is not None:
                out.copy_(want)
        seen.append(("flash_bwd_wide", q.dtype, dq is not None, dk is not None and dv is not None))

    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tattn, "flash_fwd_wide", forward)
    monkeypatch.setattr(tattn, "flash_bwd_wide", backward)
    for name in ("flash_fwd_sm90", "flash_fwd_f32_sm90", "flash_fwd_d512_f32", "flash_bwd_sm90",
                 "flash_bwd_f32_sm90", "flash_bwd_d256_sm90", "flash_bwd_d512_sm90", "flash_bwd_d512_f32"):
        monkeypatch.setattr(tattn, name, refuse)
    yield seen
    ops.reset_launch_counts()


# ---- the reference's result on every route ------------------------------------------------
CASES = [(576, "packed"), (640, "packed"), (1024, "packed"), (600, "strided")]


@pytest.mark.parametrize("route", ["plain", "card"])
@pytest.mark.parametrize("d,layout", CASES, ids=[f"{layout}-d{d}" for d, layout in CASES])
def test_wide_head_dims_match_the_reference(request, d, layout, route):
    """Output and the gradients of q, k and v above head dim 512: the port's
    plain route, or its card route (the wide kernels' slice decomposition
    behind the wrappers' views, padding and lse layouts), against the
    reference in interpret mode."""
    rng = np.random.default_rng(d)
    n, heads, lq, lk = (2, 2, 24, 40) if layout == "packed" else (1, 2, 24, 40)
    if layout == "packed":
        q, k, v, g = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention_nlc(a, b, c, heads, interpret=True)
        port = lambda a, b, c: tattn.flash_attention_nlc(a, b, c, heads)
    else:
        q, k, v, g = (rng.standard_normal((n, heads, l, d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True)
        port = tattn.flash_attention
    want = ref(j(q), j(k), j(v))
    want_grads = jax.grad(lambda a, b, c: jnp.sum(ref(a, b, c) * j(g)), argnums=(0, 1, 2))(j(q), j(k), j(v))
    seen = request.getfixturevalue("wide") if route == "card" else None
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = port(tq, tk, tv)
    out.backward(t(g))
    if route == "card":
        assert seen == [("flash_fwd_wide", torch.float32), ("flash_bwd_wide", torch.float32, True, True)]
    assert out.shape == tq.shape and rel(out.detach(), want) <= FP32_TOL
    for name, got, ref_grad, x in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want_grads, (tq, tk, tv)):
        assert got.shape == x.shape and rel(got, ref_grad) <= FP32_TOL, name


# ---- which launcher each call reaches -------------------------------------------------------
ROUTES = [(layout, dtype, need) for layout in ("packed", "strided") for dtype in ("bfloat16", "float32")
          for need in ("dq", "dkv", "both")]


@pytest.mark.parametrize("layout,dtype,need", ROUTES, ids=[f"{a}-{b}-{c}" for a, b, c in ROUTES])
def test_wide_routes_and_gradient_subsets(wide, layout, dtype, need):
    """Both types at d 640 (packed) and 584 or 602 (strided: bf16 a multiple
    of 8; float32 602 is padded to 604 for 16-byte rows) with Lq 70 (six rows
    past a 64-row tile of the lse padding): the forward reaches
    flash_fwd_wide, the backward flash_bwd_wide once with only the gradients
    asked for, each against the plain versions."""
    dt = getattr(torch, dtype)
    need_dq, need_dkv = need != "dkv", need != "dq"
    d = 640 if layout == "packed" else (584 if dt == torch.bfloat16 else 602)
    rng = np.random.default_rng(d)
    n, heads, lq, lk = 2, 2, 70, 45
    if layout == "packed":
        q, g = (t(rng.standard_normal((n, lq, heads * d)).astype(np.float32), dt) for _ in range(2))
        k, v = (t(rng.standard_normal((n, lk, heads * d)).astype(np.float32), dt) for _ in range(2))
        out, lse = tattn.flash_attention_nlc(q, k, v, heads, return_lse=True)
        o, want_lse = tattn.attention_nlc_plain(q, k, v, heads, d ** -0.5)
        got = tattn.flash_attention_nlc_bwd(q, k, v, o, want_lse, g, heads, need_dq=need_dq, need_dkv=need_dkv)
        want = tattn.attention_nlc_bwd_plain(q, k, v, o, want_lse, g, heads, d ** -0.5)
    else:
        q, g = (t(rng.standard_normal((n, heads, lq, d)).astype(np.float32), dt) for _ in range(2))
        k, v = (t(rng.standard_normal((n, heads, lk, d)).astype(np.float32), dt) for _ in range(2))
        out, lse = tattn.flash_attention(q, k, v, return_lse=True)
        o, want_lse = tattn.attention_plain(q, k, v, d ** -0.5)
        got = tattn.flash_attention_bwd(q, k, v, o, want_lse, g, need_dq=need_dq, need_dkv=need_dkv)
        want = tattn.attention_bwd_plain(q, k, v, o, want_lse, g, d ** -0.5)
    assert wide == [("flash_fwd_wide", dt), ("flash_bwd_wide", dt, need_dq, need_dkv)]
    tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
    assert out.dtype == dt and out.shape == q.shape and rel(out, o.float().numpy()) <= tol
    assert lse.shape == want_lse.shape and rel(lse, want_lse.numpy()) <= FP32_TOL
    for name, a, b, asked in zip(("dq", "dk", "dv"), got, want, (need_dq, need_dkv, need_dkv)):
        if not asked:
            assert a is None, name
        else:
            assert a.dtype == dt and a.shape == b.shape and rel(a, b.float().numpy()) <= tol, name


# ---- the launch plan --------------------------------------------------------------------------
PLAN_SHAPES = [(1, 1, 4096, 4096, 640), (2, 2, 1000, 2100, 1024), (2, 2, 70, 45, 576), (1, 3, 130, 64, 600)]


def _owned(launch, plan, n, h, length, d) -> np.ndarray:
    """How many blocks own each (sample, head, row, column) of an
    [n, h, length, d] output: block (x, y, z) owns rows
    [rows (x // slices), + rows) below length and columns
    [128 (x % slices), + 128) below d."""
    gx, gy, gz = launch["grid"]
    assert (gy, gz) == (h, n) and gx % plan["slices"] == 0
    count = np.zeros((n, h, length, d), np.int32)
    for x in range(gx):
        r0, c0 = launch["rows"] * (x // plan["slices"]), plan["slice"] * (x % plan["slices"])
        count[:, :, r0:min(r0 + launch["rows"], length), c0:min(c0 + plan["slice"], d)] += 1
    return count


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("n,h,lq,lk,d", PLAN_SHAPES, ids=["d640-4096", "d1024-ragged", "d576-small", "d600-3h"])
def test_wide_plan_covers_every_row_and_column_once(n, h, lq, lk, d, parts):
    """The forward, dq and dk/dv launches: every query row (forward, dq) and
    key (dk, dv), each head-dim column, written by exactly one block; the
    chunks cover the head dim, the float32 scratch's width the slices; the
    dk/dv kernel's 32-row query tiles never read past lse's padding to 64
    rows; a block's shared memory fits the H100's 227 KB."""
    plan = tattn.wide_plan(n, h, lq, lk, d, parts)
    assert plan["slices"] * plan["slice"] == plan["width"] >= d > plan["width"] - plan["slice"]
    assert plan["chunks"] * 64 >= d > (plan["chunks"] - 1) * 64
    for name, length in (("fwd", lq), ("dq", lq), ("dkv", lk)):
        launch = plan[name]
        assert launch["smem"] <= SMEM_PER_BLOCK, name
        assert (_owned(launch, plan, n, h, length, d) == 1).all(), name
    assert 64 % plan["dkv"]["tile"] == 0


# ---- a numpy twin of the slice decomposition -----------------------------------------------------
def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _parts(x: np.ndarray, parts: int):
    hi = _bf16(x)
    return (hi,) if parts == 1 else (hi, _bf16(x - hi))


def _f32_product(a, b):
    """sum of the part products a_hi b_hi (+ a_hi b_lo + a_lo b_hi), fp32."""
    out = a[0] @ b[0]
    if len(a) == 2:
        out = out + a[0] @ b[1] + a[1] @ b[0]
    return out.astype(np.float32)


def _twin(q, k, v, dout, scale, parts):
    """The wide kernels' arithmetic in numpy for one head: S and dP summed
    over 64-column chunks in chunk order in every slice's block (the same
    bits in each), P and dS rounded to the operand parts, each slice's
    columns of O, dq, dk and dv; returns (o, lse, dq, dk, dv)."""
    L, d = q.shape
    qp, kp, vp, gp = (_parts(x, parts) for x in (q, k, v, dout))
    chunks = [(c, min(c + 64, d)) for c in range(0, d, 64)]

    def chunked(a, b):
        acc = np.zeros((a[0].shape[0], b[0].shape[0]), np.float32)
        for c0, c1 in chunks:
            acc = acc + _f32_product([x[:, c0:c1] for x in a], [x[:, c0:c1].T for x in b])
        return acc

    outs = {"o": [], "dq": [], "dk": [], "dv": []}
    s_bits = None
    for c0, c1 in _slices(d):
        s = chunked(qp, kp) * np.float32(scale * np.log2(np.e))
        s_bits = s if s_bits is None else s_bits
        assert np.array_equal(s.view(np.uint32), s_bits.view(np.uint32))
        m = s.max(axis=1, keepdims=True)
        p = np.exp2(s - m).astype(np.float32)
        l = p.sum(axis=1, keepdims=True)
        outs["o"].append(_f32_product(_parts(p, parts), [x[:, c0:c1] for x in vp]) / l)
        lse = (m[:, 0] + np.log2(l[:, 0])) * np.log(2)
        # the backward from that lse and delta = sum dO * O (computed outside the kernels)
        pb = np.exp(chunked(qp, kp) * np.float32(scale) - lse[:, None]).astype(np.float32)
        delta = (dout.astype(np.float64) * _o_fp64(q, k, v, scale)).sum(axis=1).astype(np.float32)
        ds = (pb * (chunked(gp, vp) - delta[:, None])).astype(np.float32)
        outs["dq"].append(_f32_product(_parts(ds, parts), [x[:, c0:c1] for x in kp]) * scale)
        outs["dk"].append(_f32_product(_parts(ds.T, parts), [x[:, c0:c1] for x in qp]) * scale)
        outs["dv"].append(_f32_product(_parts(pb.T, parts), [x[:, c0:c1] for x in gp]))
    cat = {key: np.concatenate(val, axis=1) for key, val in outs.items()}
    return cat["o"], lse, cat["dq"], cat["dk"], cat["dv"]


def _o_fp64(q, k, v, scale):
    """The fp64 output of attention on one head."""
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v.astype(np.float64)


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("d", [576, 1024])
def test_slice_decomposition_twin_against_fp64(d, parts):
    """The numpy twin of the wide kernels at L 128 against an fp64 truth:
    every slice's S the same bits; the concatenated slices' output and
    gradients within the bars chip_smoke.py holds the kernels to (bf16: 4
    bf16 steps of each output's largest value; float32's two-part split:
    2e-4 of it), lse within 1e-3."""
    rng = np.random.default_rng(d + parts)
    L = 128
    q, k, v, g = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(4))
    if parts == 1:  # bf16 operands, as the kernels are given them
        q, k, v, g = (_bf16(x) for x in (q, k, v, g))
    scale = d ** -0.5
    o, lse, dq, dk, dv = _twin(q, k, v, g, scale, parts)
    q64, k64, v64, g64 = (x.astype(np.float64) for x in (q, k, v, g))
    s64 = q64 @ k64.T * scale
    lse64 = np.log(np.exp(s64 - s64.max(axis=1, keepdims=True)).sum(axis=1)) + s64.max(axis=1)
    p64 = np.exp(s64 - lse64[:, None])
    o64 = p64 @ v64
    ds64 = p64 * (g64 @ v64.T - (g64 * o64).sum(axis=1, keepdims=True))
    truth = {"o": o64, "dq": ds64 @ k64 * scale, "dk": ds64.T @ q64 * scale, "dv": p64.T @ g64}
    bar = 4 * 2.0 ** -8 if parts == 1 else 2e-4
    for name, got in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.shape == (L, d)
        assert np.abs(got - truth[name]).max() <= bar * np.abs(truth[name]).max(), name
    assert np.abs(lse - lse64).max() <= 1e-3


# ---- the float32 stage-5 steps that chip_smoke.py runs through these kernels -----------------
@pytest.mark.parametrize("vae,head_dim,fwd,bwd", [
    ("flagship", 512, "flash_fwd_d512_f32", "flash_bwd_d512_f32"),
    ("small", 256, "flash_fwd_f32_sm90", "flash_bwd_d256_sm90"),
    ("640", 640, "flash_fwd_wide", "flash_bwd_wide")])
def test_stage5_vae_variants_take_their_kernels(vae, head_dim, fwd, bwd):
    """chip_smoke.py's float32 stage-5 steps (train_step_vae and its small
    and width-640 VAEs): each VAE's mid-attention head dim is its last
    width (the small one's is the small preset's VAE), a multiple of 64, so
    on the packed route, and stage05_launches expects its two mid-attentions
    on the forward and backward kernels of that head dim and nothing else."""
    import dataclasses

    import chip_smoke
    from emox_torch.core.presets import flagship_config, small_config

    cfg = flagship_config(256, 1)
    if chip_smoke.VAE_VARIANTS[vae]:
        cfg = cfg.replace(vae=dataclasses.replace(cfg.vae, **chip_smoke.VAE_VARIANTS[vae]))
    assert cfg.vae.base_channels * cfg.vae.channel_multipliers[-1] == head_dim and head_dim % 64 == 0
    if vae == "small":
        small = small_config().vae
        assert (small.base_channels, small.channel_multipliers) == (cfg.vae.base_channels, cfg.vae.channel_multipliers)
    want = chip_smoke.stage05_launches(5, "float32", head_dim=head_dim)
    assert {k: n for k, n in want.items() if n} == {"flash_attn_nlc_fwd": 2, "flash_attn_nlc_bwd": 2, fwd: 2, bwd: 2}
