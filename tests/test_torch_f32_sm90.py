"""The float32 attention kernels on Hopper and the backward at head dims
129-256 (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_d512_sm90.cu at
half width, flash_attn_wide.cu's entries), on the CPU.

Float32 runs on bf16 wgmma: each operand x is split into hi = bf16(x) and
lo = bf16(x - hi) in scratch the wrapper allocates, every product a b runs
as a_hi b_hi + a_hi b_lo + a_lo b_hi with fp32 accumulation, and P and dS
are split in registers. Here `build.kernel` hands the wrappers stand-in C
entries that read the tensors at the pointers and strides they are given,
check the scratch (the tensors `_split_scratch` allocated, of the width the
C entry computes from the head dim) and the lse / delta padding, write the
split into the scratch as the split launch does, and compute with the
kernels' arithmetic from the scratch; the results are held against the
plain versions. Then:

  * which entry each (layout, type, head dim) reaches: float32 forward at
    d <= 256 -> emox_flash_fwd_f32_sm90, float32 backward at <= 128 ->
    emox_flash_bwd_f32_sm90, both types at 129-256 ->
    emox_flash_bwd_d256_sm90, bf16 at <= 128 untouched;
  * the launch plans (`f32_plan`, `bwd_d512_plan` at half width in both
    types): every row owned by one block, shared memory within 227 KB;
  * numpy twins of the split forward at d 64 and 256 and of the split
    backward (P and dS split too) against fp64, within the float32 bar.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from emox_torch import ops
from emox_torch.ops import attention as tattn
from emox_torch.ops import build
from tests.test_torch_ops import BF16_TOL, rel, t

SMEM_PER_BLOCK = 232448  # bytes a block may have on the H100 (227 KB)
F32_BAR = 2e-4  # float32 against the plain version: of the largest output value (chip_smoke.py's bar)
LOG2E = math.log2(math.e)


def _view(ptr: int, shape, strides, dtype) -> torch.Tensor:
    """The writable tensor of `shape` with element `strides` at host address
    `ptr` (a CPU tensor's data_ptr)."""
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    flat = torch.frombuffer((ctypes.c_char * (extent * size)).from_address(ptr), dtype=dtype)
    return flat.as_strided(shape, strides)


def _parts(x: torch.Tensor, parts: int):
    hi = x.float().to(torch.bfloat16)
    return (hi.float(),) if parts == 1 else (hi.float(), (x.float() - hi.float()).to(torch.bfloat16).float())


def _product(a, b):
    """a b over the parts: a_hi b_hi (+ a_hi b_lo + a_lo b_hi), fp32."""
    out = a[0] @ b[0]
    if len(a) == 2:
        out = out + a[0] @ b[1] + a[1] @ b[0]
    return out


@pytest.fixture
def entries(monkeypatch):
    """build.kernel hands out stand-in C entries for the new launchers;
    `_split_scratch` records what it allocates. Yields the calls."""
    calls, scratch = [], []
    real_scratch = tattn._split_scratch

    def recording_scratch(w, *tensors):
        out = real_scratch(w, *tensors)
        scratch.extend(out)
        return out

    def operand(ptr, st, b, h, length, d, dtype):
        return _view(ptr, (b, h, length, d), (st[0], st[1], st[2], 1), dtype)

    def split_into(x, ptr, w):
        """The split launch: x's parts into the scratch at ptr ([B, H, L, 2w]
        bf16, hi | lo, zero past d), which the wrapper must have allocated."""
        b, h, length, d = x.shape
        assert d <= w and any(s.data_ptr() == ptr and s.shape == (b, h, length, 2 * w) for s in scratch), (ptr, w)
        buf = _view(ptr, (b, h, length, 2 * w), (h * length * 2 * w, length * 2 * w, 2 * w, 1), torch.bfloat16)
        hi, lo = _parts(x, 2)
        buf.zero_()
        buf[..., :d] = hi.to(torch.bfloat16)
        buf[..., w:w + d] = lo.to(torch.bfloat16)
        return buf[..., :d].float(), buf[..., w:w + d].float()

    def forward(entry, parts, q, k, v, o, lse, st, b, h, lq, lk, d, scale, dtype, q2, k2, v2, width):
        dt = torch.float32 if parts == 2 else torch.bfloat16
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, d, dt) for i, (p, n) in enumerate(((q, lq), (k, lk), (v, lk)))]
        assert all(p % 16 == 0 for p in (q, k, v, o))
        if parts == 2:
            xs = [split_into(x, p, width) for x, p in zip(xs, (q2, k2, v2))]
        else:
            assert q2 is None and k2 is None and v2 is None
            xs = [(x.float(),) for x in xs]
        qp, kp, vp = xs
        s = _product(qp, [x.transpose(-1, -2) for x in kp]) * scale
        lse_v = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse_v[..., None])
        _view(o, (b, h, lq, d), (st[9], st[10], st[11], 1), dt).copy_(_product(_parts(p, parts), vp))
        _view(lse, (b, h, lq), (st[12], st[13], st[14]), torch.float32).copy_(lse_v)
        calls.append((entry, dt, d))
        return 0

    def backward(entry, parts, q, k, v, dout, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, d, scale,
                 q2, k2, v2, do2, width, rows):
        dt = torch.float32 if parts == 2 else torch.bfloat16
        assert lq_pad % rows == 0 and lq <= lq_pad < lq + rows and (dk is None) == (dv is None)
        lens = (lq, lk, lk, lq)
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, d, dt) for i, (p, n) in enumerate(zip((q, k, v, dout), lens))]
        if parts == 2:
            xs = [split_into(x, p, width) for x, p in zip(xs, (q2, k2, v2, do2))]
        else:
            assert q2 is None and do2 is None
            xs = [(x.float(),) for x in xs]
        qp, kp, vp, gp = xs
        flat = lambda p: _view(p, (b, h, lq_pad), (h * lq_pad, lq_pad, 1), torch.float32)
        lse_v, delta_v = flat(lse), flat(delta)
        assert torch.isposinf(lse_v[..., lq:]).all() and not delta_v[..., lq:].any()
        tr = lambda xp: [x.transpose(-1, -2) for x in xp]
        p = torch.exp(_product(qp, tr(kp)) * scale - lse_v[..., :lq, None])
        ds = p * (_product(gp, tr(vp)) - delta_v[..., :lq, None])
        grads = (_product(_parts(ds, parts), kp) * scale,
                 _product(_parts(ds.transpose(-1, -2), parts), qp) * scale,
                 _product(_parts(p.transpose(-1, -2), parts), gp))
        for i, (ptr, g) in enumerate(zip((dq, dk, dv), grads)):
            if ptr is not None:
                n = lq if i == 0 else lk
                _view(ptr, (b, h, n, d), tuple(st[12 + 3 * i:15 + 3 * i]) + (1,), dt).copy_(g)
        calls.append((entry, dt, d, dq is not None, dk is not None))
        return 0

    width = lambda d: tattn.split_width(d)
    c_entries = {
        "emox_flash_fwd_f32_sm90": lambda q, k, v, o, lse, st, b, h, lq, lk, d, scale, q2, k2, v2, stream: forward(
            "fwd_f32_sm90", 2, q, k, v, o, lse, st, b, h, lq, lk, d, scale, 0, q2, k2, v2, width(d)),
        "emox_flash_fwd_wide": lambda q, k, v, o, lse, st, b, h, lq, lk, d, scale, dtype, q2, k2, v2, stream: forward(
            "fwd_wide", 2 - dtype, q, k, v, o, lse, st, b, h, lq, lk, d, scale, dtype, q2, k2, v2, -(-d // 128) * 128),
        "emox_flash_bwd_f32_sm90": lambda q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, d, scale,
        q2, k2, v2, do2, stream: backward("bwd_f32_sm90", 2, q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk,
                                          lq_pad, d, scale, q2, k2, v2, do2, width(d), 128),
        "emox_flash_bwd_d256_sm90": lambda q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, d, scale,
        dtype, q2, k2, v2, do2, stream: backward("bwd_d256_sm90", 2 - dtype, q, k, v, g, lse, delta, dq, dk, dv, st,
                                                 b, h, lq, lk, lq_pad, d, scale, q2, k2, v2, do2, 256, 64),
        "emox_flash_bwd_wide": lambda q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, d, scale,
        dtype, q2, k2, v2, do2, stream: backward("bwd_wide", 2 - dtype, q, k, v, g, lse, delta, dq, dk, dv, st, b, h,
                                                 lq, lk, lq_pad, d, scale, q2, k2, v2, do2, -(-d // 128) * 128, 64),
    }

    def kernel(name, fn_name=""):
        assert fn_name in c_entries, (name, fn_name)
        assert len(build.KERNELS[name][fn_name]) == c_entries[fn_name].__code__.co_argcount
        return c_entries[fn_name]

    monkeypatch.setattr(build, "kernel", kernel)
    monkeypatch.setattr(tattn, "_split_scratch", recording_scratch)
    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tattn, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tattn, "flash_fwd_sm90", lambda *a: calls.append(("fwd_sm90",)))
    monkeypatch.setattr(tattn, "flash_bwd_sm90", lambda *a: calls.append(("bwd_sm90",)))
    yield calls
    ops.reset_launch_counts()


CASES = [(layout, dtype, d) for layout in ("packed", "strided") for dtype in ("float32", "bfloat16")
         for d in (40, 64, 128, 160, 256, 600)]


@pytest.mark.parametrize("layout,dtype,d", CASES, ids=[f"{a}-{b}-d{c}" for a, b, c in CASES])
def test_entries_take_the_split_and_match_the_plain_version(entries, layout, dtype, d):
    """The wrappers on their card path, through the C entries: the entry of
    each (layout, type, head dim), the scratch and lse padding they take,
    and the output, lse and gradients the kernels' arithmetic gives from the
    split against the plain versions (float32: within 2e-4 of the largest
    value, the bar chip_smoke.py holds the kernels to; bf16: two bf16 steps,
    relative L2). bf16 at head dims <= 128 and its forward at <= 256 stay on
    the bf16 kernels."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(d)
    n, heads, lq, lk = 2, 2, 70, 45
    if layout == "packed":
        q, g = (t(rng.standard_normal((n, lq, heads * d)).astype(np.float32), dt) for _ in range(2))
        k, v = (t(rng.standard_normal((n, lk, heads * d)).astype(np.float32), dt) for _ in range(2))
        o, lse = tattn.attention_nlc_plain(q, k, v, heads, d ** -0.5)
        fwd = lambda: tattn.flash_attention_nlc(q, k, v, heads, return_lse=True)
        bwd = lambda: tattn.flash_attention_nlc_bwd(q, k, v, o, lse, g, heads)
        want = tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, heads, d ** -0.5)
    else:
        q, g = (t(rng.standard_normal((n, heads, lq, d)).astype(np.float32), dt) for _ in range(2))
        k, v = (t(rng.standard_normal((n, heads, lk, d)).astype(np.float32), dt) for _ in range(2))
        o, lse = tattn.attention_plain(q, k, v, d ** -0.5)
        fwd = lambda: tattn.flash_attention(q, k, v, return_lse=True)
        bwd = lambda: tattn.flash_attention_bwd(q, k, v, o, lse, g)
        want = tattn.attention_bwd_plain(q, k, v, o, lse, g, d ** -0.5)
    wide, f32 = d > 512, dt == torch.float32
    out, got_lse = fwd()
    grads = bwd()
    fwd_entry = "fwd_wide" if wide else ("fwd_f32_sm90" if f32 else "fwd_sm90")
    bwd_entry = "bwd_wide" if wide else ("bwd_d256_sm90" if d > 128 else ("bwd_f32_sm90" if f32 else "bwd_sm90"))
    assert [c[0] for c in entries] == [fwd_entry, bwd_entry]
    checks = [] if fwd_entry == "fwd_sm90" else [("out", out, o)]
    checks += [] if bwd_entry == "bwd_sm90" else list(zip(("dq", "dk", "dv"), grads, want))
    for name, a, b in checks:
        assert a.shape == b.shape and a.dtype == dt, name
        if f32:
            assert (a - b).abs().max() <= F32_BAR * b.abs().max(), name
        else:
            assert rel(a, b.float().numpy()) <= BF16_TOL, name
    if fwd_entry != "fwd_sm90":
        assert got_lse.shape == lse.shape and (got_lse - lse).abs().max() <= 1e-3


# ---- the launch plans ----------------------------------------------------------------------
PLAN_SHAPES = [(2, 5, 1024, 2048), (32, 8, 1024, 2048), (2, 3, 1000, 2100), (1, 1, 70, 45)]


def _rows_owned(grid, rows: int, length: int, pairs: int = 1) -> np.ndarray:
    """How many blocks (of `pairs` a tile) own each row of a length-row output."""
    count = np.zeros(length, np.int32)
    for x in range(0, grid[0], pairs):
        r0 = rows * (x // pairs)
        count[r0:min(r0 + rows, length)] += 1
    return count


@pytest.mark.parametrize("n,h,lq,lk", PLAN_SHAPES, ids=["f32-train", "f32-step", "ragged", "small"])
@pytest.mark.parametrize("d", [4, 40, 64, 80, 128, 160, 256])
def test_f32_plans_fit_and_cover_every_row_once(d, n, h, lq, lk):
    """f32_plan: the split's width (64, 128, 256, the C entries' choice),
    every query row (forward, dq) and key (dk/dv) owned by exactly one
    block, the shared memory within the H100's 227 KB; the dk/dv tiles never
    read past lse's padding to 128 rows. Above 128 the backward is the pair
    at half width in both types: bwd_d512_plan(half=128)."""
    plan = tattn.f32_plan(n, h, lq, lk, d)
    assert plan["width"] == (64 if d <= 64 else 128 if d <= 128 else 256) >= d
    names = ("fwd", "dq", "dkv") if d <= 128 else ("fwd",)
    assert set(plan) == {"width", *names}
    for name in names:
        launch, length = plan[name], lk if name == "dkv" else lq
        assert launch["grid"][1:] == (h, n) and launch["smem"] <= SMEM_PER_BLOCK, name
        assert (_rows_owned(launch["grid"], launch["rows"], length) == 1).all(), name
    if d <= 128:
        assert 128 % plan["dkv"]["tile"] == 0
    for parts in (1, 2):
        pair = tattn.bwd_d512_plan(n, h, lq, lk, half=128, parts=parts)
        assert pair["half"] * pair["cluster"] == 256 and pair["parts"] == parts
        for name, length in (("dq", lq), ("dkv", lk)):
            assert pair[name]["smem"] <= SMEM_PER_BLOCK
            assert (_rows_owned(pair[name]["grid"], pair[name]["rows"], length, pairs=2) == 1).all()


def test_pair_plan_keeps_head_dim_512_unchanged():
    """The d-512 pair's plan at its defaults is its bf16 layout at head
    dim 512, unchanged (230,472 and 231,504 bytes), and float32 at half width holds as many
    bytes as bf16 at full width."""
    plan = tattn.bwd_d512_plan(4, 1, 4096, 4096)
    assert (plan["dq"]["smem"], plan["dkv"]["smem"]) == (230472, 231504)
    f32 = tattn.bwd_d512_plan(4, 1, 4096, 4096, half=128, parts=2)
    assert (f32["dq"]["smem"], f32["dkv"]["smem"]) == (230472, 231504)


# ---- numpy twins of the split arithmetic against fp64 ----------------------------------------
def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _split(x: np.ndarray):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm(a, b):
    """(a_hi, a_lo) (b_hi, b_lo) as the kernels sum it, fp32."""
    f = lambda x, y: x.astype(np.float32) @ y.astype(np.float32)
    return f(a[0], b[0]) + f(a[0], b[1]) + f(a[1], b[0])


def _truth(q, k, v, g, scale, lk):
    q, k, v, g = (x.astype(np.float64) for x in (q, k[:lk], v[:lk], g))
    s = q @ k.T * scale
    lse = np.log(np.exp(s - s.max(axis=1, keepdims=True)).sum(axis=1)) + s.max(axis=1)
    p = np.exp(s - lse[:, None])
    o = p @ v
    ds = p * (g @ v.T - (g * o).sum(axis=1, keepdims=True))
    return o, lse, ds @ k * scale, ds.T @ q * scale, p.T @ g


@pytest.mark.parametrize("lk", [1024, 1000], ids=["aligned", "ragged"])
@pytest.mark.parametrize("d", [64, 256])
def test_split_forward_twin_meets_the_float32_bar(d, lk):
    """The float32 forward's arithmetic (q, k, v split in scratch, S as three
    products, keys past lk masked, an fp32 softmax in base 2, P split in
    registers, O as three products) at L 1024 against fp64: within 2e-4 of
    the largest output (the bar on the card), lse within 1e-3."""
    rng = np.random.default_rng(d + lk)
    L = 1024
    q, k, v = (rng.standard_normal((L, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    qs, ks, vs = _split(q), _split(k), _split(v)
    s = _mm(qs, (ks[0].T, ks[1].T)) * np.float32(scale * LOG2E)
    s[:, lk:] = -np.inf
    m = s.max(axis=1, keepdims=True)
    p = np.exp2(s - m).astype(np.float32)
    l = p.sum(axis=1, keepdims=True)
    o = _mm(_split(p), vs) / l
    lse = (m[:, 0] + np.log2(l[:, 0])) * np.log(2)
    o64, lse64, *_ = _truth(q, k, v, q, scale, lk)
    assert np.abs(o - o64).max() <= F32_BAR * np.abs(o64).max()
    assert np.abs(lse - lse64).max() <= 1e-3


@pytest.mark.parametrize("d", [64, 128, 256])
def test_split_backward_twin_meets_the_float32_bar(d):
    """The float32 backward's arithmetic (q, k, v, dO split; S and dP as
    three products each; P and dS split in registers as the A operand of
    dq, dk and dv) at Lq 512, Lk 1024, from the fp64 forward's lse and
    delta, against fp64: each gradient within 2e-4 of its largest value."""
    rng = np.random.default_rng(d)
    lq, lk = 512, 1024
    q, g = (rng.standard_normal((lq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((lk, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    o64, lse64, dq64, dk64, dv64 = _truth(q, k, v, g, scale, lk)
    delta = (g.astype(np.float64) * o64).sum(axis=1).astype(np.float32)
    qs, ks, vs, gs = _split(q), _split(k), _split(v), _split(g)
    tr = lambda x: (x[0].T, x[1].T)
    p = np.exp(_mm(qs, tr(ks)) * np.float32(scale) - lse64.astype(np.float32)[:, None]).astype(np.float32)
    ds = (p * (_mm(gs, tr(vs)) - delta[:, None])).astype(np.float32)
    got = {"dq": _mm(_split(ds), ks) * scale, "dk": _mm(_split(ds.T), qs) * scale, "dv": _mm(_split(p.T), gs)}
    for name, want in (("dq", dq64), ("dk", dk64), ("dv", dv64)):
        assert np.abs(got[name] - want).max() <= F32_BAR * np.abs(want).max(), name
