"""The float32 feed-forward (K2/K3, K6) and the float32 fused LN + q/k/v
(K7) on Hopper's bf16 wgmma over the two-part split, on the CPU.

Both FF functions in float32 launch ff_sm90.cu's `emox_ff_f32_sm90`: an LN
pass that writes xn's parts (without LN x's parts, in the split launch of
W1 and W2), GEMM 1 whose GEGLU epilogue writes h's parts, GEMM 2 with b2
and the residual in fp32 (split over F where its grid is small). K7 in
float32 launches ln_qkv_sm90.cu's `emox_ln_qkv_f32_sm90`: the same LN pass,
one split launch of Wq, Wk and Wv into one scratch [3 inner, 2w], one GEMM
over the split. Every float32 operand is bf16 scratch [rows, 2w], hi in
columns [0, w) and lo in [w, 2w), w the contraction padded to 64 with
zeros; every product runs as a_hi b_hi + a_hi b_lo + a_lo b_hi with fp32
accumulation.

Here `build.kernel` hands the wrappers stand-in C entries that read the
tensors at the pointers they are given, check the scratch against what the
wrapper allocated (`parts_scratch`: [rows, 2w] at the padded width; the fp32
partials of GEMM 2's split), write the parts into it as the kernels do
(zero past the true width), and compute with the kernels' arithmetic from
the scratch alone. The results are held against the plain versions and the
reference's Pallas kernels in interpret mode within the float32 bar (2e-4
of the largest output value, the bar chip_smoke.py holds the kernels to on
the card). Then: the routes by type, the launch plans at the float32
step's shapes, and numpy twins of the split arithmetic against fp64.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from emox.ops import ff as jff
from emox_torch import ops
from emox_torch.ops import build
from emox_torch.ops import ff as tff
from emox_torch.ops import ln_qkv as tln
from tests.test_torch_bridge import no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import _ff_inputs, _ff_port_args, _ff_ref_args, j, t

SMS = 132  # the H100's SMs, which decide GEMM 2's split of F
SMEM_PER_BLOCK = 232448  # bytes a block may have on the H100 (227 KB)
F32_BAR = 2e-4  # float32 against the plain version: of the largest output value


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """The writable contiguous tensor of `shape` at host address `ptr`."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


def _within_bar(got: torch.Tensor, want) -> bool:
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return got.shape == want.shape and (got.float() - want).abs().max().item() <= F32_BAR * want.abs().max().item()


def _write_parts(x: torch.Tensor, buf: torch.Tensor) -> None:
    """x [rows, d] into its parts in buf [rows, 2w]: hi = bf16(x), lo =
    bf16(x - hi), zeros past d (split.cuh's split_row)."""
    d, w = x.shape[1], buf.shape[1] // 2
    hi = x.float().to(torch.bfloat16)
    buf.zero_()
    buf[:, :d] = hi
    buf[:, w:w + d] = (x.float() - hi.float()).to(torch.bfloat16)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 2w] and b [N, 2w], both parts: a b^T = a_hi b_hi + a_hi b_lo +
    a_lo b_hi in fp32, over the whole padded width."""
    w = a.shape[1] // 2
    ah, al, bh, bl = a[:, :w].float(), a[:, w:].float(), b[:, :w].float(), b[:, w:].float()
    return ah @ bh.T + ah @ bl.T + al @ bh.T


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 LN from two-pass statistics, not rounded (ln_rows_kernel)."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


@pytest.fixture
def entries(monkeypatch):
    """Stand-in C entries for emox_ff_f32_sm90 and emox_ln_qkv_f32_sm90 (and
    the bf16 entries, recorded only); the wrappers' scratch recorded as
    parts_scratch allocates it. Yields the calls."""
    calls, scratch = [], []

    def recording(rows, w, device):
        out = torch.empty((rows, 2 * w), dtype=torch.bfloat16, device=device)
        scratch.append(out)
        return out

    def parts(ptr: int, rows: int, d: int) -> torch.Tensor:
        """The scratch at ptr that the wrapper allocated for [rows, d]: [rows, 2w]."""
        w = -(-d // 64) * 64
        assert any(s.data_ptr() == ptr and s.shape == (rows, 2 * w) for s in scratch), (rows, d)
        return _view(ptr, (rows, 2 * w), torch.bfloat16)

    def ff_f32(x, ln_w, ln_b, w1, b1, w2, b2, xp, w1p, w2p, hp, ws, y, m, c, f, splits, eps, stream):
        assert all(p is None or p % 16 == 0 for p in (x, ln_w, ln_b, w1, b1, w2, b2, xp, w1p, w2p, hp, ws, y))
        assert c % 4 == 0 and f % 4 == 0 and splits == tff.ff_f32_sm90_plan(m, c, f, SMS)["splits"]
        f32 = torch.float32
        X, B1, B2 = _view(x, (m, c), f32), _view(b1, (2 * f,), f32), _view(b2, (c,), f32)
        A, W1p, W2p, H = parts(xp, m, c), parts(w1p, 2 * f, c), parts(w2p, c, f), parts(hp, m, f)
        # the LN pass writes xn's parts; without LN x is split with the weights
        _write_parts(_ln(X, _view(ln_w, (c,), f32), _view(ln_b, (c,), f32), eps) if ln_w is not None else X, A)
        _write_parts(_view(w1, (2 * f, c), f32), W1p)
        _write_parts(_view(w2, (c, f), f32), W2p)
        # GEMM 1: the GEGLU epilogue in fp32, h's parts (zero past F)
        s = _product(A, W1p) + B1
        _write_parts(s[:, :f] * F.gelu(s[:, f:]), H)
        # GEMM 2: each split's k-steps of 64 (both parts of them) into an fp32
        # partial, the partials added in split order, then b2 and x
        wf, steps = H.shape[1] // 2, -(-f // 64)
        per = -(-steps // splits)
        cols = lambda k0, k1: torch.cat([torch.arange(64 * k0, min(64 * k1, wf)),
                                         torch.arange(wf + 64 * k0, wf + min(64 * k1, wf))])
        partials = [_product(H[:, cols(k0, k0 + per)], W2p[:, cols(k0, k0 + per)]) for k0 in range(0, steps, per)]
        if splits > 1:
            WS = _view(ws, (splits, m, c), f32)
            for z, p in enumerate(partials):
                WS[z].copy_(p)
        else:
            assert ws is None
        acc = partials[0]
        for p in partials[1:]:
            acc = acc + p
        acc = acc + B2
        if ln_w is not None:
            acc = acc + X
        _view(y, (m, c), f32).copy_(acc)
        calls.append(dict(entry="emox_ff_f32_sm90", m=m, c=c, f=f, splits=splits, ln=ln_w is not None,
                          xp=A.clone(), hp=H.clone()))
        return 0

    def qkv_f32(x, ln_w, ln_b, wq, wk, wv, q, k, v, xp, wp, m, c, inner, eps, stream):
        assert all(p % 16 == 0 for p in (x, ln_w, ln_b, wq, wk, wv, q, k, v, xp, wp))
        assert c % 4 == 0 and inner % 4 == 0
        f32 = torch.float32
        A, Wp = parts(xp, m, c), parts(wp, 3 * inner, c)
        _write_parts(_ln(_view(x, (m, c), f32), _view(ln_w, (c,), f32), _view(ln_b, (c,), f32), eps), A)
        for o, ptr in enumerate((wq, wk, wv)):  # one split launch, the three weights one after another
            _write_parts(_view(ptr, (inner, c), f32), Wp[o * inner:(o + 1) * inner])
        for o, ptr in enumerate((q, k, v)):
            _view(ptr, (m, inner), f32).copy_(_product(A, Wp[o * inner:(o + 1) * inner]))
        calls.append(dict(entry="emox_ln_qkv_f32_sm90", m=m, c=c, inner=inner, xp=A.clone(), wp=Wp.clone()))
        return 0

    c_entries = {
        "emox_ff_f32_sm90": ff_f32, "emox_ln_qkv_f32_sm90": qkv_f32,
        "emox_ff_sm90": lambda *a: calls.append(dict(entry="emox_ff_sm90")) or 0,
        "emox_ln_qkv_sm90": lambda *a: calls.append(dict(entry="emox_ln_qkv_sm90")) or 0,
    }

    def kernel(name, fn_name=""):
        fn_name = fn_name or next(iter(build.KERNELS[name]))
        assert fn_name in build.KERNELS[name], (name, fn_name)
        entry = c_entries[fn_name]
        if entry.__code__.co_argcount:
            assert len(build.KERNELS[name][fn_name]) == entry.__code__.co_argcount
        return entry

    monkeypatch.setattr(build, "kernel", kernel)
    for mod in (tff, tln):
        monkeypatch.setattr(mod, "parts_scratch", recording)
        monkeypatch.setattr(mod, "_on_card_or_cpu", lambda name, x: True)
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
        monkeypatch.setattr(mod, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield calls
    ops.reset_launch_counts()


# M ragged against the 128-row tiles; C not a multiple of 64 (80: the
# parts padded to 128 columns) and C 1280 (GEMM 2 split over F at M 37)
SHAPES = [(37, 80), (200, 64), (37, 1280)]
IDS = [f"m{m}_c{c}" for m, c in SHAPES]


@pytest.mark.parametrize("m,c", SHAPES, ids=IDS)
def test_ln_ff_float32_on_the_split(entries, m, c):
    """fused_ln_geglu_ff in float32 (K2/K3): one emox_ff_f32_sm90 call with
    LN, xn's parts zero past C, h's zero past F, the result from the parts
    against ln_geglu_ff_plain and against the reference's K2 (C 80, 64) or
    K3 (C 1280, F blocked) in interpret mode, within the float32 bar."""
    p = _ff_inputs(m, c, seed=m + c)
    args = _ff_port_args(p)
    y = ops.fused_ln_geglu_ff(*args)
    assert _within_bar(y, tff.ln_geglu_ff_plain(*args))
    block_f = 512 if c == 1280 else 0
    want = jff.fused_ln_geglu_ff(*_ff_ref_args(p), block_m=64, block_f=block_f, interpret=True)
    assert _within_bar(y, want)
    (call,) = entries
    assert (call["entry"], call["ln"], call["splits"]) == ("emox_ff_f32_sm90", True,
                                                            tff.ff_f32_sm90_plan(m, c, 4 * c, SMS)["splits"])
    wc, wf = tff.parts_width(c), tff.parts_width(4 * c)
    assert call["xp"].shape == (m, 2 * wc) and call["hp"].shape == (m, 2 * wf)
    for buf, d, w in ((call["xp"], c, wc), (call["hp"], 4 * c, wf)):
        assert not buf[:, d:w].float().any() and not buf[:, w + d:].float().any()
    counts = ops.launch_counts()
    assert counts["ln_geglu_ff"] == counts["ff_f32_sm90"] == 1 and counts["ff_sm90"] == counts["geglu_ff"] == 0


@pytest.mark.parametrize("m,c", SHAPES, ids=IDS)
def test_geglu_ff_float32_on_the_split(entries, m, c):
    """fused_geglu_ff in float32 (K6): the same entry with no LN, x itself
    split into the A scratch, no residual; against geglu_ff_plain and the
    reference's K6 in interpret mode."""
    p = _ff_inputs(m, c, seed=3 * m + c)
    x, _, _, w1, b1, w2, b2 = _ff_port_args(p)
    y = ops.fused_geglu_ff(x, w1, b1, w2, b2)
    assert _within_bar(y, tff.geglu_ff_plain(x, w1, b1, w2, b2))
    want = jff.fused_geglu_ff(*(j(p[k]) for k in ("x", "w1", "b1", "w2", "b2")), block_m=64, interpret=True)
    assert _within_bar(y, want)
    (call,) = entries
    assert call["ln"] is False
    hi = call["xp"][:, :c]
    assert torch.equal(hi, x.to(torch.bfloat16))  # x's own parts, not a normalised x
    counts = ops.launch_counts()
    assert counts["geglu_ff"] == counts["ff_f32_sm90"] == 1 and counts["ff_sm90"] == counts["ln_geglu_ff"] == 0


QKV_SHAPES = [(37, 80, 80), (200, 64, 96), (37, 1280, 1280), (70, 1288, 160)]


@pytest.mark.parametrize("m,c,inner", QKV_SHAPES, ids=[f"m{m}_c{c}_i{i}" for m, c, i in QKV_SHAPES])
def test_ln_qkv_float32_on_the_split(entries, m, c, inner):
    """fused_ln_qkv in float32 (K7): one emox_ln_qkv_f32_sm90 call, xn's
    parts [M, 2w] and the three weights' parts one after another in one
    scratch [3 inner, 2w], zero past C; q, k, v against ln_qkv_plain and
    the reference's K7 in interpret mode. C past bf16's 1280 is taken."""
    rng = np.random.default_rng(m + c + inner)
    x = (0.5 * rng.standard_normal((m, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(c)).astype(np.float32)
    ws = [(rng.standard_normal((c, inner)) * c ** -0.5).astype(np.float32) for _ in range(3)]
    args = (t(x), t(gamma), t(beta), *(t(w.T.copy()) for w in ws))
    got = ops.fused_ln_qkv(*args)
    want_plain = tln.ln_qkv_plain(*args)
    want_ref = jff.fused_ln_qkv(j(x), j(gamma), j(beta), *(j(w) for w in ws), block_m=64, interpret=True)
    for g, wp, wr in zip(got, want_plain, want_ref):
        assert g.shape == (m, inner) and g.dtype == torch.float32
        assert _within_bar(g, wp) and _within_bar(g, wr)
    (call,) = entries
    w = tln.ln_qkv_f32_sm90_plan(m, c, inner)["width"]
    assert call["xp"].shape == (m, 2 * w) and call["wp"].shape == (3 * inner, 2 * w)
    for buf in (call["xp"], call["wp"]):
        assert not buf[:, c:w].float().any() and not buf[:, w + c:].float().any()
    counts = ops.launch_counts()
    assert (counts["ln_qkv"], counts["ln_qkv_f32_sm90"], counts["ln_qkv_sm90"]) == (1, 1, 0)


# ---- routes --------------------------------------------------------------------------------
ROUTES = [("ln_geglu_ff", "float32", "ff_f32_sm90"), ("geglu_ff", "float32", "ff_f32_sm90"),
          ("ln_geglu_ff", "bfloat16", "ff_sm90"), ("geglu_ff", "bfloat16", "ff_sm90"),
          ("ln_qkv", "float32", "ln_qkv_f32_sm90"), ("ln_qkv", "bfloat16", "ln_qkv_sm90")]


@pytest.mark.parametrize("fn,dtype,kernel", ROUTES, ids=[f"{f}-{d}" for f, d, _ in ROUTES])
def test_each_type_reaches_its_entry(entries, fn, dtype, kernel):
    """float32 reaches the split entries and counts on ff_f32_sm90 /
    ln_qkv_f32_sm90; bf16 still reaches emox_ff_sm90 / emox_ln_qkv_sm90 and
    counts on ff_sm90 / ln_qkv_sm90; each call counts once on its function
    and on no other kernel."""
    dt = getattr(torch, dtype)
    x, ln_w, ln_b, w1, b1, w2, b2 = _ff_port_args(_ff_inputs(40, 64, seed=5), dt)
    if fn == "ln_geglu_ff":
        ops.fused_ln_geglu_ff(x, ln_w, ln_b, w1, b1, w2, b2)
    elif fn == "geglu_ff":
        ops.fused_geglu_ff(x, w1, b1, w2, b2)
    else:
        ops.fused_ln_qkv(x, ln_w, ln_b, *(w1[:64 * i + 64][-64:] for i in range(3)))
    assert [c["entry"] for c in entries] == [f"emox_{kernel}"]
    counts = ops.launch_counts()
    assert {k for k, n in counts.items() if n} == {fn, kernel}
    assert counts[fn] == counts[kernel] == 1


def test_what_neither_takes_raises(entries):
    """Before any launch: float32 C or F (FF), C or inner (K7) not a multiple
    of 4 (16-byte rows), float16, unaligned rows; no fallback."""
    x, ln_w, ln_b, w1, b1, w2, b2 = _ff_port_args(_ff_inputs(16, 24, seed=6))
    with pytest.raises(ValueError, match="C % 4"):
        ops.fused_ln_geglu_ff(x[:, :22], ln_w[:22], ln_b[:22], w1[:, :22], b1, w2[:22], b2[:22])
    keep = torch.cat([torch.arange(90), torch.arange(96, 186)])  # F 90
    with pytest.raises(ValueError, match="F % 4"):
        ops.fused_geglu_ff(x, w1[keep], b1[keep], w2[:, :90], b2)
    with pytest.raises(ValueError, match="C % 4"):
        ops.fused_ln_qkv(x[:, :22], ln_w[:22], ln_b[:22], *(w1[:8, :22] for _ in range(3)))
    with pytest.raises(ValueError, match="C % 4"):  # inner 6
        ops.fused_ln_qkv(x, ln_w, ln_b, *(w1[:6] for _ in range(3)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_geglu_ff(x.half(), w1.half(), b1.half(), w2.half(), b2.half())
    unaligned = torch.zeros(16 * 24 + 2)[2:].view(16, 24)  # 8 bytes past a 16-byte boundary
    unaligned.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fused_ln_geglu_ff(unaligned, ln_w, ln_b, w1, b1, w2, b2)
    assert entries == []


# ---- launch plans ----------------------------------------------------------------------------
# the float32 step's and train step's FF and K7 sites, which chip_smoke.py
# checks on the card; and 2048 x 1280, the K7 shape the card times
STEP_SITES = [*chip_smoke.F32_STEP_SITES, (2048, 1280)]
STEP_IDS = [f"m{m}_c{c}" for m, c in STEP_SITES]


def _ring_twin(a_rows: int, b_rows: int, stages: int) -> int:
    """gemm_sm90.cuh's Ring<BN, STAGES, 2>::bytes worked out again: each
    stage both parts of a box of A rows and of B rows, 64 bf16 (128 bytes)
    deep; an 8-byte full and empty mbarrier a stage; 1024 bytes of slack
    for aligning the ring to the swizzle's 1024 bytes."""
    return stages * 2 * (a_rows * 128 + b_rows * 128) + stages * 2 * 8 + 1024


@pytest.mark.parametrize("m,c", STEP_SITES, ids=STEP_IDS)
def test_ff_f32_plan_fits_and_owns_every_output_once(m, c):
    """ff_f32_sm90_plan at the float32 step's shapes: both rings within
    227 KB (GEMM 1: 2 stages of 128 A rows and 256 value + gate rows;
    GEMM 2: 3 stages of 128 and 160), the parts' widths padded to 64, and
    every h column (to its padded width) and every y element owned by
    exactly one block of its grid (GEMM 2: one per split)."""
    f = 4 * c
    plan = tff.ff_f32_sm90_plan(m, c, f, SMS)
    assert plan["gemm1_smem"] == _ring_twin(128, 256, 2) <= SMEM_PER_BLOCK
    assert plan["gemm2_smem"] == _ring_twin(128, 160, 3) <= SMEM_PER_BLOCK
    assert (plan["width_c"], plan["width_f"]) == (-(-c // 64) * 64, -(-f // 64) * 64)
    rows = -(-m // 128)
    h = np.zeros((m, plan["width_f"]), np.int32)  # GEMM 1: (F / 128) x (M / 128) blocks
    for bx in range(-(-f // 128)):
        for by in range(rows):
            h[128 * by:128 * by + 128, 128 * bx:128 * bx + 128] += 1
    assert (h == 1).all() and plan["gemm1_blocks"] == -(-f // 128) * rows
    splits, steps = plan["splits"], -(-f // 64)
    per = -(-steps // splits)
    y = np.zeros((m, c), np.int32)  # GEMM 2: (C / 160) x (M / 128) x splits
    for bx in range(-(-c // 160)):
        for by in range(rows):
            y[128 * by:128 * by + 128, 160 * bx:160 * bx + 160] += 1
    assert (y == 1).all() and -(-steps // per) == splits
    assert plan["gemm2_blocks"] == -(-c // 160) * rows * splits


@pytest.mark.parametrize("m,c", STEP_SITES, ids=STEP_IDS)
def test_ln_qkv_f32_plan_fits_and_owns_every_output_once(m, c):
    """ln_qkv_f32_sm90_plan at the same shapes (inner = C): the ring of 3
    stages of 128 x-part rows and 160 weight-part rows within 227 KB, and
    every element of q, k and v owned by exactly one block, each column
    tile inside one output."""
    plan = tln.ln_qkv_f32_sm90_plan(m, c, c)
    assert plan["smem_bytes"] == _ring_twin(128, 160, 3) <= SMEM_PER_BLOCK
    tiles = -(-c // 160)
    assert plan["col_tiles"] == 3 * tiles and plan["blocks"] == 3 * tiles * -(-m // 128)
    owned = np.zeros((3, m, c), np.int32)
    for bx in range(plan["col_tiles"]):
        o, n0 = bx // tiles, (bx % tiles) * 160
        for by in range(-(-m // 128)):
            owned[o, 128 * by:128 * by + 128, n0:n0 + 160] += 1
    assert (owned == 1).all()


# ---- numpy twins of the split arithmetic against fp64 -------------------------------------
def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _split(x: np.ndarray):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm(a, b):
    """(a_hi, a_lo) (b_hi, b_lo)^T as the kernels sum it, fp32."""
    f = lambda x, y: x.astype(np.float32) @ y.astype(np.float32).T
    return f(a[0], b[0]) + f(a[0], b[1]) + f(a[1], b[0])


def _gelu64(g: np.ndarray) -> np.ndarray:
    return 0.5 * g * (1 + torch.special.erf(torch.from_numpy(g / math.sqrt(2))).numpy())


@pytest.mark.parametrize("ln", [True, False], ids=["K2K3", "K6"])
@pytest.mark.parametrize("c", [320, 1280])
def test_split_ff_twin_meets_the_float32_bar(c, ln):
    """The float32 FF's arithmetic (xn or x, W1 and W2 split in scratch; GEMM
    1 as three products; the GEGLU epilogue in fp32; h split; GEMM 2 as
    three products; b2 and x in fp32) at M 256 against fp64: within 2e-4 of
    the largest output."""
    rng = np.random.default_rng(c + ln)
    m, f = 256, 4 * c
    x = (rng.standard_normal((m, c)) * 2 + 0.5).astype(np.float32)
    lw, lb = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32), (0.1 * rng.standard_normal(c)).astype(np.float32)
    w1 = (rng.standard_normal((2 * f, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(2 * f)).astype(np.float32)
    w2 = (rng.standard_normal((c, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)

    def ln64(v):
        mu = v.mean(-1, keepdims=True)
        return (v - mu) / np.sqrt(((v - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * lw + lb

    x64 = x.astype(np.float64)
    a64 = ln64(x64) if ln else x64
    s64 = a64 @ w1.T.astype(np.float64) + b1
    want = (s64[:, :f] * _gelu64(s64[:, f:])) @ w2.T.astype(np.float64) + b2 + (x64 if ln else 0)

    a = ln64(x).astype(np.float32) if ln else x
    s = _mm(_split(a), _split(w1)) + b1
    h = (s[:, :f] * F.gelu(torch.from_numpy(s[:, f:])).numpy()).astype(np.float32)
    y = _mm(_split(h), _split(w2)) + b2 + (x if ln else 0)
    assert np.abs(y - want).max() <= F32_BAR * np.abs(want).max()


@pytest.mark.parametrize("c", [320, 1280])
def test_split_ln_qkv_twin_meets_the_float32_bar(c):
    """K7's float32 arithmetic (xn from fp32 statistics, split; the weights
    split; one product of three) at M 256 against fp64: each of q, k, v
    within 2e-4 of its largest value."""
    rng = np.random.default_rng(c)
    m = 256
    x = (0.5 * rng.standard_normal((m, c))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(c)).astype(np.float32)
    ws = [(rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32) for _ in range(3)]
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    xn64 = (x64 - mu) / np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * gamma + beta
    xs = _split(xn64.astype(np.float32))
    for w in ws:
        got, want = _mm(xs, _split(w)), xn64 @ w.T.astype(np.float64)
        assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max()

