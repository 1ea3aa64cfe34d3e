"""The card path of the fused LN + q/k/v (K7), on the CPU.

In bf16 `fused_ln_qkv` launches `emox_ln_qkv_sm90` (emox_torch/csrc/ln_qkv_sm90.cu:
LN in the prologue of one wgmma + TMA GEMM), in float32 the same file's
`emox_ln_qkv_f32_sm90` (an LN + split pass, then a GEMM on the two-part
split; in detail in tests/test_torch_ff_f32_sm90.py). Here `build.kernel` hands the wrapper stand-in
C entries that read the tensors at the pointers they are given and check
what the kernels require (16-byte aligned pointers, C % 8 and C <= 1280 in
bf16, the wrapper's column tiles per block). The bf16 stand-in computes as
the kernel does: each row tile laid out as TMA writes it (64-column chunks,
128-byte swizzle), normalised in place through `sw128_channel` (the Python
twin of the kernel's `unit_channel`), read back and multiplied in fp32,
each output rounded once. Results are held against ln_qkv_plain (bf16: two
bf16 steps relative L2; float32 1e-5).

Also: the swizzle mapping itself against an unswizzled layout, the quad
transpose of the kernel's epilogue, and the plan (tiles, shared memory,
column tiles per block) at the flagship's K7 sites.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from emox_torch import ops
from emox_torch.ops import build
from emox_torch.ops import ln_qkv as tln
from tests.test_torch_bridge import no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, rel

SMS = 132
SMEM_MAX = 232448  # the 227 KB of shared memory a block may use


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


def _swizzled_offset(row: int, col: int) -> int:
    """Byte offset of element (row, col % 64) in its 64-column chunk as TMA
    writes it with the 128-byte swizzle: address bits 4-6 XOR bits 7-9."""
    off = row * 128 + (col % 64) * 2
    return off ^ (((off >> 7) & 7) << 4)


def _to_tile(x: np.ndarray, chunks: int) -> np.ndarray:
    """x [rows, C] (uint16 bf16 bits) as the kernel's x tile: chunks x rows
    x 128 bytes, columns past C zero (TMA's fill)."""
    rows, c = x.shape
    tile = np.zeros((chunks, rows * 128), np.uint8)
    raw = x.view(np.uint8).reshape(rows, c, 2)
    for r in range(rows):
        for col in range(c):
            off = _swizzled_offset(r, col)
            tile[col // 64, off:off + 2] = raw[r, col]
    return tile


def _from_tile(tile: np.ndarray, rows: int, c: int) -> np.ndarray:
    out = np.zeros((rows, c, 2), np.uint8)
    for r in range(rows):
        for col in range(c):
            off = _swizzled_offset(r, col)
            out[r, col] = tile[col // 64, off:off + 2]
    return out.reshape(rows, c * 2).view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def _layer_norm_tile(tile: np.ndarray, rows: int, c: int, w: torch.Tensor, b: torch.Tensor, eps: float) -> None:
    """The kernel's LN prologue on a swizzled tile, in place: per row the
    16-byte units by physical position, each unit's channels from
    sw128_channel; fp32 mean, then mean of squared deviations; xn rounded to
    bf16 over x; units past C zero."""
    chunks = tile.shape[0]
    for r in range(rows):
        units = []
        for k in range(chunks):
            for p in range(8):
                ch = tln.sw128_channel(k, r, p)
                at = r * 128 + p * 16
                vals = _bf16(tile[k, at:at + 16].view(np.uint16)).float() if ch < c else None
                units.append((k, at, ch, vals))
        xs = torch.cat([v for *_, v in units if v is not None])
        mu = xs.sum() / c
        rstd = torch.rsqrt(((xs - mu) ** 2).sum() / c + eps)
        for k, at, ch, vals in units:
            out = torch.zeros(8, dtype=torch.bfloat16)
            if vals is not None:
                out = ((vals - mu) * rstd * w[ch:ch + 8].float() + b[ch:ch + 8].float()).to(torch.bfloat16)
            tile[k, at:at + 16] = out.view(torch.int16).numpy().view(np.uint8)


@pytest.mark.parametrize("chunks", [1, 3, 5])
def test_swizzled_unit_holds_the_channels_sw128_channel_names(chunks):
    """Every 16-byte unit of the swizzled tile holds 8 consecutive channels
    of its row, the first of them sw128_channel(chunk, row, unit)."""
    rows, c = 24, 64 * chunks
    x = np.arange(rows * c, dtype=np.uint16).reshape(rows, c)  # element (r, ch) holds r * c + ch
    tile = _to_tile(x, chunks)
    for k in range(chunks):
        for r in range(rows):
            for p in range(8):
                got = tile[k, r * 128 + p * 16:r * 128 + p * 16 + 16].view(np.uint16)
                ch = tln.sw128_channel(k, r, p)
                np.testing.assert_array_equal(got, x[r, ch:ch + 8])


@pytest.mark.parametrize("c", [64, 200, 320])
def test_layer_norm_on_the_swizzled_tile(c):
    """LN computed in place on the swizzled tile, unit by unit as the
    kernel finds them, equals the plain LN rounded to bf16 (1 bf16 step:
    fp32 sums in another order), with zeros past C."""
    rng = np.random.default_rng(c)
    rows, chunks = 16, -(-c // 64)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32) * 2 + 0.5).bfloat16()
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(c).astype(np.float32)).bfloat16()
    b = torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32)).bfloat16()
    tile = _to_tile(x.view(torch.int16).numpy().view(np.uint16), chunks)
    _layer_norm_tile(tile, rows, c, w, b, 1e-5)
    got = _bf16(_from_tile(tile, rows, c)).float()
    want = tln._normalise(x, w, b, 1e-5).float()
    assert (got - want).abs().max().item() <= 2.0 ** -7 * want.abs().max().item()
    pad = _from_tile(tile, rows, chunks * 64)[:, c:]
    assert not pad.any()


def _quad_transpose(words, q: int):
    """The epilogue's quad_transpose for lane q, as the device code runs it:
    words[lane][i] is lane's column pair (lane % 4) of 8-column group i. In
    round s every lane L sends its words[L][L ^ s] to lane L ^ s (the xor
    shuffle), so lane q gets out[s] = words[q ^ s][q]; then the selects."""
    out = [words[q ^ s][(q ^ s) ^ s] for s in range(4)]
    x = out[q]
    y = out[{1: 0, 0: 1, 3: 2, 2: 3}[q]]
    z = out[{2: 0, 3: 1, 0: 2, 1: 3}[q]]
    w = out[{3: 0, 2: 1, 1: 2, 0: 3}[q]]
    return [x, y, z, w]


def test_quad_transpose_gives_each_lane_one_whole_group():
    """After the swap lane q holds group q's 4 column pairs, in order: one
    16-byte store of 8 consecutive columns."""
    words = [[(group, lane) for group in range(4)] for lane in range(4)]  # lane's pair of each group
    for q in range(4):
        assert _quad_transpose(words, q) == [(q, pair) for pair in range(4)]


@pytest.fixture
def card(monkeypatch):
    """fused_ln_qkv's card path on CPU tensors: stand-in C entries for
    ln_qkv_sm90.cu's bf16 and float32 entries that record each call."""
    calls = []

    def sm90(x, ln_w, ln_b, wq, wk, wv, q, k, v, m, c, inner, per, eps, stream):
        assert all(p % 16 == 0 for p in (x, ln_w, ln_b, wq, wk, wv, q, k, v))
        assert c % 8 == 0 and c <= 1280 and inner % 8 == 0
        plan = tln.ln_qkv_sm90_plan(m, c, inner, SMS)
        assert per == plan["per"] and plan["col_tiles"] % per == 0 and plan["smem_bytes"] <= SMEM_MAX
        bf16 = torch.bfloat16
        X = _view(x, (m, c), bf16)
        W, B = _view(ln_w, (c,), bf16), _view(ln_b, (c,), bf16)
        chunks, bm = -(-c // 64), plan["bm"]
        xn = torch.empty_like(X)
        for r0 in range(0, m, bm):  # one row tile at a time, as a block holds it
            rows = min(bm, m - r0)
            tile = _to_tile(X[r0:r0 + rows].view(torch.int16).numpy().view(np.uint16), chunks)
            _layer_norm_tile(tile, rows, c, W, B, eps)
            xn[r0:r0 + rows] = _bf16(_from_tile(tile, rows, c))
        for wp, op in ((wq, q), (wk, k), (wv, v)):
            _view(op, (m, inner), bf16).copy_((xn.float() @ _view(wp, (inner, c), bf16).float().T).to(bf16))
        calls.append(dict(entry="emox_ln_qkv_sm90", m=m, c=c, inner=inner, per=per))
        return 0

    def f32(x, ln_w, ln_b, wq, wk, wv, q, k, v, xp, wp, m, c, inner, eps, stream):
        assert all(p % 16 == 0 for p in (x, ln_w, ln_b, wq, wk, wv, q, k, v, xp, wp))
        assert c % 4 == 0 and inner % 4 == 0
        f32 = torch.float32
        args = [_view(x, (m, c), f32), _view(ln_w, (c,), f32), _view(ln_b, (c,), f32),
                *(_view(p, (inner, c), f32) for p in (wq, wk, wv))]
        for out, want in zip((q, k, v), tln.ln_qkv_plain(*args, eps=eps)):
            _view(out, (m, inner), f32).copy_(want)
        calls.append(dict(entry="emox_ln_qkv_f32_sm90", m=m, c=c, inner=inner))
        return 0

    entries = {"emox_ln_qkv_sm90": sm90, "emox_ln_qkv_f32_sm90": f32}
    monkeypatch.setattr(build, "kernel", lambda name, fn_name="": entries[fn_name or f"emox_{name}"])
    monkeypatch.setattr(tln, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tln, "_stream", lambda x: 0)
    monkeypatch.setattr(tln, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield calls
    ops.reset_launch_counts()


def _inputs(m, c, inner, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: torch.from_numpy(
        (rng.standard_normal(s) * scale + shift).astype(np.float32)).to(dtype)
    return (f(m, c), f(c, scale=0.1, shift=1.0), f(c, scale=0.1), *(f(inner, c, scale=c ** -0.5) for _ in range(3)))


# M below one row tile and ragged; C past a 64-column chunk; inner != C; each tile config
SM90_SHAPES = [(37, 64, 64), (130, 200, 160), (70, 328, 96), (40, 1280, 64)]


@pytest.mark.parametrize("m,c,inner", SM90_SHAPES, ids=[f"m{m}_c{c}_i{i}" for m, c, i in SM90_SHAPES])
def test_bf16_reaches_ln_qkv_sm90(card, m, c, inner):
    """bf16 goes to ln_qkv_sm90 with the plan's column tiles per block, once
    per call, and its outputs (LN on the swizzled tile) match the plain
    version; the counters count the call and the kernel."""
    args = _inputs(m, c, inner, torch.bfloat16, seed=m)
    got = ops.fused_ln_qkv(*args)
    want = tln.ln_qkv_plain(*args)
    assert [d["entry"] for d in card] == ["emox_ln_qkv_sm90"]
    for g, w in zip(got, want):
        assert g.shape == (m, inner) and rel(g.float(), w.float().numpy()) <= BF16_TOL
    assert (ops.fused_ln_qkv.launches, tln.ln_qkv_sm90.launches, tln.ln_qkv_f32_sm90.launches) == (1, 1, 0)


def test_float32_reaches_ln_qkv_f32_sm90(card):
    args = _inputs(50, 64, 32, torch.float32)
    got = ops.fused_ln_qkv(*args)
    assert [d["entry"] for d in card] == ["emox_ln_qkv_f32_sm90"]
    for g, w in zip(got, tln.ln_qkv_plain(*args)):
        assert rel(g, w.numpy()) <= FP32_TOL
    assert (ops.fused_ln_qkv.launches, tln.ln_qkv_sm90.launches, tln.ln_qkv_f32_sm90.launches) == (1, 0, 1)


def test_what_neither_kernel_takes_raises(card):
    """C or inner not a multiple of 8 (bf16) or 4 (float32), bf16 C past
    1280 and unaligned rows raise before any launch: no fallback."""
    with pytest.raises(ValueError, match="C % 8"):
        ops.fused_ln_qkv(*_inputs(8, 36, 32, torch.bfloat16))
    with pytest.raises(ValueError, match="C % 8"):
        ops.fused_ln_qkv(*_inputs(8, 64, 36, torch.bfloat16))
    with pytest.raises(ValueError, match="C <= 1280"):
        ops.fused_ln_qkv(*_inputs(8, 1288, 64, torch.bfloat16))
    with pytest.raises(ValueError, match="C % 4"):
        ops.fused_ln_qkv(*_inputs(8, 42, 32, torch.float32))
    _, *weights = _inputs(8, 64, 64, torch.bfloat16)
    unaligned = torch.zeros(8 * 64 + 4, dtype=torch.bfloat16)[4:].view(8, 64)  # 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fused_ln_qkv(unaligned, *weights)
    assert card == []


# the flagship's K7 sites under CFG at 16 frames, 256^2 and 512^2: (M, C)
SITES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280), (131072, 320), (32768, 640), (8192, 1280),
         (2048, 1280)]


@pytest.mark.parametrize("m,c", SITES, ids=[f"m{m}_c{c}" for m, c in SITES])
def test_plan_at_the_flagship_sites(m, c):
    """The tile fits shared memory; each column tile lies in one of q, k,
    v; `per` divides the column tiles; the grid gives 7 in 8 SMs a block,
    or each block takes one column tile."""
    plan = tln.ln_qkv_sm90_plan(m, c, c, SMS)
    assert plan["smem_bytes"] <= SMEM_MAX
    assert plan["col_tiles"] == 3 * -(-c // plan["bn"]) and plan["col_tiles"] % plan["per"] == 0
    assert plan["blocks"] == -(-m // plan["bm"]) * plan["col_tiles"] // plan["per"]
    assert 8 * plan["blocks"] >= 7 * SMS or plan["per"] == 1
    assert c % plan["bn"] == 0  # no column tile runs past its output at the flagship's widths
