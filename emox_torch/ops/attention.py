"""Attention for the port: the flash-attention kernels, their plain versions
and the dispatcher.

Counterpart of emox/ops/attention.py. Two layouts, as in the reference:

  * packed tokens [N, L, H*D]: `flash_attention_nlc` (TPU `_flash_nlc_kernel`
    forward, `_flash_bwd_nlc_dq_kernel` / `_flash_bwd_nlc_dkv_kernel`
    backward), with lse [N, Lq, H];
  * [B, H, L, D] operands with any strides: `flash_attention` (TPU
    `_flash_kernel`, `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`), with
    lse [B, H, Lq]; head-split views of packed tokens reach it with no copy.

Both are autograd functions whose forward saves (q, k, v, out, lse) and whose
backward recomputes from them. On a CUDA tensor each wrapper launches a
kernel, or raises for an input no kernel takes; there is no fallback. Every
kernel is wgmma + TMA (sm_90a) and serves both layouts (packed tokens as
head-split views); float32 runs on bf16 products of a two-part split of
each operand (hi + lo, three products for each) unless named:

  * forward, bfloat16, head dim <= 256 and 512 (the VAE's single-head
    mid-attention): `flash_fwd_sm90` (emox_torch/csrc/flash_fwd_sm90.cu);
  * forward, float32, head dim <= 256: `flash_fwd_f32_sm90` (the same
    source, its kernels on the split);
  * forward, float32, head dim 512: `flash_fwd_d512_f32`
    (emox_torch/csrc/flash_fwd_d512_f32.cu, the head dim split over a
    cluster of two blocks);
  * backward, bfloat16, head dim <= 128: `flash_bwd_sm90`
    (emox_torch/csrc/flash_bwd_sm90.cu); float32 at <= 128:
    `flash_bwd_f32_sm90` (the same source on the split);
  * backward, head dims 129-256, both types: `flash_bwd_d256_sm90`
    (emox_torch/csrc/flash_bwd_d512_sm90.cu at half its width: a cluster of
    two blocks of 128 columns);
  * backward, head dim 512 (the VAE's mid-attention, which VAE pretraining,
    stage 5, differentiates): `flash_bwd_d512_sm90` in bfloat16 (the head
    dim split over a cluster of two blocks) and `flash_bwd_d512_f32` in
    float32 (the same source's kernels on the split, the head dim split
    over a cluster of four blocks of 128 columns);
  * head dims above 512, both types, forward and backward: `flash_fwd_wide`
    and `flash_bwd_wide` (emox_torch/csrc/flash_fwd_wide.cu and
    flash_bwd_wide_sm90.cu: column slices of the outputs; the forward up to
    2240 (bfloat16) / 1152 (float32), the backward up to 2048 / 1536, on a
    cluster of one block a slice that computes S (and dP) once, exchanging
    the slices' partials; wider heads a block a 128-column slice with S and
    dP over the whole head dim in every block, flash_fwd_wide.cu's and
    flash_attn_wide.cu's slice kernels).

Rows that are not 16-byte aligned (a head dim that is not a multiple of 8 in
bfloat16, of 4 in float32) are zero-padded in the head dim before the launch
(`padded_attention`), the reference's `_pad_dim`; so are head dims 257-511,
to 512, which then run on the head-dim-512 kernels. Exact, since zero columns
add nothing to q k^T, P v or any gradient product, and the scale comes from
the true head dim. On a CPU tensor each wrapper runs the kernels' plain
versions (`attention_nlc_plain`, `attention_plain` and their backwards), the
same functions in plain PyTorch with fp32 math, which the CPU tests hold
against the reference.

`dot_product_attention_nlc`, the entry point of the nn modules, and
`dot_product_attention` take the reference's impl names, from `impl` or else
`attention_default_impl()` (EMOX_ATTENTION_IMPL, else "auto" with a CUDA
card and "xla" without one):

  * "auto": a kernel where Lk >= KERNEL_MIN_KV, plain PyTorch elsewhere;
  * "pallas": a kernel at every Lk (on CPU tensors its plain version);
  * "pallas_interpret": the kernels' plain versions on any device;
  * "xla": `attention_xla`, plain PyTorch;
  * anything else raises ValueError.
A kernel route takes the packed kernel for head_dim % 64 == 0 and the strided
one on head-split views otherwise, as the reference routes. No site calls a
library attention.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from emox_torch.ops import build

# K/V length from which "auto" takes a kernel. The reference's cutoff
# (_PALLAS_MIN_KV), measured on a TPU v5e; kept here so the port runs its
# kernel at the same sites, and to be measured again on the H100
# (ROADMAP.md, Queue 2).
KERNEL_MIN_KV = 2048
ATTENTION_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")
_MAX_HEAD_DIM = 256  # the kernels for head dims up to this one
_D512 = 512  # forward flash_fwd_sm90.cu (bf16), flash_fwd_d512_f32.cu; backward flash_bwd_d512_sm90.cu
# (both types); head dims 257-511 are padded to it; above it the wide kernels
_SM90_BWD_HEAD_DIM = 128  # flash_bwd_sm90.cu: the backward up to this head dim
_SM90_BWD_ROWS = 128  # flash_bwd_sm90 takes lse and delta padded to a multiple of these rows
_D512_BWD_ROWS = 64  # the pair (d 129-512) and wide backward kernels take lse and delta padded to these rows
_WIDE_SLICE = 128  # wide.cuh: the head-dim columns a block of the slice kernels owns
_MAX_CLUSTER = 8  # the portable cluster size: flash_fwd_wide.cu's cluster forward takes up to 8 blocks
_SMEM_PER_BLOCK = 232448  # the shared memory a block may have on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, which the launch plans size their grids by."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_default_impl() -> str:
    """EMOX_ATTENTION_IMPL if set, else "auto" on a machine with a CUDA card
    and "xla" without one, as the reference's `_default_impl` resolves by
    platform (TPU or not)."""
    return os.environ.get("EMOX_ATTENTION_IMPL") or ("auto" if torch.cuda.is_available() else "xla")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention on [B, H, L, D] (the reference's attention_xla):
    fp32 scores and softmax, P rounded to v's type, fp32 accumulation."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    n, l, c = t.shape
    return t.reshape(n, l, heads, c // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N, H, L, D] -> [N, L, H*D] in like's type."""
    return t.transpose(1, 2).reshape(like.shape).to(like.dtype)


def attention_nlc_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: q [N, Lq, H*D], k/v
    [N, Lk, H*D] -> (out [N, Lq, H*D] in q's type, lse [N, Lq, H] fp32).
    Everything between the inputs and the rounded output is fp32, as in
    the TPU kernel."""
    qh, kh, vh = (_split_heads(t, heads).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # [N, H, Lq, Lk]
    lse = torch.logsumexp(s, dim=-1)  # [N, H, Lq]
    out = torch.matmul(torch.exp(s - lse[..., None]), vh)
    return _merge_heads(out, q), lse.transpose(1, 2).contiguous()


def attention_nlc_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, heads: int,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of
    attention on the packed layout, from the forward's output o and lse
    [N, Lq, H] and the output gradient dout, by recomputing
    P = exp(q k^T * scale - lse). fp32 math; each gradient rounded to its
    input's type."""
    qh, kh, vh, oh, gh = (_split_heads(t, heads).float() for t in (q, k, v, o, dout))
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse.transpose(1, 2)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gh)
    delta = (gh * oh).sum(dim=-1, keepdim=True)  # [N, H, Lq, 1]
    ds = p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return _merge_heads(dq, q), _merge_heads(dk, k), _merge_heads(dv, v)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strided forward kernel's function in plain PyTorch: q [B, H, Lq, D],
    k/v [B, H, Lk, D] -> (out [B, H, Lq, D] in q's type, lse [B, H, Lq] fp32).
    Everything between the inputs and the rounded output is fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The strided backward kernels' function in plain PyTorch: (dq, dk, dv)
    on [B, H, L, D] from the forward's output o, its lse [B, H, Lq] and the
    output gradient, by recomputing P = exp(q k^T * scale - lse). fp32 math;
    each gradient rounded to its input's type."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---- head-dim padding ----------------------------------------------------------------
def pad_head_dim(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """t [..., D] with zero columns appended up to a multiple of `multiple`;
    t itself when D already is one."""
    d = t.shape[-1]
    return t if d % multiple == 0 else F.pad(t, (0, -d % multiple))


def padded_attention(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, multiple: int):
    """fn, a forward (q, k, v, scale) -> (out, lse) on [B, H, L, D], run on q,
    k and v zero-padded in the head dim to a multiple of `multiple`, with out
    cut back to D columns: the reference's `_pad_dim`. Exact, since zero
    columns add nothing to q k^T or P v; `scale` is the caller's, from the
    true head dim."""
    out, lse = fn(*(pad_head_dim(t, multiple) for t in (q, k, v)), scale)
    return out[..., :q.shape[-1]], lse


def _row_multiple(t: torch.Tensor) -> int:
    """Head-dim multiple that keeps rows of t's type 16-byte aligned."""
    return 16 // t.element_size()


def _on_card_or_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """The kernels read whole rows in 16-byte vectors (TMA boxes in
    flash_fwd_sm90): the head dim contiguous and every row 16-byte aligned
    (base pointer and batch, head and row strides)."""
    size = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(s * size % 16 for s in t.stride()[:3])


def _check_rows(name: str, **tensors) -> None:
    for key, t in tensors.items():
        if not _rows_aligned(t):
            raise ValueError(f"{name}: {key} needs a contiguous head dim and 16-byte aligned rows, "
                             f"got strides {t.stride()} at offset {t.data_ptr() % 16} of 16 bytes")


def _stride_array(tensors: Sequence[torch.Tensor]):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- the kernel launchers: [B, H, L, D] operands, checked by their callers ---------------
def flash_fwd_sm90(q, k, v, out, lse, scale: float) -> None:
    """Launch flash_fwd_sm90.cu: bf16 q, k, v [B, H, L, D] with 16-byte aligned
    rows and D <= 256, D % 8 == 0, or D 512, into out (like q) and lse [B, H, Lq] fp32,
    each with any strides (the packed layout's lse is the transpose of a
    [B, Lq, H] tensor)."""
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = build.kernel("flash_fwd_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out, lse)), b, h, lq, k.shape[2], d, float(scale), _stream(q),
        )
    build.check(err, "flash_fwd_sm90")
    flash_fwd_sm90.launches += 1


flash_fwd_sm90.launches = 0  # kernel launches since the last reset


def split_width(d: int) -> int:
    """The width w of each bf16 part of a float32 operand's split (scratch
    rows of 2w: hi | lo, zero past d) that flash_fwd_sm90.cu and
    flash_bwd_sm90.cu take at head dim d <= 256: 64, 128 or 256."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def _split_scratch(w: int, *tensors):
    """bf16 scratch [B, H, L, 2w] for the parts of each [B, H, L, d] tensor."""
    return [torch.empty((*t.shape[:3], 2 * w), dtype=torch.bfloat16, device=t.device) for t in tensors]


def flash_fwd_f32_sm90(q, k, v, out, lse, scale: float) -> None:
    """Launch flash_fwd_sm90.cu's float32 forward: q, k, v [B, H, L, D] with
    16-byte aligned rows, D <= 256 and a multiple of 4, into out (like q) and
    lse [B, H, Lq] fp32, each with any strides. The call splits q, k and v
    into bf16 scratch it is handed ([B, H, L, 2w], split_width) first."""
    b, h, lq, d = q.shape
    if q.dtype != torch.float32 or d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd_f32_sm90 takes float32 head dims <= 256, got {tuple(q.shape)} {q.dtype}")
    parts = _split_scratch(split_width(d), q, k, v)
    with torch.cuda.device(q.device):
        err = build.kernel("flash_fwd_sm90", "emox_flash_fwd_f32_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out, lse)), b, h, lq, k.shape[2], d, float(scale),
            *(t.data_ptr() for t in parts), _stream(q),
        )
    build.check(err, "flash_fwd_f32_sm90")
    flash_fwd_f32_sm90.launches += 1


flash_fwd_f32_sm90.launches = 0  # kernel launches since the last reset


def flash_fwd_wide(q, k, v, out, lse, scale: float) -> None:
    """Launch flash_fwd_wide.cu: q, k, v [B, H, L, D] with D > 512
    and 16-byte aligned rows, bf16 or float32, into out (like q) and lse
    [B, H, Lq] fp32, each with any strides, on wide_plan's "fwd": the
    kernel takes the plan (and only checks it). Float32 is split first
    into scratch of [B, H, L, 2w] bf16, w the columns its blocks cover
    (the plan's "width")."""
    b, h, lq, d = q.shape
    if d <= _D512:
        raise ValueError(f"flash_fwd_wide takes head dims above 512, got {d}")
    f32 = q.dtype == torch.float32
    fwd = card_wide_plan(b, h, lq, k.shape[2], d, q.dtype, q.device.index or 0)["fwd"]
    parts = _split_scratch(fwd["width"], q, k, v) if f32 else [None] * 3
    with torch.cuda.device(q.device):
        err = build.kernel("flash_fwd_wide", "emox_flash_fwd_wide")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out, lse)), b, h, lq, k.shape[2], d, float(scale), _DTYPES[q.dtype],
            *cluster_fwd_args(fwd), *(_ptr(t) for t in parts), _stream(q),
        )
    build.check(err, "flash_fwd_wide")
    flash_fwd_wide.launches += 1


flash_fwd_wide.launches = 0  # kernel launches since the last reset


def flash_fwd_d512_f32(q, k, v, out, lse, scale: float) -> None:
    """Launch flash_fwd_d512_f32.cu: float32 q, k, v [B, H, L, 512] with
    16-byte aligned rows, into out (like q) and lse [B, H, Lq] fp32, each
    with any strides. The call splits q, k and v into bf16 parts in scratch
    it is handed ([B, H, L, 1024], hi | lo) before the attention kernel."""
    b, h, lq, d = q.shape
    if d != _D512 or q.dtype != torch.float32:
        raise ValueError(f"flash_fwd_d512_f32 takes float32 head dim 512, got {tuple(q.shape)} {q.dtype}")
    parts = _split_scratch(_D512, q, k, v)
    with torch.cuda.device(q.device):
        err = build.kernel("flash_fwd_d512_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out, lse)), b, h, lq, k.shape[2], float(scale),
            *(t.data_ptr() for t in parts), _stream(q),
        )
    build.check(err, "flash_fwd_d512_f32")
    flash_fwd_d512_f32.launches += 1


flash_fwd_d512_f32.launches = 0  # kernel launches since the last reset


def _head_dim_multiple(t: torch.Tensor) -> int:
    """The head-dim multiple a kernel route pads t's head dim to: 512 at
    257-511 (the d-512 kernels), else the multiple that keeps rows of t's
    type 16-byte aligned."""
    return _D512 if _MAX_HEAD_DIM < t.shape[-1] < _D512 else _row_multiple(t)


def _fwd_views(q, k, v, scale: float, packed_lse: bool):
    """The forward kernel for [B, H, L, D] operands: D > 512 ->
    flash_fwd_wide; bf16 -> flash_fwd_sm90; float32 -> flash_fwd_f32_sm90
    (D <= 256) or flash_fwd_d512_f32 (D 512), after zero-padding the head
    dim where rows are not 16-byte aligned or D is 257-511. flash_fwd_wide
    routes by shape inside its C entry (wide_plan's "fwd"): D up to 2240 in
    bfloat16 and 1152 in float32 on its cluster kernel (S issued once), wider
    on its slice kernel, since a cluster of at most 8 blocks cannot hold the
    slices' S partials beside their operands there.
    Returns out (q's strides where q is dense) and lse [B, H, Lq], or with
    packed_lse a [B, Lq, H] tensor."""
    mult = _head_dim_multiple(q)
    if q.shape[-1] % mult:
        return padded_attention(lambda *a: _fwd_views(*a, packed_lse), q, k, v, scale, mult)
    out = torch.empty_like(q)
    _check_rows("flash attention forward", q=q, k=k, v=v, out=out)
    b, h, lq, d = q.shape
    lse = torch.empty((b, lq, h) if packed_lse else (b, h, lq), dtype=torch.float32, device=q.device)
    if d > _D512:
        launch = flash_fwd_wide
    elif q.dtype == torch.bfloat16:
        launch = flash_fwd_sm90
    else:
        launch = flash_fwd_d512_f32 if d == _D512 else flash_fwd_f32_sm90
    launch(q, k, v, out, lse.transpose(1, 2) if packed_lse else lse, scale)
    return out, lse


def _padded_rows(lse, delta, rows: int):
    """lse and delta [B, H, Lq] as [B, H, Lq_pad] fp32 contiguous, Lq_pad the
    next multiple of `rows`: rows past Lq get lse = +inf (P = 0) and delta = 0."""
    pad = -lse.shape[-1] % rows
    return F.pad(lse, (0, pad), value=float("inf")).contiguous(), F.pad(delta, (0, pad)).contiguous()


def _bwd_views(q, k, v, o, dout, lse, scale: float, need_dq: bool, need_dkv: bool):
    """The backward kernel for [B, H, L, D] operands (lse [B, H, Lq] fp32,
    any strides): D <= 128 -> flash_bwd_sm90 (bf16) or flash_bwd_f32_sm90,
    129-256 -> flash_bwd_d256_sm90, 512 -> flash_bwd_d512_sm90 (bf16) or
    flash_bwd_d512_f32, above 512 -> flash_bwd_wide, after zero-padding the
    head dim where rows are not 16-byte aligned or D is 257-511: padded
    columns of q, k, v and dO add nothing to any product, and those of the
    gradients are cut off."""
    # per-row delta = sum_d dO * O, [B, H, Lq] fp32: outside the kernels, as
    # the reference computes it outside its Pallas kernels
    delta = (dout.float() * o.float()).sum(dim=-1)
    d = q.shape[-1]
    mult = _head_dim_multiple(q)
    if d % mult:
        q, k, v, dout = (pad_head_dim(t, mult) for t in (q, k, v, dout))
    dq = torch.empty_like(q) if need_dq else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_dkv else (None, None)
    outs = dict(dq=dq, dk=dk, dv=dv)
    _check_rows("flash attention backward", q=q, k=k, v=v, dout=dout,
                **{n: t for n, t in outs.items() if t is not None})
    bf16, dp = q.dtype == torch.bfloat16, q.shape[-1]
    if dp <= _SM90_BWD_HEAD_DIM:
        launch, rows = (flash_bwd_sm90 if bf16 else flash_bwd_f32_sm90), _SM90_BWD_ROWS
    elif dp <= _MAX_HEAD_DIM:
        launch, rows = flash_bwd_d256_sm90, _D512_BWD_ROWS
    elif dp == _D512:
        launch, rows = (flash_bwd_d512_sm90 if bf16 else flash_bwd_d512_f32), _D512_BWD_ROWS
    else:
        launch, rows = flash_bwd_wide, _D512_BWD_ROWS
    launch(q, k, v, dout, *_padded_rows(lse, delta, rows), dq, dk, dv, scale)
    return tuple(None if g is None else g[..., :d] for g in (dq, dk, dv))


def _bwd_strides(q, k, v, dout, dq, dk, dv):
    """The element strides of the backward's operands and outputs; an output
    not asked for takes its input's strides (the kernels ignore them)."""
    return _stride_array((q, k, v, dout, q if dq is None else dq, k if dk is None else dk,
                          v if dv is None else dv))


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_bwd_sm90(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_bwd_sm90.cu: bf16 q, k, v, dout [B, H, L, D] with 16-byte
    aligned rows and D <= 128, D % 8 == 0; lse and delta [B, H, Lq_pad] fp32
    contiguous, Lq_pad a multiple of 128, padded with +inf and 0; into dq
    (None: not computed) and dk, dv (both None: not computed), each with any
    strides."""
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = build.kernel("flash_bwd_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(dq), _ptr(dk), _ptr(dv), _bwd_strides(q, k, v, dout, dq, dk, dv), b, h, lq, k.shape[2],
            lse.shape[-1], d, float(scale), _stream(q),
        )
    build.check(err, "flash_bwd_sm90")
    flash_bwd_sm90.launches += 1


flash_bwd_sm90.launches = 0  # kernel launches since the last reset


def flash_bwd_f32_sm90(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_bwd_sm90.cu's float32 pair: the layouts of flash_bwd_sm90
    in float32, D <= 128 and a multiple of 4. The call splits q, k, v and
    dout into bf16 scratch ([B, H, L, 2w], split_width) first."""
    b, h, lq, d = q.shape
    if q.dtype != torch.float32 or d > _SM90_BWD_HEAD_DIM:
        raise ValueError(f"flash_bwd_f32_sm90 takes float32 head dims <= 128, got {tuple(q.shape)} {q.dtype}")
    parts = _split_scratch(split_width(d), q, k, v, dout)
    with torch.cuda.device(q.device):
        err = build.kernel("flash_bwd_sm90", "emox_flash_bwd_f32_sm90")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(dq), _ptr(dk), _ptr(dv), _bwd_strides(q, k, v, dout, dq, dk, dv), b, h, lq, k.shape[2],
            lse.shape[-1], d, float(scale), *(t.data_ptr() for t in parts), _stream(q),
        )
    build.check(err, "flash_bwd_f32_sm90")
    flash_bwd_f32_sm90.launches += 1


flash_bwd_f32_sm90.launches = 0  # kernel launches since the last reset


def _check_lq_pad(name: str, lq: int, lse) -> None:
    if lse.shape[-1] % _D512_BWD_ROWS or not lq <= lse.shape[-1] < lq + _D512_BWD_ROWS:
        raise ValueError(f"{name} takes lse [B, H, Lq_pad], Lq_pad the next multiple of {_D512_BWD_ROWS} rows: "
                         f"got Lq {lq}, lse {tuple(lse.shape)}")


def _launch_bwd_split(library: str, fn: str, name: str, width: int, q, k, v, dout, lse, delta, dq, dk, dv,
                      scale: float, plan: tuple = ()) -> None:
    """A backward entry of both types that splits float32 operands into
    bf16 scratch of [B, H, L, 2 width] first (flash_bwd_d256_sm90,
    flash_bwd_wide); `plan`: the launch plan the entry takes, if any."""
    b, h, lq, d = q.shape
    _check_lq_pad(name, lq, lse)
    parts = _split_scratch(width, q, k, v, dout) if q.dtype == torch.float32 else [None] * 4
    with torch.cuda.device(q.device):
        err = build.kernel(library, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(dq), _ptr(dk), _ptr(dv), _bwd_strides(q, k, v, dout, dq, dk, dv), b, h, lq, k.shape[2],
            lse.shape[-1], d, float(scale), _DTYPES[q.dtype], *plan, *(_ptr(t) for t in parts), _stream(q),
        )
    build.check(err, name)


def flash_bwd_d256_sm90(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_bwd_d512_sm90.cu at half its width: q, k, v, dout
    [B, H, L, D], 128 < D <= 256, bf16 or float32, 16-byte aligned rows;
    lse and delta [B, H, Lq_pad] fp32 contiguous, Lq_pad the next multiple
    of 64, padded with +inf and 0; into dq (None: not computed) and dk, dv
    (both None: not computed), each with any strides. Float32 is split first
    into [B, H, L, 512] bf16 scratch."""
    if not _SM90_BWD_HEAD_DIM < q.shape[-1] <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_bwd_d256_sm90 takes head dims 129-256, got {q.shape[-1]}")
    _launch_bwd_split("flash_bwd_d512_sm90", "emox_flash_bwd_d256_sm90", "flash_bwd_d256_sm90", _MAX_HEAD_DIM,
                      q, k, v, dout, lse, delta, dq, dk, dv, scale)
    flash_bwd_d256_sm90.launches += 1


flash_bwd_d256_sm90.launches = 0  # kernel launches since the last reset


def flash_bwd_wide(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch the backward pair at head dims above 512: q, k, v, dout
    [B, H, L, D], D > 512, bf16 or float32, with lse and delta as
    flash_bwd_d256_sm90 takes them, on wide_plan's "dq" and "dkv": within
    the clusters' reach flash_bwd_wide_sm90.cu, which takes the plan (and
    only checks it), wider flash_attn_wide.cu's slice kernels. Float32 is
    split first into [B, H, L, 2w] bf16 scratch, w the columns the plan's
    blocks cover (its "width")."""
    b, h, lq, d = q.shape
    if d <= _D512:
        raise ValueError(f"flash_bwd_wide takes head dims above 512, got {d}")
    plan = card_wide_plan(b, h, lq, k.shape[2], d, q.dtype, q.device.index or 0)
    args = cluster_bwd_args(plan)
    library, fn = ("flash_bwd_wide_sm90", "emox_flash_bwd_wide_sm90") if args else ("flash_attn_wide",
                                                                                   "emox_flash_bwd_wide")
    _launch_bwd_split(library, fn, "flash_bwd_wide", plan["dq"]["width"], q, k, v, dout, lse, delta, dq, dk, dv,
                      scale, args)
    flash_bwd_wide.launches += 1


flash_bwd_wide.launches = 0  # kernel launches since the last reset


def _launch_bwd_d512(fn: str, name: str, q, k, v, dout, lse, delta, dq, dk, dv, scale: float, parts=()) -> None:
    """A C entry of flash_bwd_d512_sm90.cu at head dim 512; `parts`: the
    split scratch of a float32 entry."""
    b, h, lq, d = q.shape
    if d != _D512:
        raise ValueError(f"{name} takes head dim 512, got {tuple(q.shape)}")
    _check_lq_pad(name, lq, lse)
    with torch.cuda.device(q.device):
        err = build.kernel("flash_bwd_d512_sm90", fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(dq), _ptr(dk), _ptr(dv), _bwd_strides(q, k, v, dout, dq, dk, dv), b, h, lq, k.shape[2],
            lse.shape[-1], float(scale), *(t.data_ptr() for t in parts), _stream(q),
        )
    build.check(err, name)


def flash_bwd_d512_sm90(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_bwd_d512_sm90.cu (bf16, wgmma + TMA): q, k, v, dout
    [B, H, L, 512] with 16-byte aligned rows; lse and delta [B, H, Lq_pad]
    fp32 contiguous, Lq_pad the next multiple of 64, padded with +inf and 0;
    into dq (None: not computed) and dk, dv (both None: not computed), each
    with any strides."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_bwd_d512_sm90 takes bfloat16, got {q.dtype}")
    _launch_bwd_d512("emox_flash_bwd_d512_sm90", "flash_bwd_d512_sm90", q, k, v, dout, lse, delta, dq, dk, dv, scale)
    flash_bwd_d512_sm90.launches += 1


flash_bwd_d512_sm90.launches = 0  # kernel launches since the last reset


def flash_bwd_d512_f32(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_bwd_d512_sm90.cu's float32 entry (bf16 wgmma on the
    two-part split, a cluster of four blocks of 128 columns a tile), the
    layouts of flash_bwd_d512_sm90 in float32. The call splits q, k, v and
    dout into bf16 scratch ([B, H, L, 1024], hi | lo) first."""
    if q.dtype != torch.float32:
        raise TypeError(f"flash_bwd_d512_f32 takes float32, got {q.dtype}")
    _launch_bwd_d512("emox_flash_bwd_d512_f32", "flash_bwd_d512_f32", q, k, v, dout, lse, delta, dq, dk, dv, scale,
                     parts=_split_scratch(_D512, q, k, v, dout))
    flash_bwd_d512_f32.launches += 1


flash_bwd_d512_f32.launches = 0  # kernel launches since the last reset


# ---- the launch plans of the Hopper kernels -------------------------------------------
# Twins of the shared-memory layouts in the sources. flash_bwd_d512_sm90.cu
# (DqSmem, DkvSmem) and flash_fwd_d512_f32.cu (Smem): every block belongs to
# a cluster (of two, or four in the float32 d-512 backward), the rank r block
# owning head-dim columns [half r, half r + half) of the cluster's tile.
_BOX64 = 64 * 128  # bytes of one 64-row box of 64 bf16 columns
_PART = 4 * 128 * 16  # one warpgroup's [64, 32] fp32 partial of S or dP
_D512_CLUSTER = 2


def _pairs(length: int, rows: int) -> int:
    return -(-length // rows)


def _bwd_cluster_smem(half: int, parts: int, stages: int, cluster: int) -> Tuple[int, int]:
    """flash_bwd_cluster.cuh's DqSmem and DkvSmem (bytes a block, alignment
    slack included) for blocks of `half` columns of `parts` bf16 parts and
    rings of `stages` stages: cluster 2 or 4 (flash_bwd_d512_sm90.cu), or 0
    (flash_bwd_wide_sm90.cu: the plan's cluster at run time, room for three
    rounds of the exchange and the merge of two parts)."""
    boxes = parts * half // 64  # a block's boxes of one operand tile
    free2 = {2: 0, 4: 1, 0: 2}[cluster]  # the later rounds' free barriers: two a round
    merge = cluster == 0
    # Q and dO, the ring of K and V tiles, the [S, dP] slots of both warpgroups, the barriers
    dq = (2 * boxes * _BOX64 + stages * 2 * boxes * _BOX64 + 4 * _PART
          + 8 * (1 + 2 * stages + 4 + 2 * free2 + 2 * merge) + 1024)
    # K and V, the ring of 64-row Q and dO tiles with their lse and delta,
    # the S^T and dP^T slots ([64, 64] fp32 each), the barriers
    dkv = (2 * boxes * _BOX64 + stages * 2 * boxes * _BOX64 + stages * 2 * 64 * 4 + 2 * 64 * 64 * 4
           + 8 * (1 + 2 * stages + 5 + 2 * free2 + 3 * merge) + 1024)
    return dq, dkv


def bwd_d512_plan(n: int, h: int, lq: int, lk: int, half: int = 256, parts: int = 1, cluster: int = 2) -> dict:
    """flash_bwd_d512_sm90's two launches for q [n, h, lq, cluster * half]
    and k, v [n, h, lk, cluster * half]: grid (x, y, z) =
    (cluster * tiles, heads, batch), the cluster x // cluster owning `rows`
    query rows (dq) or keys (dkv), with the streamed tiles' rows, ring
    stages and shared memory a block (bytes, alignment slack included).
    half 256: head dim 512 in bf16 (parts 1); half 128: head dims 129-256
    (flash_bwd_d256_sm90), bf16 (parts 1) or float32's two bf16 parts
    (parts 2); half 128, parts 2, cluster 4: float32 head dim 512
    (flash_bwd_d512_f32: two rounds of the pair's exchange, two more
    barriers a block)."""
    dq_smem, dkv_smem = _bwd_cluster_smem(half, parts, 2, cluster)
    return {"cluster": cluster, "half": half, "parts": parts,
            "dq": {"grid": (cluster * _pairs(lq, 64), h, n), "rows": 64, "tile": 64, "stages": 2,
                   "smem": dq_smem},
            "dkv": {"grid": (cluster * _pairs(lk, 64), h, n), "rows": 64, "tile": 64, "stages": 2,
                    "smem": dkv_smem}}


def fwd_d512_f32_plan(n: int, h: int, lq: int, lk: int) -> dict:
    """flash_fwd_d512_f32's attention launch (after the three split
    launches): as bwd_d512_plan's dq launch, 64-key K and V tiles of one
    stage each, both bf16 parts of every operand."""
    smem = 24 * _BOX64 + 2 * _PART + 8 * 9 + 1024
    return {"cluster": _D512_CLUSTER, "half": _D512 // _D512_CLUSTER,
            "grid": (_D512_CLUSTER * _pairs(lq, 64), h, n), "rows": 64, "tile": 64, "stages": 1, "smem": smem}


def f32_plan(n: int, h: int, lq: int, lk: int, d: int) -> dict:
    """The float32 kernels of flash_fwd_sm90.cu and flash_bwd_sm90.cu at
    head dim d <= 256 (the twins of Smem, WideSmem, DqSmem and DkvSmem with
    PARTS 2): the split's width w, then per launch its grid (x, y, z) =
    (row tiles, heads, batch), the rows a block owns, the streamed tile's
    rows, the ring's stages and the shared memory a block. d 129-256
    forward on the wide kernel (64 rows a block, O split across two
    warpgroups); their backward is bwd_d512_plan(half=128, parts=2)."""
    w = split_width(d)
    boxes = 2 * w // 64  # boxes of a row: both parts
    if w == 256:
        fwd = {"grid": (_pairs(lq, 64), h, n), "rows": 64, "tile": 64, "stages": 1,
               "smem": 3 * boxes * _BOX64 + 8 * 5 + 1024}
    else:
        bn, stages = (128, 2) if w == 64 else (64, 2)
        fwd = {"grid": (_pairs(lq, 128), h, n), "rows": 128, "tile": bn, "stages": stages,
               "smem": boxes * 128 * 128 + 2 * stages * boxes * bn * 128 + 8 * (1 + 2 * stages) + 1024}
    plan = {"width": w, "fwd": fwd}
    if d <= _SM90_BWD_HEAD_DIM:
        bn, stages = (64, 3) if w == 64 else (32, 2)
        plan["dq"] = {"grid": (_pairs(lq, 128), h, n), "rows": 128, "tile": bn, "stages": stages,
                      "smem": 2 * boxes * 128 * 128 + 2 * stages * boxes * bn * 128 + 8 * (1 + 2 * stages) + 1024}
        plan["dkv"] = {"grid": (_pairs(lk, 128), h, n), "rows": 128, "tile": bn, "stages": stages,
                       "smem": 2 * boxes * 128 * 128 + 2 * stages * boxes * bn * 128 + 2 * stages * bn * 4
                       + 8 * (1 + 2 * stages) + 1024}
    return plan


def _cluster_fwd_smem(parts: int, ch: int, cs: int, kst: int, vst: int, pp: int) -> int:
    """flash_fwd_wide.cu's ClusterFwdSmem: Q's slice of 64 ch columns, rings
    of `kst` K and `vst` V slices, each warpgroup's S partial slots (pp 0:
    [64, 32] partials, one for each other slice; pp 1: [64, 64] partials,
    one for every slice), the barriers."""
    tile = ch * parts * _BOX64
    slots = cs * 2 * _PART if pp else (cs - 1) * _PART
    return tile + (kst + vst) * tile + 2 * slots + 8 * (1 + 2 + kst + 2 * vst + 6) + 1024


def _cluster_fwd_plan(parts: int, d: int, row_blocks: int, key_tiles: int, sms: int) -> Optional[dict]:
    """The plan of flash_fwd_wide.cu's cluster forward (which only checks
    it, cluster_fwd_fits): the fewest slices cs (2 to 8)
    whose width of ch 64-column chunks is instantiated (bf16 4 or 5, float32
    3 or 4) and fits 227 KB, bf16 with whole tiles a warpgroup (pp 1, with
    two V stages) where it fits, with the deepest (K, V) rings of (2, 2),
    (1, 2), (2, 1), (1, 1);
    the keys split in two parts (ck 2) where the rings can hold two O tiles
    at the end and the doubled grid (row_blocks clusters) fits one wave of
    the card's `sms` SMs. None where no slicing fits (the slice kernel)."""
    chunks = -(-d // 64)
    lo, hi = (4, 5) if parts == 1 else (3, 4)
    for cs in range(2, _MAX_CLUSTER + 1):
        ch = -(-chunks // cs)
        if not lo <= ch <= hi:
            continue
        for pp in ((1, 0) if parts == 1 else (0,)):
            for kst, vst in ((2, 2), (1, 2), (2, 1), (1, 1)):
                if (pp and vst < 2) or _cluster_fwd_smem(parts, ch, cs, kst, vst, pp) > _SMEM_PER_BLOCK:
                    continue
                split = ((kst + vst) * parts >= 4 and 2 * cs <= _MAX_CLUSTER and key_tiles >= 2
                         and 2 * cs * row_blocks <= sms)
                return {"cs": cs, "ch": ch, "ck": 2 if split else 1, "stages": (kst, vst), "pp": pp}
    return None


# flash_bwd_wide_sm90.cu's clusters, in the order the plan tries them: (slices,
# slice width, ring stages) of each type (parts). bf16: a pair of 320 columns
# (one stage: two do not fit), then four and eight slices of 192 and 256 (two
# stages); float32: four slices of 192 (one stage; a float32 block of 256
# does not fit), eight of 128 (two stages), eight of 192.
BWD_CLUSTERS = {1: ((2, 320, 1), (4, 192, 2), (4, 256, 2), (8, 192, 2), (8, 256, 2)),
                2: ((4, 192, 1), (8, 128, 2), (8, 192, 1))}


def _cluster_bwd_launch(cs: int, half: int, stages: int, smem: int, tiles: int, streamed: int, h: int, n: int,
                        split: bool) -> dict:
    """One kernel of the cluster backward: `tiles` 64-row tiles it owns
    (query rows in dq, keys in dk/dv), `streamed` tiles of the other side,
    split over two parts of the cluster where the plan splits and there are
    two tiles to split."""
    parts = 2 if split and streamed >= 2 else 1
    return {"grid": (tiles * cs * parts, h, n), "rows": 64, "tile": 64, "stages": stages, "smem": smem,
            "cluster": cs * parts, "slices": cs, "slice_cols": half, "stream_parts": parts, "width": cs * half}


def wide_plan(n: int, h: int, lq: int, lk: int, d: int, parts: int, sms: int,
              held: Optional[Callable[[int, int, int], int]] = None) -> dict:
    """The launches at head dim d > 512 of flash_fwd_wide.cu (forward) and of
    flash_bwd_wide_sm90.cu or flash_attn_wide.cu (backward) on a card of
    `sms` SMs that holds held(half, stages, cluster) clusters of `cluster`
    blocks of the cluster backward's instance at once (default: sms //
    cluster; the wrappers ask the card, _clusters_held); parts: 1 (bf16) or
    2 (float32's two bf16 parts). Each plan is passed to its kernel, which
    only checks it; the twins of ClusterFwdSmem, FwdSmem, DqSmem and
    DkvSmem.
    The forward ("fwd"), where a
    cluster plan fits: clusters of "slices" blocks of "slice_cols" columns
    times "key_parts" (1 or 2) key parts, grid x = row tiles * cluster,
    block x of rank r = x % cluster owning slice r % slices of key part
    r // slices (part 0's blocks write), "stages" its (K, V) rings,
    "whole_tiles" 1 where its two warpgroups take alternate whole 64-key
    tiles (bf16), 0 where they split every tile's keys, S issued once; its
    float32 scratch "width" = slices * slice_cols. Else the slice
    kernel (cluster 1: every block streams S over 64-column chunks of the
    whole head dim).
    The backward ("dq", "dkv"), within a cluster's reach: the first of
    BWD_CLUSTERS whose slices cover d, "slices" blocks of "slice_cols"
    columns a 64-row tile (query rows in dq, keys in dk/dv) times
    "stream_parts" (1 or 2) parts of the streamed dimension, laid out as the
    forward's key parts (two where the two kernels' clusters, side by side,
    take fewer waves of what the card holds at once, each wave half as long:
    on a tie the merge's cost decides for one part); S and dP summed over
    the slices once a tile; the
    float32 scratch "width" = slices * slice_cols. Else the slice kernels:
    128-column slices ("slice", "slices", the float32 scratch "width" = 128
    * slices columns a part), grid (x, y, z) = (row tiles * slices, heads,
    batch), block x owning rows [rows (x // slices), + rows) and columns
    [128 (x % slices), + 128); the dk/dv launch streams 32-row query tiles."""
    slices = -(-d // _WIDE_SLICE)
    qbox = 32 * 128
    launch = lambda length, tile, smem: {"grid": (_pairs(length, 64) * slices, h, n), "rows": 64, "tile": tile,
                                         "stages": 2, "smem": smem, "cluster": 1, "slices": slices,
                                         "slice_cols": _WIDE_SLICE, "width": slices * _WIDE_SLICE}
    c = _cluster_fwd_plan(parts, d, _pairs(lq, 64) * h * n, _pairs(lk, 64), sms)
    if c is None:
        fwd = dict(launch(lq, 64, 2 * 2 * parts * _BOX64 + 2 * parts * _BOX64 + 8 * 6 + 1024), key_parts=1)
    else:
        cluster = c["cs"] * c["ck"]
        fwd = {"grid": (_pairs(lq, 64) * cluster, h, n), "rows": 64, "tile": 64, "stages": c["stages"],
               "smem": _cluster_fwd_smem(parts, c["ch"], c["cs"], *c["stages"], c["pp"]), "cluster": cluster,
               "slices": c["cs"], "slice_cols": 64 * c["ch"], "key_parts": c["ck"], "whole_tiles": c["pp"],
               "width": c["cs"] * 64 * c["ch"]}
    bwd = next(((cs, half, st) for cs, half, st in BWD_CLUSTERS[parts] if cs * half >= d), None)
    if bwd is None:
        dq = launch(lq, 64, 2 * 4 * parts * _BOX64 + 2 * parts * _BOX64 + 8 * 6 + 1024)
        dkv = launch(lk, 32, 2 * parts * (2 * _BOX64 + 2 * qbox) + 4 * parts * qbox + 2 * 32 * 4 + 8 * 6 + 1024)
    else:
        cs, half, stages = bwd
        dq_smem, dkv_smem = _bwd_cluster_smem(half, parts, stages, 0)
        q_tiles, k_tiles = _pairs(lq, 64), _pairs(lk, 64)
        # dq and dk/dv run side by side (two streams): their clusters share
        # the card, `at_once(c)` clusters of c blocks at a time, and two parts
        # halve each cluster's work
        at_once = lambda c: held(half, stages, c) if held else sms // c
        clusters = (q_tiles + k_tiles) * h * n
        waves = lambda p: -(-clusters // at_once(cs * p)) / p
        split = 2 * cs <= _MAX_CLUSTER and at_once(2 * cs) > 0 and waves(2) < waves(1)
        dq = _cluster_bwd_launch(cs, half, stages, dq_smem, q_tiles, k_tiles, h, n, split)
        dkv = _cluster_bwd_launch(cs, half, stages, dkv_smem, k_tiles, q_tiles, h, n, split)
    return {"slice": _WIDE_SLICE, "slices": slices, "chunks": -(-d // 64), "width": slices * _WIDE_SLICE,
            "parts": parts, "fwd": fwd, "dq": dq, "dkv": dkv}


@functools.lru_cache(maxsize=None)
def _clusters_held(index: int, parts: int, half: int, stages: int, cluster: int) -> int:
    """How many clusters of `cluster` blocks of flash_bwd_wide_sm90.cu's
    (parts, half, stages) kernels CUDA device `index` holds at once (the
    fewer of its dq and dk/dv kernels'; emox_flash_bwd_wide_clusters)."""
    with torch.cuda.device(index):
        fn = build.kernel("flash_bwd_wide_sm90", "emox_flash_bwd_wide_clusters")
        got = [fn(2 - parts, half, stages, cluster, dkv) for dkv in (0, 1)]
    for g in got:
        if g < 0:
            build.check(-g, "flash_bwd_wide_clusters")
    return min(got)


def card_wide_plan(n: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype, index: int) -> dict:
    """wide_plan on CUDA device `index`: its SMs and the clusters it holds."""
    parts = 2 if dtype == torch.float32 else 1
    return wide_plan(n, h, lq, lk, d, parts, _sm_count(index),
                     lambda half, stages, cluster: _clusters_held(index, parts, half, stages, cluster))


def cluster_bwd_args(plan: dict) -> tuple:
    """wide_plan's backward as emox_flash_bwd_wide_sm90 takes it: (cs, half,
    stages, dq parts, dk/dv parts); () for the slice kernels."""
    dq, dkv = plan["dq"], plan["dkv"]
    if dq["cluster"] == 1:
        return ()
    return (dq["slices"], dq["slice_cols"], dq["stages"], dq["stream_parts"], dkv["stream_parts"])


def cluster_fwd_args(fwd: dict) -> tuple:
    """wide_plan's "fwd" as emox_flash_fwd_wide takes it: (cs, ch, ck,
    K stages, V stages, pp), cs 0 for the slice kernel."""
    if fwd["cluster"] == 1:
        return (0,) * 6
    return (fwd["slices"], fwd["slice_cols"] // 64, fwd["key_parts"], *fwd["stages"], fwd["whole_tiles"])


# ---- the packed layout [N, L, H*D] ---------------------------------------------------
def _check_kernel_inputs(name: str, q, k, v, heads: int):
    n, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if c != heads * d:
        raise ValueError(f"{name}: {c} channels do not split into {heads} heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (n, lk, c) or v.shape != k.shape:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must lie on one device")
    return n, lq, lk, d


def _flash_kernel(q, k, v, heads: int, scale: float):
    n, lq, lk, d = _check_kernel_inputs("flash_attn_nlc_fwd", q, k, v, heads)
    # head-split views of the packed tokens: no copy
    out, lse = _fwd_views(*(_split_heads(t.contiguous(), heads) for t in (q, k, v)), scale, packed_lse=True)
    flash_attention_nlc.launches += 1
    return out.transpose(1, 2).reshape(n, lq, heads * d), lse


def _flash_bwd_kernel(q, k, v, o, lse, dout, heads: int, scale: float, need_dq: bool, need_dkv: bool):
    n, lq, _, _ = _check_kernel_inputs("flash_attn_nlc_bwd", q, k, v, heads)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attn_nlc_bwd: o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (n, lq, heads) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_nlc_bwd: lse must be [N, Lq, H] float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attn_nlc_bwd: every input must lie on q's device")
    split = lambda t: _split_heads(t.contiguous(), heads)  # head-split views: no copy
    grads = _bwd_views(split(q), split(k), split(v), split(o), split(dout), lse.transpose(1, 2), scale,
                       need_dq, need_dkv)
    flash_attention_nlc_bwd.launches += 1
    return tuple(None if g is None else g.transpose(1, 2).reshape(t.shape) for g, t in zip(grads, (q, k, v)))


def flash_attention_nlc_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, heads: int, scale: Optional[float] = None,
                            need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of flash attention on the packed layout from the forward's
    out and lse and the output gradient; a gradient not asked for is None.
    Launches the CUDA kernels for CUDA tensors (the dq kernel only with
    need_dq, the dk/dv kernel only with need_dkv) and runs the plain version
    for CPU tensors."""
    d = q.shape[-1] // heads
    scale = float(d ** -0.5) if scale is None else float(scale)
    if _on_card_or_cpu("flash_attention_nlc_bwd", q):
        if not (need_dq or need_dkv):
            return None, None, None
        return _flash_bwd_kernel(q, k, v, o, lse, dout, heads, scale, need_dq, need_dkv)
    dq, dk, dv = attention_nlc_bwd_plain(q, k, v, o, lse, dout, heads, scale)
    return (dq if need_dq else None,) + ((dk, dv) if need_dkv else (None, None))


flash_attention_nlc_bwd.launches = 0  # kernel launches since the last reset


class _FlashNLC(torch.autograd.Function):
    """Flash attention with the reference's custom VJP (`_flash_nlc`):
    forward saves (q, k, v, out, lse); backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        if _on_card_or_cpu("flash_attention_nlc", q):
            out, lse = _flash_kernel(q, k, v, heads, scale)
        else:
            out, lse = attention_nlc_plain(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_nlc_bwd(q, k, v, out, lse, dout, ctx.heads, ctx.scale,
                                             need_dq=need_q, need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None, None


def flash_attention_nlc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention on the packed layout: q [N, Lq, H*D], k/v [N, Lk, H*D]
    -> [N, Lq, H*D] (and lse [N, Lq, H] fp32 with return_lse).
    Differentiable. Launches the CUDA kernels for CUDA tensors (counted here,
    one a forward, whichever kernel it takes) and runs the plain versions for
    CPU tensors."""
    d = q.shape[-1] // heads
    scale = float(d ** -0.5) if scale is None else float(scale)
    out, lse = _FlashNLC.apply(q, k, v, heads, scale)
    return (out, lse) if return_lse else out


flash_attention_nlc.launches = 0  # forward launches on the packed layout since the last reset


# ---- [B, H, L, D] operands with strides ---------------------------------------------
def _check_strided_inputs(name: str, q, k, v) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name} takes [B, H, L, D] operands, got q {tuple(q.shape)}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must lie on one device")
    return b, h, lq, lk, d


def _flash_strided_kernel(q, k, v, scale: float):
    _check_strided_inputs("flash_attn_fwd", q, k, v)
    out, lse = _fwd_views(q, k, v, scale, packed_lse=False)
    flash_attention.launches += 1
    return out, lse


def _flash_strided_bwd_kernel(q, k, v, o, lse, dout, scale: float, need_dq: bool, need_dkv: bool):
    b, h, lq, lk, d = _check_strided_inputs("flash_attn_bwd", q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attn_bwd: o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_bwd: lse must be [B, H, Lq] float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attn_bwd: every input must lie on q's device")
    grads = _bwd_views(q, k, v, o, dout, lse, scale, need_dq, need_dkv)
    flash_attention_bwd.launches += 1
    return grads


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None,
                        need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of flash attention on [B, H, L, D] from the forward's out
    and lse [B, H, Lq] and the output gradient; a gradient not asked for is
    None. Launches the CUDA kernels for CUDA tensors (the dq kernel only with
    need_dq, the dk/dv kernel only with need_dkv) and runs the plain version
    for CPU tensors."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    if _on_card_or_cpu("flash_attention_bwd", q):
        if not (need_dq or need_dkv):
            return None, None, None
        return _flash_strided_bwd_kernel(q, k, v, o, lse, dout, scale, need_dq, need_dkv)
    dq, dk, dv = attention_bwd_plain(q, k, v, o, lse, dout, scale)
    return (dq if need_dq else None,) + ((dk, dv) if need_dkv else (None, None))


flash_attention_bwd.launches = 0  # kernel launches since the last reset


class _Flash(torch.autograd.Function):
    """Flash attention on [B, H, L, D] with the reference's custom VJP
    (`_flash`): forward saves (q, k, v, out, lse); backward recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if _on_card_or_cpu("flash_attention", q):
            out, lse = _flash_strided_kernel(q, k, v, scale)
        else:
            out, lse = attention_plain(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        q, k, v, out, lse = ctx.saved_tensors
        if dout.is_cuda and not _rows_aligned(dout):
            dout = dout.contiguous()  # autograd picks the gradient's layout, not the caller
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale,
                                         need_dq=need_q, need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Flash attention: q [B, H, Lq, D], k/v [B, H, Lk, D] -> [B, H, Lq, D]
    (and lse [B, H, Lq] fp32 with return_lse), any strides with a contiguous
    head dim. Differentiable. Launches the CUDA kernels for CUDA tensors
    (counted here, one a forward) and runs the plain versions for CPU
    tensors."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    out, lse = _Flash.apply(q, k, v, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # forward launches on [B, H, L, D] operands since the last reset


# ---- the dispatcher ---------------------------------------------------------------------
def _resolve_impl(impl: Optional[str], lk: int) -> str:
    impl = impl or attention_default_impl()
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}: EMOX_ATTENTION_IMPL and impl take {ATTENTION_IMPLS}")
    if impl == "auto":
        return "pallas" if lk >= KERNEL_MIN_KV else "xla"
    return impl


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, impl: Optional[str] = None) -> torch.Tensor:
    """Attention on [B, H, L, D] by the reference's impl names (module
    docstring): the strided kernel under "pallas" (and "auto" where
    Lk >= KERNEL_MIN_KV), its plain version under "pallas_interpret",
    attention_xla otherwise."""
    impl = _resolve_impl(impl, k.shape[2])
    if impl == "pallas":
        return flash_attention(q, k, v, scale)
    if impl == "pallas_interpret":
        return attention_plain(q, k, v, float(q.shape[-1] ** -0.5) if scale is None else float(scale))[0]
    return attention_xla(q, k, v, scale)


def dot_product_attention_nlc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              scale: Optional[float] = None, impl: Optional[str] = None) -> torch.Tensor:
    """Entry point of the nn modules: attention on [N, L, H*D] tokens by the
    reference's impl names. A kernel route takes the packed kernel for
    head_dim % 64 == 0 (its plain version under "pallas_interpret") and the
    strided one on head-split views otherwise; "xla" is plain PyTorch."""
    d = q.shape[-1] // heads
    impl = _resolve_impl(impl, k.shape[1])
    if impl == "pallas" and d % 64 == 0:
        return flash_attention_nlc(q, k, v, heads, scale)
    if impl == "pallas_interpret" and d % 64 == 0:
        return attention_nlc_plain(q, k, v, heads, float(d ** -0.5) if scale is None else float(scale))[0]
    n, lq, _ = q.shape
    out = dot_product_attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads), scale,
                                impl=impl)
    return out.transpose(1, 2).reshape(n, lq, heads * d)
