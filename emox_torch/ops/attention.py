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
kernel, or raises for an input no kernel takes; there is no fallback:

  * forward, bfloat16, head dim <= 256: `flash_fwd_sm90`
    (emox_torch/csrc/flash_fwd_sm90.cu, wgmma + TMA), one kernel for both
    layouts;
  * forward, float32, head dim <= 256: `flash_fwd_wmma`
    (emox_torch/csrc/flash_attn.cu, 3xTF32 WMMA), both layouts;
  * forward, head dim 512 (the VAE's single-head mid-attention), packed:
    `flash_fwd_wide` (emox_torch/csrc/flash_attn_nlc.cu);
  * backward, head dim <= 256: emox_torch/csrc/flash_attn_nlc_bwd.cu for
    packed d 64 and 128, emox_torch/csrc/flash_attn_bwd.cu for every other
    head dim of either layout (packed tokens as head-split views). Head dim
    512 has no backward kernel: only VAE pretraining (stage 5), which the port
    does not run yet, would need one.

Rows that are not 16-byte aligned (a head dim that is not a multiple of 8 in
bfloat16, of 4 in float32) are zero-padded in the head dim before the launch
(`padded_attention`), the reference's `_pad_dim`: exact, since zero columns
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
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from emox_torch.ops import build

# K/V length from which "auto" takes a kernel. The reference's cutoff
# (_PALLAS_MIN_KV), measured on a TPU v5e; kept here so the port runs its
# kernel at the same sites, and to be measured again on the H100
# (ROADMAP.md, Queue 2).
KERNEL_MIN_KV = 2048
ATTENTION_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")
_MAX_HEAD_DIM = 256  # every route but the wide forward
_WIDE_HEAD_DIM = 512  # flash_attn_nlc.cu, forward only
_PACKED_BWD_HEAD_DIMS = (64, 128)  # flash_attn_nlc_bwd.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    rows and D <= 256, D % 8 == 0, into out (like q) and lse [B, H, Lq] fp32,
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


def flash_fwd_wmma(q, k, v, out, lse, scale: float) -> None:
    """Launch flash_attn.cu's float32 forward (3xTF32 WMMA): q, k, v
    [B, H, L, D] with 16-byte aligned rows and D <= 256, out like q, lse
    [B, H, Lq] fp32 contiguous."""
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out)), b, h, lq, k.shape[2], d, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    build.check(err, "flash_fwd_wmma")
    flash_fwd_wmma.launches += 1


flash_fwd_wmma.launches = 0  # kernel launches since the last reset


def flash_fwd_wide(q, k, v, heads: int, scale: float):
    """Launch flash_attn_nlc.cu's head-dim-512 forward on contiguous, 16-byte
    aligned packed q [N, Lq, H*512], k/v [N, Lk, H*512] -> (out like q,
    lse [N, Lq, H] fp32)."""
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, lq, heads), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_nlc")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n, lq, k.shape[1], heads, _WIDE_HEAD_DIM, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    build.check(err, "flash_fwd_wide")
    flash_fwd_wide.launches += 1
    return out, lse


flash_fwd_wide.launches = 0  # kernel launches since the last reset


def _fwd_views(q, k, v, scale: float, packed_lse: bool):
    """The forward kernel for [B, H, L, D] operands with D <= 256: bf16 ->
    flash_fwd_sm90, float32 -> flash_fwd_wmma, after zero-padding the head
    dim where rows are not 16-byte aligned. Returns out (q's strides where q
    is dense) and lse [B, H, Lq], or with packed_lse a [B, Lq, H] tensor."""
    mult = _row_multiple(q)
    if q.shape[-1] % mult:
        return padded_attention(lambda *a: _fwd_views(*a, packed_lse), q, k, v, scale, mult)
    out = torch.empty_like(q)
    _check_rows("flash attention forward", q=q, k=k, v=v, out=out)
    b, h, lq, _ = q.shape
    if q.dtype == torch.bfloat16:
        lse = torch.empty((b, lq, h) if packed_lse else (b, h, lq), dtype=torch.float32, device=q.device)
        flash_fwd_sm90(q, k, v, out, lse.transpose(1, 2) if packed_lse else lse, scale)
        return out, lse
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    flash_fwd_wmma(q, k, v, out, lse, scale)
    return out, (lse.transpose(1, 2) if packed_lse else lse)


def _bwd_views(q, k, v, dout, lse, delta, scale: float, need_dq: bool, need_dkv: bool):
    """flash_attn_bwd.cu on [B, H, L, D] operands with D <= 256 (lse and
    delta [B, H, Lq] fp32 contiguous), after zero-padding the head dim where
    rows are not 16-byte aligned: padded columns of q, k, v and dO add nothing
    to any product, and those of the gradients are cut off."""
    d = q.shape[-1]
    mult = _row_multiple(q)
    if d % mult:
        grads = _bwd_views(*(pad_head_dim(t, mult) for t in (q, k, v, dout)), lse, delta, scale,
                           need_dq, need_dkv)
        return tuple(None if g is None else g[..., :d] for g in grads)
    dq = torch.empty_like(q) if need_dq else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_dkv else (None, None)
    outs = dict(dq=dq, dk=dk, dv=dv)
    _check_rows("flash_attn_bwd", q=q, k=k, v=v, dout=dout, **{n: t for n, t in outs.items() if t is not None})
    flash_bwd_strided(q, k, v, dout, lse, delta, dq, dk, dv, scale)
    return dq, dk, dv


def flash_bwd_strided(q, k, v, dout, lse, delta, dq, dk, dv, scale: float) -> None:
    """Launch flash_attn_bwd.cu: q, k, v, dout [B, H, L, D] with 16-byte
    aligned rows and D <= 256, lse and delta [B, H, Lq] fp32 contiguous, into
    dq (None: not computed) and dk, dv (both None: not computed), each with
    any strides."""
    # an output not asked for takes its input's strides (the kernel ignores them)
    strides = _stride_array((q, k, v, dout, q if dq is None else dq, k if dk is None else dk,
                             v if dv is None else dv))
    ptr = lambda t: None if t is None else t.data_ptr()
    b, h, lq, d = q.shape
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), strides, b, h, lq, k.shape[2], d, float(scale), _DTYPES[q.dtype],
            _stream(q),
        )
    build.check(err, "flash_attn_bwd")


# ---- the packed layout [N, L, H*D] ---------------------------------------------------
def _check_kernel_inputs(name: str, q, k, v, heads: int, bwd: bool = False):
    n, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if c != heads * d or not (d <= _MAX_HEAD_DIM or (d == _WIDE_HEAD_DIM and not bwd)):
        raise ValueError(f"{name} takes head_dim <= {_MAX_HEAD_DIM}" + ("" if bwd else f" or {_WIDE_HEAD_DIM}")
                         + f", got {c}/{heads}"
                         + (" (the VAE's d 512 mid-attention trains only in stage 5, VAE pretraining, "
                            "which the port does not run yet)" if d == _WIDE_HEAD_DIM else ""))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (n, lk, c) or v.shape != k.shape:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must lie on one device")
    return n, lq, lk, d


def _aligned(name: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned inputs")


def _flash_kernel(q, k, v, heads: int, scale: float):
    n, lq, lk, d = _check_kernel_inputs("flash_attn_nlc_fwd", q, k, v, heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if d == _WIDE_HEAD_DIM:
        _aligned("flash_attn_nlc_fwd", q, k, v)
        out, lse = flash_fwd_wide(q, k, v, heads, scale)
    else:  # head-split views of the packed tokens: no copy
        out, lse = _fwd_views(*(_split_heads(t, heads) for t in (q, k, v)), scale, packed_lse=True)
        out = out.transpose(1, 2).reshape(n, lq, heads * d)
    flash_attention_nlc.launches += 1
    return out, lse


def _flash_bwd_kernel(q, k, v, o, lse, dout, heads: int, scale: float, need_dq: bool, need_dkv: bool):
    n, lq, lk, d = _check_kernel_inputs("flash_attn_nlc_bwd", q, k, v, heads, bwd=True)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attn_nlc_bwd: o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (n, lq, heads) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_nlc_bwd: lse must be [N, Lq, H] float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attn_nlc_bwd: every input must lie on q's device")
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    # per-head delta = sum_d dO * O, [N, Lq, H] fp32: outside the kernels, as
    # the reference computes it outside its Pallas kernels
    delta = (dout.float() * o.float()).reshape(n, lq, heads, d).sum(dim=-1)
    if d not in _PACKED_BWD_HEAD_DIMS:  # the strided kernels, on head-split views
        split = lambda t: _split_heads(t, heads)
        grads = _bwd_views(split(q), split(k), split(v), split(dout), lse.transpose(1, 2).contiguous(),
                           delta.transpose(1, 2).contiguous(), scale, need_dq, need_dkv)
        flash_attention_nlc_bwd.launches += 1
        return tuple(None if g is None else g.transpose(1, 2).reshape(t.shape) for g, t in zip(grads, (q, k, v)))
    lse = lse.contiguous()
    dq = torch.empty_like(q) if need_dq else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_dkv else (None, None)
    _aligned("flash_attn_nlc_bwd", q, k, v, dout, *(t for t in (dq, dk, dv) if t is not None))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_nlc_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), n, lq, lk, heads, d, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    build.check(err, "flash_attn_nlc_bwd")
    flash_attention_nlc_bwd.launches += 1
    return dq, dk, dv


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
def _check_strided_inputs(name: str, q, k, v, bwd: bool = False) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name} takes [B, H, L, D] operands, got q {tuple(q.shape)}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"{name} takes head_dim <= {_MAX_HEAD_DIM}, got {d}"
                         + ("" if bwd else " (head dim 512 runs on the packed layout, flash_attention_nlc)"))
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
    b, h, lq, lk, d = _check_strided_inputs("flash_attn_bwd", q, k, v, bwd=True)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attn_bwd: o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_bwd: lse must be [B, H, Lq] float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attn_bwd: every input must lie on q's device")
    # per-row delta = sum_d dO * O, [B, H, Lq] fp32: outside the kernels, as
    # the reference computes it outside its Pallas kernels
    delta = (dout.float() * o.float()).sum(dim=-1).contiguous()
    grads = _bwd_views(q, k, v, dout, lse.contiguous(), delta, scale, need_dq, need_dkv)
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
