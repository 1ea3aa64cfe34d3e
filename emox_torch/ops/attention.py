"""Attention for the port: the packed flash-attention kernels and plain paths.

Counterpart of emox/ops/attention.py. The TPU kernel `_flash_nlc_kernel`
becomes the CUDA kernel `flash_attn_nlc_fwd` (emox_torch/csrc/
flash_attn_nlc.cu), and the TPU kernels `_flash_bwd_nlc_dq_kernel` and
`_flash_bwd_nlc_dkv_kernel` the CUDA kernels of `flash_attn_nlc_bwd`
(emox_torch/csrc/flash_attn_nlc_bwd.cu). `flash_attention_nlc` is an
autograd function: its forward saves (q, k, v, out, lse) and its backward
is `flash_attention_nlc_bwd`. Each wrapper chooses by the tensor's device:

  * on a CUDA tensor it launches the kernel, or raises for an input it does
    not take (types other than float32 and bfloat16; head dims other than
    64, 128 and 512 forward, 64 and 128 backward: d 512 is the VAE's
    single-head mid-attention, whose backward only VAE pretraining, stage 5,
    would need); there is no fallback;
  * on a CPU tensor it runs the plain version (`attention_nlc_plain`,
    `attention_nlc_bwd_plain`), the same function in plain PyTorch with
    fp32 math, which the CPU tests hold against the reference.

The TPU kernels `_flash_kernel`, `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel` (the reference's [B, H, L, D] layout) become the
CUDA kernels `flash_attn_fwd` (emox_torch/csrc/flash_attn.cu) and
`flash_attn_bwd` (emox_torch/csrc/flash_attn_bwd.cu), behind the autograd
function `flash_attention` and its backward `flash_attention_bwd`, with the
plain versions `attention_plain` and `attention_bwd_plain`. These kernels
take element strides, so head-split views of packed tokens reach them with
no copy; on CUDA tensors they take head dims 40 and 80 and raise for any
other.

`dot_product_attention_nlc`, the entry point the nn modules call, takes a
kernel exactly where the reference's dispatcher takes a Pallas kernel: for
Lk >= KERNEL_MIN_KV, the packed kernel when head_dim % 64 == 0 and the
strided one (`dot_product_attention` on head-split views) otherwise; plain
matmul + softmax everywhere else, as the reference leaves those sites to
XLA. No site calls a library attention.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from emox_torch.ops import build

# K/V length from which the kernel is taken. The reference's cutoff
# (_PALLAS_MIN_KV), measured on a TPU v5e; kept here so the port runs its
# kernel at the same sites, and to be measured again on the H100
# (ROADMAP.md, Queue 2).
KERNEL_MIN_KV = 2048
_HEAD_DIMS = (64, 128, 512)  # flash_attn_nlc.cu
_BWD_HEAD_DIMS = (64, 128)  # flash_attn_nlc_bwd.cu
_STRIDED_HEAD_DIMS = (40, 80)  # flash_attn.cu / flash_attn_bwd.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check_kernel_inputs(name: str, q, k, v, heads: int, head_dims=_HEAD_DIMS):
    n, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if d not in head_dims or c != heads * d:
        raise ValueError(f"{name} takes head_dim {' or '.join(map(str, head_dims))}, got {c}/{heads}"
                         + (" (the VAE's d 512 mid-attention trains only in stage 5, VAE pretraining, "
                            "which the port does not run yet)" if d == 512 else ""))
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
    _aligned("flash_attn_nlc_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((n, lq, heads), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_nlc")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n, lq, lk, heads, d, float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(err, "flash_attn_nlc_fwd")
    flash_attention_nlc.launches += 1
    return out, lse


def _flash_bwd_kernel(q, k, v, o, lse, dout, heads: int, scale: float, need_dq: bool, need_dkv: bool):
    n, lq, lk, d = _check_kernel_inputs("flash_attn_nlc_bwd", q, k, v, heads, _BWD_HEAD_DIMS)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attn_nlc_bwd: o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (n, lq, heads) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_nlc_bwd: lse must be [N, Lq, H] float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attn_nlc_bwd: every input must lie on q's device")
    q, k, v, dout, lse = (t.contiguous() for t in (q, k, v, dout, lse))
    # per-head delta = sum_d dO * O, [N, Lq, H] fp32: outside the kernels, as
    # the reference computes it outside its Pallas kernels
    delta = (dout.float() * o.float()).reshape(n, lq, heads, d).sum(dim=-1)
    dq = torch.empty_like(q) if need_dq else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_dkv else (None, None)
    _aligned("flash_attn_nlc_bwd", q, k, v, dout, *(t for t in (dq, dk, dv) if t is not None))
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_nlc_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), n, lq, lk, heads, d, float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(err, "flash_attn_nlc_bwd")
    flash_attention_nlc_bwd.launches += 1
    return dq, dk, dv


def _on_card_or_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


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
    Differentiable. Launches the CUDA kernels for CUDA tensors and runs the
    plain versions for CPU tensors."""
    d = q.shape[-1] // heads
    scale = float(d ** -0.5) if scale is None else float(scale)
    out, lse = _FlashNLC.apply(q, k, v, heads, scale)
    return (out, lse) if return_lse else out


flash_attention_nlc.launches = 0  # kernel launches since the last reset


# ---- the strided kernels: [B, H, L, D] operands (TPU `_flash_kernel` & co.) ----------
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


def _check_strided_inputs(name: str, q, k, v) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name} takes [B, H, L, D] operands, got q {tuple(q.shape)}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in _STRIDED_HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim 40 or 80, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must lie on one device")
    return b, h, lq, lk, d


def _rows_aligned(t: torch.Tensor) -> bool:
    """The strided kernels read and write whole rows in 16-byte vectors: the
    head dim contiguous and every row 16-byte aligned (base pointer and
    batch, head and row strides)."""
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


def _flash_strided_kernel(q, k, v, scale: float):
    b, h, lq, lk, d = _check_strided_inputs("flash_attn_fwd", q, k, v)
    out = torch.empty_like(q)  # q's strides when q is dense (a head-split view stays packed)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _check_rows("flash_attn_fwd", q=q, k=k, v=v, out=out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out)), b, h, lq, lk, d, float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(err, "flash_attn_fwd")
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
    # per-row delta = sum_d dO * O, [B, H, Lq] fp32: outside the kernels, as
    # the reference computes it outside its Pallas kernels
    delta = (dout.float() * o.float()).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    dq = torch.empty_like(q) if need_dq else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_dkv else (None, None)
    outs = dict(dq=dq, dk=dk, dv=dv)
    _check_rows("flash_attn_bwd", q=q, k=k, v=v, dout=dout, **{n: t for n, t in outs.items() if t is not None})
    # an output not asked for takes its input's strides (the kernel ignores them)
    strides = _stride_array((q, k, v, dout, dq if need_dq else q, dk if need_dkv else k, dv if need_dkv else v))
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = build.kernel("flash_attn_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), strides, b, h, lq, lk, d, float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(err, "flash_attn_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


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
    head dim. Differentiable. Launches the CUDA kernels for CUDA tensors and
    runs the plain versions for CPU tensors."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    out, lse = _Flash.apply(q, k, v, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches since the last reset


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Attention on [B, H, L, D]: the strided kernel where the reference's
    dispatcher takes its Pallas kernel (Lk >= KERNEL_MIN_KV), plain PyTorch
    elsewhere."""
    if k.shape[2] >= KERNEL_MIN_KV:
        return flash_attention(q, k, v, scale)
    return attention_xla(q, k, v, scale)


def dot_product_attention_nlc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Entry point of the nn modules: attention on [N, L, H*D] tokens. A
    kernel where the reference takes a Pallas kernel (the packed one for
    head_dim % 64 == 0, the strided one on head-split views otherwise),
    plain PyTorch elsewhere."""
    d = q.shape[-1] // heads
    if k.shape[1] >= KERNEL_MIN_KV and d % 64 == 0:
        return flash_attention_nlc(q, k, v, heads, scale)
    n, lq, _ = q.shape
    out = dot_product_attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads), scale)
    return out.transpose(1, 2).reshape(n, lq, heads * d)
