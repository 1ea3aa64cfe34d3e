"""Attention for the port: the packed flash-attention kernels and plain paths.

Counterpart of emox/ops/attention.py. The TPU kernel `_flash_nlc_kernel`
becomes the CUDA kernel `flash_attn_nlc_fwd` (emox_torch/csrc/
flash_attn_nlc.cu), and the TPU kernels `_flash_bwd_nlc_dq_kernel` and
`_flash_bwd_nlc_dkv_kernel` the CUDA kernels of `flash_attn_nlc_bwd`
(emox_torch/csrc/flash_attn_nlc_bwd.cu). `flash_attention_nlc` is an
autograd function: its forward saves (q, k, v, out, lse) and its backward
is `flash_attention_nlc_bwd`. Each wrapper chooses by the tensor's device:

  * on a CUDA tensor it launches the kernel, or raises for an input it does
    not take (head dims other than 64 and 128, types other than float32 and
    bfloat16); there is no fallback;
  * on a CPU tensor it runs the plain version (`attention_nlc_plain`,
    `attention_nlc_bwd_plain`), the same function in plain PyTorch with
    fp32 math, which the CPU tests hold against the reference.

`dot_product_attention_nlc`, the entry point the nn modules call, takes the
kernel exactly where the reference's dispatcher takes its Pallas kernel
(Lk >= KERNEL_MIN_KV and head_dim % 64 == 0) and plain matmul + softmax
everywhere else, as the reference leaves those sites to XLA. No site calls
a library attention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emox_torch.ops import build

# K/V length from which the kernel is taken. The reference's cutoff
# (_PALLAS_MIN_KV), measured on a TPU v5e; kept here so the port runs its
# kernel at the same sites, and to be measured again on the H100
# (ROADMAP.md, Queue 2).
KERNEL_MIN_KV = 2048
_HEAD_DIMS = (64, 128)
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


def _check_kernel_inputs(name: str, q, k, v, heads: int):
    n, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if d not in _HEAD_DIMS or c != heads * d:
        raise ValueError(f"{name} takes head_dim 64 or 128, got {c}/{heads}")
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
    n, lq, lk, d = _check_kernel_inputs("flash_attn_nlc_bwd", q, k, v, heads)
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


def dot_product_attention_nlc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Entry point of the nn modules: attention on [N, L, H*D] tokens. The
    kernel where the reference takes its Pallas kernel, plain PyTorch
    elsewhere."""
    d = q.shape[-1] // heads
    if k.shape[1] >= KERNEL_MIN_KV and d % 64 == 0:
        return flash_attention_nlc(q, k, v, heads, scale)
    n, lq, _ = q.shape
    out = attention_xla(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads), scale)
    return out.transpose(1, 2).reshape(n, lq, heads * d)
