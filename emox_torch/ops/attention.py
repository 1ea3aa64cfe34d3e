"""Attention for the port: the packed flash-attention kernel and plain paths.

Counterpart of emox/ops/attention.py. The TPU kernel `_flash_nlc_kernel`
becomes the CUDA kernel `flash_attn_nlc_fwd` (emox_torch/csrc/
flash_attn_nlc.cu), reached through `flash_attention_nlc`:

  * on a CUDA tensor the wrapper launches the kernel, or raises for an
    input it does not take (head dims other than 64 and 128, types other
    than float32 and bfloat16); there is no fallback;
  * on a CPU tensor it runs `attention_nlc_plain`, the same function in
    plain PyTorch (fp32 scores, softmax, P v), which the CPU tests hold
    against the reference.

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


def attention_nlc_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q [N, Lq, H*D], k/v
    [N, Lk, H*D] -> (out [N, Lq, H*D] in q's type, lse [N, Lq, H] fp32).
    Everything between the inputs and the rounded output is fp32, as in
    the TPU kernel."""
    qh, kh, vh = (_split_heads(t, heads).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # [N, H, Lq, Lk]
    lse = torch.logsumexp(s, dim=-1)  # [N, H, Lq]
    out = torch.matmul(torch.exp(s - lse[..., None]), vh)
    n, h, lq, d = out.shape
    return (out.transpose(1, 2).reshape(n, lq, h * d).to(q.dtype),
            lse.transpose(1, 2).contiguous())


def _flash_kernel(q, k, v, heads: int, scale: float):
    n, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if d not in _HEAD_DIMS or c != heads * d:
        raise ValueError(f"flash_attn_nlc_fwd takes head_dim 64 or 128, got {c}/{heads}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn_nlc_fwd takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (n, lk, c) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attn_nlc_fwd needs 16-byte aligned inputs")
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


def flash_attention_nlc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention on the packed layout: q [N, Lq, H*D], k/v [N, Lk, H*D]
    -> [N, Lq, H*D] (and lse [N, Lq, H] fp32 with return_lse). Launches the
    CUDA kernel for CUDA tensors and runs the plain version for CPU tensors."""
    d = q.shape[-1] // heads
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.is_cuda:
        out, lse = _flash_kernel(q, k, v, heads, scale)
    elif q.device.type == "cpu":
        out, lse = attention_nlc_plain(q, k, v, heads, scale)
    else:
        raise ValueError(f"flash_attention_nlc runs on CUDA or CPU tensors, got {q.device}")
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
