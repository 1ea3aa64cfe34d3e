"""Fused LayerNorm + bias-free q/k/v projections for the port.

Counterpart of the reference's `fused_ln_qkv` (emox/ops/ff.py), which the
self-attention and temporal-attention sites take under EMOX_LN_QKV (any
value but unset, empty or "0"). The TPU kernel `_ln_qkv_kernel` (K7)
becomes the CUDA kernel `ln_qkv` (emox_torch/csrc/ln_qkv.cu), reached
through the autograd function `fused_ln_qkv`:

  * on a CUDA tensor the wrapper launches the kernel, or raises for an
    input it does not take; there is no fallback;
  * on a CPU tensor it runs `ln_qkv_plain`, the same function with the
    kernel's rounding points in plain PyTorch.

The backward recomputes through `ln_qkv_xla` and differentiates it, as the
reference's `_ln_qkv_bwd` does; there is no backward kernel.

Weights are in PyTorch's Linear layout, [inner, C] each, passed as three
tensors (no concatenation per call). The reference's `ln_qkv_plan`, a TPU
VMEM budget that refuses C 1280 in bf16, does not carry over: the kernel
takes every enabled, bias-free site.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

from emox_torch.ops import build
from emox_torch.ops.attention import _on_card_or_cpu

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _ln_qkv_enabled() -> bool:
    """EMOX_LN_QKV: opt-in, off unless set to something other than "" or "0"."""
    return os.environ.get("EMOX_LN_QKV", "") not in ("", "0")


def _normalise(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 two-pass statistics, rounded to x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(x.dtype)


def ln_qkv_xla(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, wq: torch.Tensor,
               wk: torch.Tensor, wv: torch.Tensor, eps: float = 1e-5) -> QKV:
    """(LN(x) Wq^T, LN(x) Wk^T, LN(x) Wv^T) as the reference's ln_qkv_xla:
    fp32 statistics, the normalised x rounded to x's type, products in the
    operands' own type. The recompute target of the backward."""
    xn = _normalise(x, ln_w, ln_b, eps)
    return F.linear(xn, wq), F.linear(xn, wk), F.linear(xn, wv)


def ln_qkv_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, wq: torch.Tensor,
                 wk: torch.Tensor, wv: torch.Tensor, eps: float = 1e-5) -> QKV:
    """K7's function in plain PyTorch, rounding where the kernel rounds: the
    normalised x to x's type, then fp32 products, each output rounded once."""
    xn = _normalise(x, ln_w, ln_b, eps).float()
    return tuple(F.linear(xn, w.float()).to(x.dtype) for w in (wq, wk, wv))


def _qkv_kernel(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    c = x.shape[-1]
    inner = wq.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ln_qkv takes float32 or bfloat16, got {x.dtype}")
    params = (ln_w, ln_b, wq, wk, wv)
    if any(p.dtype != x.dtype or p.device != x.device for p in params):
        raise TypeError("ln_qkv needs every weight on x's device and in x's type")
    shapes = [tuple(p.shape) for p in params]
    if shapes != [(c,), (c,)] + [(inner, c)] * 3 or c % 16 or inner % 16:
        raise ValueError(f"ln_qkv shapes: x [.., {c}], weights {shapes} (C % 16, inner % 16)")
    xm = x.reshape(-1, c).contiguous()
    params = tuple(p.contiguous() for p in params)
    if any(t.data_ptr() % 16 for t in (xm, *params)):
        raise ValueError("ln_qkv needs 16-byte aligned inputs")
    m = xm.shape[0]
    outs = [torch.empty((m, inner), device=x.device, dtype=x.dtype) for _ in range(3)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = build.kernel("ln_qkv")(
            xm.data_ptr(), *(p.data_ptr() for p in params), *(o.data_ptr() for o in outs),
            m, c, inner, float(eps), _DTYPES[x.dtype], stream,
        )
    build.check(err, "ln_qkv")
    fused_ln_qkv.launches += 1
    shape = x.shape[:-1] + (inner,)
    return tuple(o.reshape(shape) for o in outs)


class _LnQKV(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward:
    recompute through ln_qkv_xla and differentiate it."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, wk, wv, eps: float):
        if _on_card_or_cpu("fused_ln_qkv", x):
            out = _qkv_kernel(x, ln_w, ln_b, wq, wk, wv, eps)
        else:
            out = ln_qkv_plain(x, ln_w, ln_b, wq, wk, wv, eps)
        ctx.save_for_backward(x, ln_w, ln_b, wq, wk, wv)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dq, dk, dv):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            outs = ln_qkv_xla(*inputs, eps=ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (dq, dk, dv)) if wanted else ())
        return (*(next(grads) if need else None for need in needs), None)


def fused_ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, wq: torch.Tensor,
                 wk: torch.Tensor, wv: torch.Tensor, eps: float = 1e-5) -> QKV:
    """(q, k, v) = LN(x) projected by Wq, Wk, Wv ([inner, C] each, no bias)
    on x [..., C], differentiable. Launches the CUDA kernel for CUDA tensors
    and runs the plain version for CPU tensors."""
    return _LnQKV.apply(x, ln_w, ln_b, wq, wk, wv, float(eps))


fused_ln_qkv.launches = 0  # kernel launches since the last reset
