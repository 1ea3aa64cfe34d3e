"""The transformer feed-forward for the port: GEGLU, fused with LN + residual or alone.

Counterpart of emox/ops/ff.py. Its TPU kernels become two CUDA kernels:

  * `_ln_ff_kernel` and `_ln_ff_wide_kernel` -> `ln_geglu_ff`
    (emox_torch/csrc/ln_geglu_ff.cu), x + GEGLU_FF(LN(x)), reached through
    `fused_ln_geglu_ff`: every FF sub-layer of the model;
  * `_ff_kernel` -> `geglu_ff` (emox_torch/csrc/geglu_ff.cu), GEGLU_FF(x)
    without LN or residual, reached through `fused_geglu_ff` and the
    dispatcher `geglu_ff` (impl / EMOX_FF_IMPL, as the reference's), which
    GEGLUFeedForward calls.

Each wrapper chooses by the tensor's device:

  * on a CUDA tensor it launches its kernel, or raises for an input it does
    not take; there is no fallback;
  * on a CPU tensor it runs its plain version (`ln_geglu_ff_plain`,
    `geglu_ff_plain`), the same function with the kernel's rounding points
    in plain PyTorch.

Both are autograd functions with the reference's custom VJPs (`_ln_ff_bwd`,
`_ff_bwd`): the backward recomputes through the plain formula
(`ln_geglu_ff_xla`, `geglu_ff_xla`) and differentiates that. The reference
has no FF backward kernel, so neither has the port.

Weights are in PyTorch's Linear layout: w1 [2F, C] (value rows, then gate
rows), w2 [C, F]. The reference's erf approximation existed only because
its kernel compiler had no erf; both versions here use the exact erf.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from emox_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def geglu_ff_xla(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """Plain GEGLU feed-forward (the reference's geglu_ff_xla): operands in
    their given type, exact-erf gelu."""
    a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2, b2)


def ln_geglu_ff_xla(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """y = x + GEGLU_FF(LayerNorm(x)) as the reference's ln_geglu_ff_xla: fp32
    statistics, the normalised x cast to x's type, then geglu_ff_xla with
    the operands in their own type. The recompute target of the backward."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    return x + geglu_ff_xla(xn.to(x.dtype), w1, b1, w2, b2)


def ln_geglu_ff_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """y = x + GEGLU_FF(LayerNorm(x)) in plain PyTorch, rounding where the
    kernel rounds: LN statistics and both products accumulate in fp32; the
    normalised x and the gated activation are rounded to x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    h = F.linear(xn.to(x.dtype).float(), w1.float(), b1.float())
    a, g = h.chunk(2, dim=-1)
    hg = (a * F.gelu(g)).to(x.dtype).float()
    return (F.linear(hg, w2.float(), b2.float()) + xf).to(x.dtype)


def _ff_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    c = x.shape[-1]
    two_f = w1.shape[0]
    f = two_f // 2
    if x.dtype not in _DTYPES:
        raise TypeError(f"ln_geglu_ff takes float32 or bfloat16, got {x.dtype}")
    params = (ln_w, ln_b, w1, b1, w2, b2)
    if any(p.dtype != x.dtype or p.device != x.device for p in params):
        raise TypeError("ln_geglu_ff needs every weight on x's device and in x's type")
    shapes = [tuple(p.shape) for p in params]
    if shapes != [(c,), (c,), (two_f, c), (two_f,), (c, f), (c,)] or c % 16 or f % 64:
        raise ValueError(f"ln_geglu_ff shapes: x [.., {c}], weights {shapes} (C % 16, F % 64)")
    xm = x.reshape(-1, c).contiguous()
    params = tuple(p.contiguous() for p in params)
    if any(t.data_ptr() % 16 for t in (xm, *params)):
        raise ValueError("ln_geglu_ff needs 16-byte aligned inputs")
    y = torch.empty_like(xm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = build.kernel("ln_geglu_ff")(
            xm.data_ptr(), *(p.data_ptr() for p in params), y.data_ptr(),
            xm.shape[0], c, f, float(eps), _DTYPES[x.dtype], stream,
        )
    build.check(err, "ln_geglu_ff")
    fused_ln_geglu_ff.launches += 1
    return y.reshape(x.shape)


class _LnGegluFF(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward:
    recompute through ln_geglu_ff_xla and differentiate it, as the
    reference's `_ln_ff_bwd` does."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps: float):
        if x.is_cuda:
            y = _ff_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps)
        else:
            y = ln_geglu_ff_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            y = ln_geglu_ff_xla(*inputs, eps=ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return (*(next(grads) if need else None for need in needs), None)


def fused_ln_geglu_ff(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """x + GEGLU_FF(LayerNorm(x)) on x [..., C], differentiable. Launches the
    CUDA kernel for CUDA tensors and runs the plain version for CPU tensors."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"fused_ln_geglu_ff runs on CUDA or CPU tensors, got {x.device}")
    return _LnGegluFF.apply(x, ln_w, ln_b, w1, b1, w2, b2, float(eps))


fused_ln_geglu_ff.launches = 0  # kernel launches since the last reset


def ff_plan(c: int, dtype: torch.dtype, device="cuda") -> dict:
    """How the kernel runs at width C on a CUDA device, for reports: the row
    tile (the grid is ceil(M / row_tile) blocks), a block's dynamic shared
    memory, and the blocks resident on one SM."""
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        build.check(build.kernel("ln_geglu_ff", "emox_ln_geglu_ff_plan")(c, _DTYPES[dtype], plan),
                    "ln_geglu_ff plan")
    return {"row_tile": plan[0], "smem_bytes": plan[1], "blocks_per_sm": plan[2]}


# ---- K6: GEGLU feed-forward without LN or residual (TPU `_ff_kernel`) --------------
def geglu_ff_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """GEGLU_FF(x) in plain PyTorch, rounding where the kernel rounds: x W1
    and the product with W2 accumulate in fp32 with their biases in fp32;
    a * gelu(g) (exact erf) is rounded to x's type; the result once."""
    h = F.linear(x.float(), w1.float(), b1.float())
    a, g = h.chunk(2, dim=-1)
    hg = (a * F.gelu(g)).to(x.dtype).float()
    return F.linear(hg, w2.float(), b2.float()).to(x.dtype)


def _geglu_kernel(x, w1, b1, w2, b2) -> torch.Tensor:
    c = x.shape[-1]
    two_f = w1.shape[0]
    f = two_f // 2
    if x.dtype not in _DTYPES:
        raise TypeError(f"geglu_ff takes float32 or bfloat16, got {x.dtype}")
    params = (w1, b1, w2, b2)
    if any(p.dtype != x.dtype or p.device != x.device for p in params):
        raise TypeError("geglu_ff needs every weight on x's device and in x's type")
    shapes = [tuple(p.shape) for p in params]
    if shapes != [(two_f, c), (two_f,), (c, f), (c,)] or c % 16 or f % 64:
        raise ValueError(f"geglu_ff shapes: x [.., {c}], weights {shapes} (C % 16, F % 64)")
    xm = x.reshape(-1, c).contiguous()
    params = tuple(p.contiguous() for p in params)
    if any(t.data_ptr() % 16 for t in (xm, *params)):
        raise ValueError("geglu_ff needs 16-byte aligned inputs")
    y = torch.empty_like(xm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = build.kernel("geglu_ff")(
            xm.data_ptr(), *(p.data_ptr() for p in params), y.data_ptr(),
            xm.shape[0], c, f, _DTYPES[x.dtype], stream,
        )
    build.check(err, "geglu_ff")
    fused_geglu_ff.launches += 1
    return y.reshape(x.shape)


class _GegluFF(torch.autograd.Function):
    """Forward: K6 (CUDA) or its plain version (CPU). Backward: recompute
    through geglu_ff_xla and differentiate it, as the reference's `_ff_bwd`
    does (the [M, 2F] projection is never saved from the forward)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y = _geglu_kernel(x, w1, b1, w2, b2) if x.is_cuda else geglu_ff_plain(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return y

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            y = geglu_ff_xla(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return tuple(next(grads) if need else None for need in needs)


def fused_geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """GEGLU_FF(x) on x [..., C], differentiable. Launches K6 for CUDA
    tensors and runs geglu_ff_plain for CPU tensors."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"fused_geglu_ff runs on CUDA or CPU tensors, got {x.device}")
    return _GegluFF.apply(x, w1, b1, w2, b2)


fused_geglu_ff.launches = 0  # kernel launches since the last reset


def ff_default_impl() -> str:
    """EMOX_FF_IMPL if set, else "auto" on a machine with a CUDA card and
    "xla" without one, as the reference's `_default_impl` resolves by
    platform (TPU or not)."""
    return os.environ.get("EMOX_FF_IMPL") or ("auto" if torch.cuda.is_available() else "xla")


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             impl: Optional[str] = None) -> torch.Tensor:
    """Dispatching GEGLU FF entry point, with the reference's impl names:

      * "auto", "fused": the kernel (`fused_geglu_ff`: K6 on CUDA tensors,
        its plain version on CPU tensors);
      * "fused_interpret": the reference's debug route, `geglu_ff_plain` on
        any device;
      * "xla": the plain formula, `geglu_ff_xla`;
      * None: ff_default_impl().

    The reference sends "auto" and even "fused" to XLA where its
    weights-resident kernel would not fit VMEM (C > 448); that budget does
    not carry over, and on the card K6 takes every width it takes (C % 16,
    F % 64). Any other impl raises ValueError."""
    impl = impl or ff_default_impl()
    if impl in ("auto", "fused"):
        return fused_geglu_ff(x, w1, b1, w2, b2)
    if impl == "fused_interpret":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if impl == "xla":
        return geglu_ff_xla(x, w1, b1, w2, b2)
    raise ValueError(f"unknown ff impl {impl!r}")
