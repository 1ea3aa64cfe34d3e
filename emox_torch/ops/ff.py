"""The transformer feed-forward for the port: GEGLU, fused with LN + residual or alone.

Counterpart of emox/ops/ff.py. Two functions, each behind an autograd
function whose wrapper counts its calls on the card:

  * `fused_ln_geglu_ff`: x + GEGLU_FF(LN(x)), the TPU kernels `_ln_ff_kernel`
    and `_ln_ff_wide_kernel`; every FF sub-layer of the model;
  * `fused_geglu_ff`: GEGLU_FF(x) without LN or residual, the TPU kernel
    `_ff_kernel`, reached through the dispatcher `geglu_ff` (impl /
    EMOX_FF_IMPL, as the reference's), which GEGLUFeedForward calls.

On a CUDA tensor each launches a kernel, chosen by type, or raises for an
input the kernel does not take; there is no fallback:

  * bfloat16 -> `ff_sm90` (emox_torch/csrc/ff_sm90.cu): LN pass, then two
    wgmma + TMA GEMMs with the GEGLU and the bias + residual epilogues,
    one C entry for both functions (C % 8, F % 8);
  * float32 -> `ff_wmma`: the WMMA body of emox_torch/csrc/geglu_ff.cuh,
    ln_geglu_ff.cu with LN and geglu_ff.cu without (C % 16, F % 64).

On a CPU tensor each runs its plain version (`ln_geglu_ff_plain`,
`geglu_ff_plain`), the same function with the kernels' rounding points in
plain PyTorch.

Both autograd functions have the reference's custom VJPs (`_ln_ff_bwd`,
`_ff_bwd`): the backward recomputes through the plain formula
(`ln_geglu_ff_xla`, `geglu_ff_xla`) and differentiates that. The reference
has no FF backward kernel, so neither has the port.

Weights are in PyTorch's Linear layout: w1 [2F, C] (value rows, then gate
rows), w2 [C, F]. The reference's erf approximation existed only because
its kernel compiler had no erf; both versions here use the exact erf.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from emox_torch.ops import build
from emox_torch.ops.attention import _on_card_or_cpu, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM90_ROWS, _SM90_FEATURES, _SM90_COLS = 128, 128, 160  # ff_sm90.cu's tiles: kBM, kBF, kBC
_SM90_DEPTH = 64  # ff_sm90.cu's contraction depth per stage (kBK)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ff_sm90_plan(m: int, c: int, f: int, sms: int) -> dict:
    """How ff_sm90.cu runs on M rows at widths C, F: GEMM 1's grid (128-row x
    128-feature tiles), GEMM 2's (128-row x 160-column tiles), and GEMM 2's
    split of F: 1 where its grid has at least half as many blocks as the
    card has SMs (`sms`), else as many splits as fill the card, each at
    least 4 stages of 64 deep."""
    rows = -(-m // _SM90_ROWS)
    gemm2 = rows * -(-c // _SM90_COLS)
    splits = 1 if 2 * gemm2 >= sms else max(1, min(sms // gemm2, -(-f // _SM90_DEPTH) // 4))
    return {"gemm1_blocks": rows * -(-f // _SM90_FEATURES), "gemm2_blocks": gemm2 * splits, "splits": splits}


def ff_sm90(x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Launch ff_sm90.cu on bf16 x [M, C] and weights, contiguous and 16-byte
    aligned; ln_w and ln_b None: no LN and no residual (K6). Allocates the
    scratch it hands the kernel: xn [M, C] (with LN), h [M, F] and, where
    GEMM 2 splits F, the fp32 partials [splits, M, C]."""
    m, c = x.shape
    f = w1.shape[0] // 2
    xn = torch.empty_like(x) if ln_w is not None else None
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    splits = ff_sm90_plan(m, c, f, _sm_count(x.device.index or 0))["splits"]
    ws = torch.empty((splits, m, c), dtype=torch.float32, device=x.device) if splits > 1 else None
    y = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = build.kernel("ff_sm90")(
            x.data_ptr(), ptr(ln_w), ptr(ln_b), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            ptr(xn), h.data_ptr(), ptr(ws), y.data_ptr(), m, c, f, splits, float(eps), _stream(x),
        )
    build.check(err, "ff_sm90")
    ff_sm90.launches += 1
    return y


ff_sm90.launches = 0  # kernel launches since the last reset


def ff_wmma(x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Launch the float32 WMMA kernel on x [M, C] and weights, contiguous and
    16-byte aligned: ln_geglu_ff.cu with LN, geglu_ff.cu without (ln_w and
    ln_b None)."""
    m, c = x.shape
    f = w1.shape[0] // 2
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if ln_w is not None:
            err = build.kernel("ln_geglu_ff")(
                x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), y.data_ptr(), m, c, f, float(eps), _DTYPES[x.dtype], _stream(x),
            )
        else:
            err = build.kernel("geglu_ff")(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), m, c, f,
                _DTYPES[x.dtype], _stream(x),
            )
    build.check(err, "ff_wmma")
    ff_wmma.launches += 1
    return y


ff_wmma.launches = 0  # kernel launches since the last reset


def _launch_ff(name: str, x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Check the inputs, then launch the kernel of x's type: bf16 ->
    ff_sm90, float32 -> ff_wmma. ln_w, ln_b None: the function without LN
    and residual."""
    c = x.shape[-1]
    two_f = w1.shape[0]
    f = two_f // 2
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    ln = () if ln_w is None else (ln_w, ln_b)
    params = (*ln, w1, b1, w2, b2)
    if any(p.dtype != x.dtype or p.device != x.device for p in params):
        raise TypeError(f"{name} needs every weight on x's device and in x's type")
    shapes = [tuple(p.shape) for p in params]
    want = [(c,)] * len(ln) + [(two_f, c), (two_f,), (c, f), (c,)]
    c_mult, f_mult = (8, 8) if x.dtype == torch.bfloat16 else (16, 64)
    if shapes != want or c % c_mult or f % f_mult or two_f != 2 * f:
        raise ValueError(f"{name} shapes: x [.., {c}], weights {shapes} (bfloat16: C % 8, F % 8 on ff_sm90; "
                         f"float32: C % 16, F % 64 on the WMMA kernel)")
    xm = x.reshape(-1, c).contiguous()
    params = tuple(p.contiguous() for p in params)
    if any(t.data_ptr() % 16 for t in (xm, *params)):
        raise ValueError(f"{name} needs 16-byte aligned inputs")
    if ln:
        ln_w, ln_b, *params = params
    launch = ff_sm90 if x.dtype == torch.bfloat16 else ff_wmma
    return launch(xm, ln_w, ln_b, *params, eps).reshape(x.shape)


def _ff_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    y = _launch_ff("ln_geglu_ff", x, ln_w, ln_b, w1, b1, w2, b2, eps)
    fused_ln_geglu_ff.launches += 1
    return y


class _LnGegluFF(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward:
    recompute through ln_geglu_ff_xla and differentiate it, as the
    reference's `_ln_ff_bwd` does."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps: float):
        if _on_card_or_cpu("fused_ln_geglu_ff", x):
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
    """x + GEGLU_FF(LayerNorm(x)) on x [..., C], differentiable. Launches a
    kernel for CUDA tensors (ff_sm90 in bf16, the WMMA kernel in float32) and
    runs the plain version for CPU tensors."""
    _on_card_or_cpu("fused_ln_geglu_ff", x)
    return _LnGegluFF.apply(x, ln_w, ln_b, w1, b1, w2, b2, float(eps))


fused_ln_geglu_ff.launches = 0  # calls on the card (either kernel) since the last reset


def ff_plan(c: int, dtype: torch.dtype, device="cuda") -> dict:
    """How the float32 WMMA kernel runs at width C on a CUDA device, for
    reports: the row tile (the grid is ceil(M / row_tile) blocks), a
    block's dynamic shared memory, and the blocks resident on one SM."""
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
    y = _launch_ff("geglu_ff", x, None, None, w1, b1, w2, b2, 0.0)
    fused_geglu_ff.launches += 1
    return y


class _GegluFF(torch.autograd.Function):
    """Forward: K6 (CUDA) or its plain version (CPU). Backward: recompute
    through geglu_ff_xla and differentiate it, as the reference's `_ff_bwd`
    does (the [M, 2F] projection is never saved from the forward)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        if _on_card_or_cpu("fused_geglu_ff", x):
            y = _geglu_kernel(x, w1, b1, w2, b2)
        else:
            y = geglu_ff_plain(x, w1, b1, w2, b2)
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
    """GEGLU_FF(x) on x [..., C], differentiable. Launches a kernel for CUDA
    tensors (ff_sm90 in bf16, the WMMA kernel in float32) and runs
    geglu_ff_plain for CPU tensors."""
    _on_card_or_cpu("fused_geglu_ff", x)
    return _GegluFF.apply(x, w1, b1, w2, b2)


fused_geglu_ff.launches = 0  # calls on the card (either kernel) since the last reset


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
    not carry over, and on the card K6 takes every width its kernels take
    (bfloat16 C % 8, F % 8; float32 C % 16, F % 64). Any other impl raises
    ValueError."""
    impl = impl or ff_default_impl()
    if impl in ("auto", "fused"):
        return fused_geglu_ff(x, w1, b1, w2, b2)
    if impl == "fused_interpret":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if impl == "xla":
        return geglu_ff_xla(x, w1, b1, w2, b2)
    raise ValueError(f"unknown ff impl {impl!r}")
