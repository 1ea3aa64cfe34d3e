"""Fused LayerNorm + bias-free q/k/v projections for the port.

Counterpart of the reference's `fused_ln_qkv` (emox/ops/ff.py), which the
self-attention and temporal-attention sites take under EMOX_LN_QKV (any
value but unset, empty or "0"). The TPU kernel `_ln_qkv_kernel` (K7) is
reached through the autograd function `fused_ln_qkv`, whose wrapper counts
its calls on the card:

  * on a CUDA tensor it launches the kernel of x's type, or raises for an
    input neither takes; there is no fallback:
      - bfloat16 -> `ln_qkv_sm90` (emox_torch/csrc/ln_qkv_sm90.cu): LN in
        the prologue of one wgmma + TMA GEMM over the three projections'
        column tiles (C % 8, C <= 1280, inner % 8);
      - float32 -> `ln_qkv_f32_sm90` (ln_qkv_sm90.cu's float32 entry): an
        LN pass and one split launch write xn's and the weights' two bf16
        parts, then one wgmma + TMA GEMM over the split (every product as
        hi hi + hi lo + lo hi) writes q, k, v (C % 4, inner % 4, any C);
  * on a CPU tensor it runs `ln_qkv_plain`, the same function with the
    kernels' rounding points in plain PyTorch.

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
from emox_torch.ops.attention import _on_card_or_cpu, _stream
from emox_torch.ops.ff import _sm_count, parts_scratch, parts_width, ring_bytes
from emox_torch.ops.registry import kernel_op, route

_DTYPES = (torch.float32, torch.bfloat16)
QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
SM90_MAX_C = 1280  # the x tile [rows, C] of ln_qkv_sm90.cu stays in shared memory
# ln_qkv_sm90.cu's tiles by the 64-column chunks of C: (most chunks, BM rows, BN columns, ring stages)
_SM90_TILES = ((5, 256, 160, 3), (10, 128, 128, 4), (20, 64, 128, 4))
_F32_ROWS, _F32_COLS, _F32_STAGES = 128, 160, 3  # ln_qkv_sm90.cu's float32 GEMM: kBM, kBN, kStages


def sw128_channel(chunk: int, row: int, unit: int) -> int:
    """The first channel of the 16-byte unit at physical position `unit`
    (0-7) of `row` in the 64-column `chunk` of ln_qkv_sm90.cu's x tile,
    which TMA writes with the 128-byte swizzle (`unit_channel` there): the
    unit holds the row's logical unit unit ^ (row % 8)."""
    return 64 * chunk + 8 * (unit ^ (row & 7))


def ln_qkv_sm90_plan(m: int, c: int, inner: int, sms: int) -> dict:
    """How ln_qkv_sm90.cu runs on x [m, c] with three [inner, c] weights:
    the tile (BM rows, BN columns) and ring for C, its shared memory (the
    x tile, the ring, mbarriers, alignment slack), the column tiles (each
    inside one of q, k, v: ceil(inner / BN) per output), and `per`, the
    column tiles a block takes: the most that divide them evenly and still
    leave a block for 7 in 8 of the SMs (each block normalises its rows
    once), else 1."""
    chunks = -(-c // 64)
    bm, bn, stages = next((bm, bn, st) for most, bm, bn, st in _SM90_TILES if chunks <= most)
    rows, col_tiles = -(-m // bm), 3 * -(-inner // bn)
    per = max((p for p in range(1, col_tiles + 1) if col_tiles % p == 0 and 8 * rows * (col_tiles // p) >= 7 * sms),
              default=1)
    smem = chunks * bm * 128 + stages * bn * 128 + 8 * (2 * stages + 4) + 1024
    return {"bm": bm, "bn": bn, "stages": stages, "smem_bytes": smem, "col_tiles": col_tiles, "per": per,
            "blocks": rows * (col_tiles // per)}


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


def ln_qkv_sm90(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    """Launch ln_qkv_sm90.cu on bf16 x [M, C] and its weights, contiguous and
    16-byte aligned."""
    m, c = x.shape
    inner = wq.shape[0]
    outs = [torch.empty((m, inner), device=x.device, dtype=x.dtype) for _ in range(3)]
    per = ln_qkv_sm90_plan(m, c, inner, _sm_count(x.device.index or 0))["per"]
    with torch.cuda.device(x.device):
        err = build.kernel("ln_qkv_sm90")(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            *(o.data_ptr() for o in outs), m, c, inner, per, float(eps), _stream(x),
        )
    build.check(err, "ln_qkv_sm90")
    ln_qkv_sm90.launches += 1
    return tuple(outs)


ln_qkv_sm90.launches = 0  # kernel launches since the last reset


def ln_qkv_f32_sm90_plan(m: int, c: int, inner: int) -> dict:
    """How ln_qkv_sm90.cu runs float32 on x [m, c] with three [inner, c]
    weights: the parts' width (C padded to 64: the scratch xp [m, 2w] and
    wp [3 inner, 2w]), the GEMM's tiles (128 rows x 160 columns, each
    column tile inside one of q, k, v: ceil(inner / 160) per output), its
    ring (3 stages, both parts in a stage) and shared memory, and its grid."""
    tiles = -(-inner // _F32_COLS)
    return {"width": parts_width(c), "bm": _F32_ROWS, "bn": _F32_COLS, "stages": _F32_STAGES,
            "smem_bytes": ring_bytes(_F32_COLS, _F32_STAGES, 2), "col_tiles": 3 * tiles,
            "blocks": 3 * tiles * -(-m // _F32_ROWS)}


def ln_qkv_f32_sm90(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    """Launch ln_qkv_sm90.cu's float32 entry on x [M, C] and its weights,
    contiguous and 16-byte aligned, with the bf16 scratch of the parts:
    xn's [M, 2w] and the three weights' [3 inner, 2w], split at every call
    (an optimizer step changes the weights in place)."""
    m, c = x.shape
    inner = wq.shape[0]
    w = parts_width(c)
    outs = [torch.empty((m, inner), device=x.device, dtype=x.dtype) for _ in range(3)]
    xp, wp = parts_scratch(m, w, x.device), parts_scratch(3 * inner, w, x.device)
    with torch.cuda.device(x.device):
        err = build.kernel("ln_qkv_sm90", "emox_ln_qkv_f32_sm90")(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            *(o.data_ptr() for o in outs), xp.data_ptr(), wp.data_ptr(), m, c, inner, float(eps), _stream(x),
        )
    build.check(err, "ln_qkv_f32_sm90")
    ln_qkv_f32_sm90.launches += 1
    return tuple(outs)


ln_qkv_f32_sm90.launches = 0  # kernel launches since the last reset


def _check_qkv(x, ln_w, ln_b, wq, wk, wv) -> None:
    """The shapes and types the K7 kernels take (no data read)."""
    c = x.shape[-1]
    inner = wq.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ln_qkv takes float32 or bfloat16, got {x.dtype}")
    params = (ln_w, ln_b, wq, wk, wv)
    if any(p.dtype != x.dtype or p.device != x.device for p in params):
        raise TypeError("ln_qkv needs every weight on x's device and in x's type")
    shapes = [tuple(p.shape) for p in params]
    bf16 = x.dtype == torch.bfloat16
    mult = 8 if bf16 else 4  # 16-byte rows
    if shapes != [(c,), (c,)] + [(inner, c)] * 3 or c % mult or inner % mult or (bf16 and c > SM90_MAX_C):
        raise ValueError(f"ln_qkv shapes: x [.., {c}], weights {shapes} (bfloat16: C % 8, C <= {SM90_MAX_C}, "
                         "inner % 8 on ln_qkv_sm90; float32: C % 4, inner % 4 on ln_qkv_f32_sm90)")


def _qkv_kernel(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    """Check the inputs, then launch the kernel of x's type: bf16 ->
    ln_qkv_sm90, float32 -> ln_qkv_f32_sm90."""
    _check_qkv(x, ln_w, ln_b, wq, wk, wv)
    c = x.shape[-1]
    inner = wq.shape[0]
    xm = x.reshape(-1, c).contiguous()
    params = tuple(p.contiguous() for p in (ln_w, ln_b, wq, wk, wv))
    if any(t.data_ptr() % 16 for t in (xm, *params)):
        raise ValueError("ln_qkv needs 16-byte aligned inputs")
    outs = (ln_qkv_sm90 if x.dtype == torch.bfloat16 else ln_qkv_f32_sm90)(xm, *params, eps)
    fused_ln_qkv.launches += 1
    shape = x.shape[:-1] + (inner,)
    return tuple(o.reshape(shape) for o in outs)


def _qkv_plain(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    return tuple(o.contiguous() for o in ln_qkv_plain(x, ln_w, ln_b, wq, wk, wv, eps))


def _qkv_fake(x, ln_w, ln_b, wq, wk, wv, eps: float) -> QKV:
    _check_qkv(x, ln_w, ln_b, wq, wk, wv)
    shape = x.shape[:-1] + (wq.shape[0],)
    return tuple(x.new_empty(shape) for _ in range(3))


_qkv_op = kernel_op("ln_qkv", "(Tensor x, Tensor ln_w, Tensor ln_b, Tensor wq, Tensor wk, Tensor wv, float eps) -> "
                 "(Tensor, Tensor, Tensor)", cpu=_qkv_plain, cuda=_qkv_kernel, fake=_qkv_fake)


class _LnQKV(torch.autograd.Function):
    """Forward: the op emox_torch::ln_qkv (the kernel on CUDA, its plain
    version on CPU). Backward: recompute through ln_qkv_xla and
    differentiate it."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, wk, wv, eps: float):
        out = route(_qkv_op, _on_card_or_cpu("fused_ln_qkv", x), _qkv_kernel, _qkv_plain, x, ln_w, ln_b, wq, wk, wv,
                    eps)
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


fused_ln_qkv.launches = 0  # calls on the card (either kernel) since the last reset
