"""Ring attention over a mesh axis (counterpart of emox/ops/ring.py).

Q/K/V are sharded on the sequence axis over the mesh's `context` axis: each
rank holds its own block. At each of n rotations a rank attends its Q block
against the K/V block it holds, through the port's flash kernel entry with
the lse returned (K1 `flash_attention_nlc` on packed tokens, K5
`flash_attention` on [B, H, L, D]; their plain versions on CPU tensors),
folds the block's (out, lse) into its running result with the online-softmax
merge, and passes K/V to rank (i + 1) mod n of the group. The next
rotation's transfer is posted before the current block's attention runs.
No rank ever holds the whole sequence.

The backward keeps the merged output and the global lse of the forward: at
each rotation the backward kernel (K4 `flash_attention_nlc_bwd`, K5's
`flash_attention_bwd`) gives dq and the held block's dk/dv, exact because
P = exp(q k^T * scale - lse) with the global lse is the block of the whole
softmax and delta = rowsum(dout * out) is the whole row's. The dk/dv partial
sums travel around the ring with their K/V and arrive, complete, at the rank
that owns the block.

Every tensor here is this rank's: the functions take the local blocks and
return the local block of the output. The transfers go by the world's
transport (emox_torch.comm.runtime): card to card under nccl, through
pinned host buffers under gloo with CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from emox_torch.comm.runtime import ring_exchange
from emox_torch.core.mesh import axis_group, axis_rank, axis_size, local_range
from emox_torch.ops.attention import (attention_xla, flash_attention, flash_attention_bwd, flash_attention_nlc,
                                      flash_attention_nlc_bwd)


def _merge(o, lse, o_i, lse_i, heads_view):
    """Online-softmax merge of a block's (o_i, lse_i) into (o, lse): o in
    fp32, per head (heads_view of the block's output)."""
    o_i = heads_view(o_i.float())
    if o is None:
        return o_i, lse_i
    new = torch.logaddexp(lse, lse_i)
    return o * torch.exp(lse - new)[..., None] + o_i * torch.exp(lse_i - new)[..., None], new


class _Ring(torch.autograd.Function):
    """layout "nlc": q [N, Lq, H*D], lse [N, Lq, H] (K1 / K4); "bhld": q
    [B, H, Lq, D], lse [B, H, Lq] (K5)."""

    @staticmethod
    def forward(ctx, q, k, v, layout: str, heads: int, scale: float, group, n: int):
        if layout == "nlc":
            view = lambda t: t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)
            fwd = lambda kk, vv: flash_attention_nlc(q, kk, vv, heads, scale, return_lse=True)
        else:
            view = lambda t: t
            fwd = lambda kk, vv: flash_attention(q, kk, vv, scale, return_lse=True)
        o = lse = None
        kv = [k.contiguous(), v.contiguous()]
        for i in range(n):
            pending = ring_exchange(kv, group) if i < n - 1 else None
            o_i, lse_i = fwd(*kv)
            o, lse = _merge(o, lse, o_i, lse_i, view)
            if pending is not None:
                kv = pending.wait()
        out = o.reshape(q.shape).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout, ctx.heads, ctx.scale, ctx.group, ctx.n = layout, heads, scale, group, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.layout == "nlc":
            bwd = lambda kk, vv: flash_attention_nlc_bwd(q, kk, vv, out, lse, dout, ctx.heads, ctx.scale)
        else:
            bwd = lambda kk, vv: flash_attention_bwd(q, kk, vv, out, lse, dout, ctx.scale)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = [k.contiguous(), v.contiguous()]
        dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for i in range(ctx.n):
            pending = ring_exchange(kv, ctx.group) if i < ctx.n - 1 else None
            dq_i, dk_i, dv_i = bwd(*kv)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
            # the partial sums follow their block: after n passes they are home
            dkv = ring_exchange(dkv, ctx.group).wait()
            if pending is not None:
                kv = pending.wait()
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "context",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention with Q/K/V sequence-sharded over `axis` of `mesh`: q, k, v
    are this rank's [B, H, L/n, D] blocks; returns this rank's block of the
    output. With one rank on the axis, plain attention (attention_xla)."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    n = axis_size(mesh, axis)
    if n == 1:
        return attention_xla(q, k, v, scale)
    return _Ring.apply(q, k, v, "bhld", 0, scale, axis_group(mesh, axis), n)


def ring_frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "context",
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the FRAME axis in the temporal-attention layout:
    q, k, v are this rank's [B, T/n, L, H, D] (the frames sharded over
    `axis`, B this rank's rows of `data`, H its heads of `model`); returns
    this rank's [B, T/n, L, H, D]. Each rotation runs K1 on the packed
    [B*L, T/n, H*D] tokens. With one rank on the axis, the plain dense
    formula of FrameAxisAttention."""
    scale = float(q.shape[-1] ** -0.5) if scale is None else float(scale)
    n = axis_size(mesh, axis)
    b, t, l, h, d = q.shape
    if n == 1:
        s = torch.einsum("bqlhd,bklhd->blhqk", q.float(), k.float()) * scale
        p = torch.softmax(s, dim=-1)
        return torch.einsum("blhqk,bklhd->bqlhd", p.to(v.dtype), v).to(q.dtype)
    pack = lambda x: x.permute(0, 2, 1, 3, 4).reshape(b * l, t, h * d)
    o = _Ring.apply(pack(q), pack(k), pack(v), "nlc", h, scale, axis_group(mesh, axis), n)
    return o.reshape(b, l, t, h, d).permute(0, 2, 1, 3, 4)


def shard_seq(x: torch.Tensor, mesh, axis: str = "context", dim: int = 2) -> torch.Tensor:
    """This rank's block of x's sequence dim over `axis` (raises where the
    length does not divide by the axis size)."""
    sl = local_range(x.shape[dim], axis_size(mesh, axis), axis_rank(mesh, axis), f"sequence axis {dim}")
    return x[(slice(None),) * dim + (sl,)]
