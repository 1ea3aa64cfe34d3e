"""Transformer blocks: spatial, temporal and audio-cross attention
(counterpart of emox/nn/attention_blocks.py).

Attention runs through emox_torch.ops.dot_product_attention_nlc on the
packed [N, L, H*D] token layout (the flash kernel where the reference takes
its Pallas kernel), with the reference's attention impl: the `impl` a caller
passes to forward (the UNet passes "xla" for a config with
flash_attention=False), else Attention(impl=...), else EMOX_ATTENTION_IMPL
or attention_default_impl(). Every transformer feed-forward sub-layer runs
through emox_torch.ops.fused_ln_geglu_ff (the fused LN + GEGLU + residual
kernel).
The FF impl is the reference's: GEGLUFeedForward(impl=...) or EMOX_FF_IMPL
("auto" / "fused": the kernels; "xla": the plain formulas; "fused_interpret":
the kernels' plain versions). GEGLUFeedForward called on its own goes
through emox_torch.ops.geglu_ff (K6 where the impl is not "xla").

The reference's two opt-in fused projections keep their switches, off
by default as there:

  * EMOX_LN_QKV: every bias-free self-attention (`attn1` of each
    TransformerBlock without sparse-causal K/V, and each temporal
    attention) takes q, k and v from emox_torch.ops.fused_ln_qkv, the fused
    LayerNorm + projection kernel, on the raw tokens;
  * EMOX_FUSED_QKV: every other self-attention projects q, k and v with one
    matmul over the concatenated weights (plain PyTorch).

With sparse-causal attention (model.use_sparse_causal) each frame's
self-attention takes its keys and values from the normed tokens of the
clip's first frame and of the frame before it (`sc_gather`), the reference
tokens appended; a batch with per-row reference dropout then runs the
attention with and without the reference tokens and selects per row, as
the reference does.

Under a mesh (emox_torch.core.mesh) the temporal attention of a model whose
frames are sharded over `context` runs as ring attention
(emox_torch.ops.ring), with the positional rows of this rank's frames, and
sparse-causal attention takes the first and previous frames it lacks from
the other context ranks (emox_torch.comm.halo). A call whose clips are
whole on every context rank (`whole_clip`: frames that do not divide by the
context size) runs the one-rank formulas. Under tensor parallelism
(emox_torch.comm.sharding) each attention works on its rank's heads and
each FF sub-layer of a TransformerBlock on its rank's features.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.comm.halo import first_frame, previous_frame
from emox_torch.comm.sharding import attend_heads
from emox_torch.core.mesh import axis_group, axis_rank, axis_size
from emox_torch.nn.blocks import FusedGroupNorm
from emox_torch.nn.embeddings import sinusoidal_positions
from emox_torch.nn.layers import Dense, LayerNorm
from emox_torch.ops.attention import dot_product_attention_nlc
from emox_torch.ops.ff import ff_default_impl, fused_ln_geglu_ff, geglu_ff, ln_geglu_ff_plain
from emox_torch.ops.ln_qkv import _ln_qkv_enabled, fused_ln_qkv
from emox_torch.ops.ring import ring_frame_attention

QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _fused_qkv_enabled() -> bool:
    """EMOX_FUSED_QKV: opt-in, off unless set to something other than "" or "0"."""
    return os.environ.get("EMOX_FUSED_QKV", "") not in ("", "0")


def _fused_qkv_apply(denses, x: torch.Tensor) -> QKV:
    """q, k, v from one matmul over the row-concatenated [Wq; Wk; Wv] (and
    biases): each output column is the same contraction as in the separate
    projections. Under tensor parallelism, this rank's rows of each."""
    w = torch.cat([d.weight for d in denses])
    tp = denses[0].tp
    bias = None if denses[0].bias is None else torch.cat(
        [d.bias if tp is None else tp.local_bias(d.bias) for d in denses])
    x = x.to(w.dtype)
    if tp is not None:
        x = tp.shard.copy_to(x)
    return F.linear(x, w, bias).chunk(3, dim=-1)


class Attention(nn.Module):
    """Multi-head attention over token sequences [N, L, C].

    context=None -> self-attention. `extra_kv` tokens (reference-image
    features) are appended to K/V only. impl: the reference's attention impl
    names, None = the dispatcher's default."""

    # under tensor parallelism where the heads do not divide: the model axis
    # (emox_torch.comm.sharding.ModelShard) that q, k and v are gathered over
    tp_gather = None

    def __init__(self, query_dim: int, heads: int, head_dim: int, out_dim: Optional[int] = None,
                 context_dim: Optional[int] = None, zero_init_out: bool = False,
                 qkv_bias: bool = False, impl: Optional[str] = None):
        super().__init__()
        self.heads = heads
        self.impl = impl
        inner = heads * head_dim
        context_dim = context_dim or query_dim
        self.to_q = Dense(query_dim, inner, bias=qkv_bias)
        self.to_k = Dense(context_dim, inner, bias=qkv_bias)
        self.to_v = Dense(context_dim, inner, bias=qkv_bias)
        self.to_out = Dense(inner, out_dim or query_dim, zero_init=zero_init_out)

    def forward(self, x: Optional[torch.Tensor], context: Optional[torch.Tensor] = None,
                extra_kv: Optional[torch.Tensor] = None, extra_tile: int = 1,
                extra_drop: Optional[torch.Tensor] = None, context_tile: int = 1,
                qkv: Optional[QKV] = None, impl: Optional[str] = None) -> torch.Tensor:
        """extra_kv tokens are projected once and then repeated extra_tile x
        along the batch axis (identical for every frame of a clip).
        extra_drop rows put the row's own projected tokens in place of the
        extra ones: softmax over duplicated tokens equals plain
        self-attention, so one program serves the CFG uncond half.
        qkv: self-attention projections computed upstream (the fused LN +
        q/k/v kernel); x is then not read and may be None. impl, where given,
        takes the place of the module's."""
        if qkv is not None:
            if context is not None:  # not assert: must survive python -O
                raise ValueError("qkv bypass is a self-attention path (context must be None)")
            q, k, v = qkv
        elif context is None and _fused_qkv_enabled():
            q, k, v = _fused_qkv_apply((self.to_q, self.to_k, self.to_v), x)
        else:
            ctx = x if context is None else context
            q = self.to_q(x)
            k = self.to_k(ctx)
            v = self.to_v(ctx)
        if context is not None and context_tile > 1:
            k = k.repeat_interleave(context_tile, dim=0)
            v = v.repeat_interleave(context_tile, dim=0)
        if extra_kv is not None:
            ke = self.to_k(extra_kv)
            ve = self.to_v(extra_kv)
            if extra_tile > 1:
                ke = ke.repeat_interleave(extra_tile, dim=0)
                ve = ve.repeat_interleave(extra_tile, dim=0)
            if extra_drop is not None:
                if k.shape[1] != ke.shape[1]:
                    raise ValueError(
                        f"extra_drop substitutes the row's own tokens for the extra tokens, which "
                        f"needs equal token counts: self {k.shape[1]} != extra {ke.shape[1]}"
                    )
                drop = extra_drop[:, None, None]
                ke = torch.where(drop, k, ke)
                ve = torch.where(drop, v, ve)
            k = torch.cat([k, ke], dim=1)
            v = torch.cat([v, ve], dim=1)
        attend = lambda q, k, v: dot_product_attention_nlc(q, k, v, self.heads, impl=impl or self.impl)
        return self.to_out(attend_heads(self.tp_gather, attend, q, k, v))


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP: proj_in to 2*mult*dim, value * gelu(gate), proj_out.

    impl: the reference's FF impl names, None = ff_default_impl()
    (EMOX_FF_IMPL, else "auto" with a CUDA card and "xla" without). Anything
    but "xla" goes through emox_torch.ops.geglu_ff (K6 on CUDA tensors); the
    parameters are the same on every path."""

    def __init__(self, dim: int, mult: int = 4, impl: Optional[str] = None):
        super().__init__()
        self.impl = impl
        self.proj_in = Dense(dim, dim * mult * 2)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under tensor parallelism: the FF alone on this rank's features,
        b2 added on the model axis's rank 0 only, then the all-reduce."""
        impl = self.impl or ff_default_impl()
        x = x.to(self.proj_in.weight.dtype)
        tp = self.proj_in.tp
        if tp is None:
            return geglu_ff(x, self.proj_in.weight, self.proj_in.bias, self.proj_out.weight, self.proj_out.bias,
                            impl=impl)
        b2 = self.proj_out.bias if tp.shard.rank == 0 else torch.zeros_like(self.proj_out.bias)
        y = geglu_ff(tp.shard.copy_to(x), self.proj_in.weight, tp.local_bias(self.proj_in.bias),
                     self.proj_out.weight, b2, impl=impl)
        return tp.shard.reduce_from(y)


def _maybe_ln_qkv(ln_mod: LayerNorm, attn_mod: nn.Module, x: torch.Tensor) -> Optional[QKV]:
    """(q, k, v) of attn_mod's self-attention on LN(x), from the fused LN +
    q/k/v kernel on the raw tokens x, when EMOX_LN_QKV is on and the
    projections have no bias; else None (the caller normalises and
    projects). Every such site takes the kernel: the reference's TPU
    VMEM plan does not carry over."""
    if not _ln_qkv_enabled() or attn_mod.to_q.bias is not None:
        return None
    w = attn_mod.to_q.weight
    x = x.to(w.dtype)
    if attn_mod.to_q.tp is not None:
        x = attn_mod.to_q.tp.shard.copy_to(x)
    return fused_ln_qkv(x, ln_mod.weight, ln_mod.bias, w, attn_mod.to_k.weight,
                        attn_mod.to_v.weight, eps=ln_mod.eps)


def _ff_sublayer(ln_mod: LayerNorm, ff_mod: GEGLUFeedForward, x: torch.Tensor) -> torch.Tensor:
    """x + FF(LN(x)) by the FF module's impl, else EMOX_FF_IMPL, as the
    reference's sub-layer: "xla" is the plain LayerNorm and GEGLU; "auto" and
    "fused" the fused LN + GEGLU + residual op (the kernel on CUDA tensors at
    every site, its plain version on CPU tensors); "fused_interpret" that
    plain version on any device. With neither set the sub-layer takes the
    fused op on every device, as it always has: the reference's CPU default
    ("xla") exists there because its kernels only interpret off the TPU.
    Under tensor parallelism: LN(x) in full, then the FF module's sharded
    path (K6 on this rank's features), then the residual."""
    impl = ff_mod.impl or os.environ.get("EMOX_FF_IMPL") or "auto"
    if impl == "xla" or ff_mod.proj_in.tp is not None:
        return x + ff_mod(ln_mod(x))
    fused = {"auto": fused_ln_geglu_ff, "fused": fused_ln_geglu_ff, "fused_interpret": ln_geglu_ff_plain}.get(impl)
    if fused is None:
        raise ValueError(f"unknown ff impl {impl!r}")
    return fused(
        x.to(ff_mod.proj_in.weight.dtype), ln_mod.weight, ln_mod.bias,
        ff_mod.proj_in.weight, ff_mod.proj_in.bias, ff_mod.proj_out.weight, ff_mod.proj_out.bias,
        eps=ln_mod.eps,
    )


class TransformerBlock(nn.Module):
    """self-attn (+ref K/V) -> cross-attn (text context) -> GEGLU FF, each
    pre-LayerNormed with residuals."""

    def __init__(self, dim: int, heads: int, head_dim: int, use_cross: bool = True,
                 cross_dim: Optional[int] = None):
        super().__init__()
        self.use_cross = use_cross
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        if use_cross:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim=cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                ref_kv: Optional[torch.Tensor] = None, ref_drop: Optional[torch.Tensor] = None,
                ref_tile: int = 1, ctx_tile: int = 1, emit_bank: bool = True,
                impl: Optional[str] = None, sc_frames: int = 0, sc_group=None):
        """ref_kv [B, Lr, C] UNREPEATED writer tokens; ref_drop [N] bool
        (True = this row sees no reference); impl: both attentions' impl;
        sc_frames > 0: sparse-causal self-attention over clips of that many
        frames (sc_gather; with sc_group, this rank's frames of clips split
        over that context group). Returns (x, normed1): normed1 is
        what a ReferenceNet writer banks for the reader. Under EMOX_LN_QKV
        the self-attention reads the fused LN + q/k/v kernel, and normed1 is
        computed only with emit_bank (None otherwise): the reference leaves
        an unused bank to dead-code elimination. Sparse-causal K/V skip the
        fused projections: they read other frames' tokens."""
        if sc_frames > 0:
            normed1 = self.norm1(x)
            sc_kv = sc_gather(normed1, sc_frames, sc_group)
            if ref_kv is not None and ref_drop is not None:
                # the K/V base [first, prev] is longer than the reference bank, so
                # the duplication trick cannot say "no reference": both branches
                # run for every row, and each row takes its own
                with_ref = self.attn1(normed1, context=sc_kv, extra_kv=ref_kv, extra_tile=ref_tile, impl=impl)
                without = self.attn1(normed1, context=sc_kv, impl=impl)
                x = x + torch.where(ref_drop[:, None, None], without, with_ref)
            else:
                x = x + self.attn1(normed1, context=sc_kv, extra_kv=ref_kv, extra_tile=ref_tile, impl=impl)
        else:
            qkv1 = _maybe_ln_qkv(self.norm1, self.attn1, x)
            normed1 = self.norm1(x) if qkv1 is None or emit_bank else None
            x = x + self.attn1(normed1, extra_kv=ref_kv, extra_tile=ref_tile,
                               extra_drop=ref_drop if ref_kv is not None else None, qkv=qkv1, impl=impl)
        if self.use_cross and context is not None:
            x = x + self.attn2(self.norm2(x), context=context, context_tile=ctx_tile, impl=impl)
        return _ff_sublayer(self.norm3, self.ff, x), normed1


def sc_gather(tokens: torch.Tensor, t: int, group=None) -> torch.Tensor:
    """Sparse-causal K/V tokens: [(B T), L, C] -> [(B T), 2L, C], each
    frame's row the clip's first frame's tokens, then the previous frame's
    (frame 0 sees itself twice). With `group` (a context axis's), the T
    frames are this rank's block of clips split over the group: the first
    frame comes from its rank 0 and the one before the block from the rank
    before (emox_torch.comm.halo)."""
    bt, l, c = tokens.shape
    v = tokens.reshape(bt // t, t, l, c)
    if group is None:
        first, before = v[:, :1], v[:, :1]
    else:
        first = first_frame(v[:, 0], group)[:, None]
        before = previous_frame(v[:, -1], v[:, 0], group)[:, None]
    prev = torch.cat([before, v[:, :-1]], dim=1)
    return torch.cat([first.expand_as(v), prev], dim=2).reshape(bt, 2 * l, c)


class SpatialTransformer(nn.Module):
    """GN -> linear proj -> TransformerBlocks over H*W tokens -> proj + residual.

    sparse_causal: self-attention over the first and previous frames'
    tokens (sc_gather) when a call's clips have more than one frame; with
    `ring_mesh` set (set_ring) and its `ring_axis` of more than one rank, a
    call's frames are this rank's block of its clips'."""

    ring_mesh, ring_axis = None, "context"

    def __init__(self, channels: int, heads: int, head_dim: int, depth: int = 1, groups: int = 32,
                 use_cross: bool = True, cross_dim: Optional[int] = None,
                 sparse_causal: bool = False):
        super().__init__()
        self.sparse_causal = sparse_causal
        self.depth = depth
        self.norm = FusedGroupNorm(channels, groups)
        self.proj_in = Dense(channels, channels)
        for i in range(depth):
            setattr(self, f"block_{i}", TransformerBlock(channels, heads, head_dim, use_cross, cross_dim))
        self.proj_out = Dense(channels, channels)

    def set_ring(self, mesh, axis: str = "context") -> None:
        """Sparse-causal frames exchanged over `axis` of `mesh` (None: off)."""
        self.ring_mesh, self.ring_axis = mesh, axis

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                ref_kv: Optional[List[torch.Tensor]] = None, ref_drop: Optional[torch.Tensor] = None,
                num_frames: int = 1, emit_bank: bool = True, impl: Optional[str] = None,
                whole_clip: bool = False):
        """x [(B T), H, W, C]; context [B, Lc, Cc] and ref_kv (per depth block
        [B, Lr, C]) UNREPEATED per clip, repeated num_frames x inside;
        ref_drop [(B T)] bool. emit_bank=False: the caller reads no bank
        (see TransformerBlock). impl: every attention's impl. whole_clip: the
        T frames are whole clips although the module is on a ring."""
        n, h, w, c = x.shape
        t = num_frames
        hdn = self.proj_in(self.norm(x).reshape(n, h * w, c))
        group = None
        if self.sparse_causal and not whole_clip:
            group = axis_group(self.ring_mesh, self.ring_axis)
        sc_frames = t if self.sparse_causal and (t > 1 or group is not None) else 0
        banks = []
        for i in range(self.depth):
            hdn, normed1 = getattr(self, f"block_{i}")(
                hdn, context=context, ref_kv=None if ref_kv is None else ref_kv[i],
                ref_drop=ref_drop, ref_tile=t, ctx_tile=t, emit_bank=emit_bank, impl=impl, sc_frames=sc_frames,
                sc_group=group,
            )
            banks.append(normed1)
        return x + self.proj_out(hdn).reshape(n, h, w, c), banks


class FrameAxisAttention(nn.Module):
    """Multi-head attention over the frame axis of [B, T, L, C] tokens,
    with the spatial axis L as a batch dimension of the einsums (fp32
    scores, as the reference).

    With `ring_mesh` set and its `ring_axis` of more than one rank, the T
    frames of a call are this rank's block of the clip's and the attention
    runs as ring attention over that axis (ring_frame_attention: K1 at each
    rotation, K4 in its backward); a call with whole_clip runs the dense
    formula on the whole clip, as the reference does where the frames do not
    divide by the ring."""

    tp_gather = None  # as Attention's
    ring_mesh, ring_axis = None, "context"  # set by TemporalTransformer.set_ring

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads = heads
        self.head_dim = head_dim
        inner = heads * head_dim
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.to_out = Dense(inner, dim)

    def forward(self, x: Optional[torch.Tensor], qkv: Optional[QKV] = None, whole_clip: bool = False) -> torch.Tensor:
        """qkv: projections from the fused LN + q/k/v kernel; x is then not
        read and may be None."""
        mesh = None if whole_clip else self.ring_mesh
        if qkv is None:
            qkv = (_fused_qkv_apply((self.to_q, self.to_k, self.to_v), x) if _fused_qkv_enabled()
                   else (self.to_q(x), self.to_k(x), self.to_v(x)))
        def attend(q, k, v):
            b, t, l, _ = q.shape
            split = lambda y: y.reshape(b, t, l, self.heads, self.head_dim)
            o = ring_frame_attention(split(q), split(k), split(v), mesh, self.ring_axis,
                                     scale=self.head_dim ** -0.5)
            return o.reshape(b, t, l, self.heads * self.head_dim)

        return self.to_out(attend_heads(self.tp_gather, attend, *qkv))


class TemporalTransformer(nn.Module):
    """Attention across frames per spatial location, zero-init output
    (identity at init). Input [B, T, H, W, C]."""

    def __init__(self, channels: int, heads: int, head_dim: int, depth: int = 1, max_len: int = 24):
        super().__init__()
        self.depth = depth
        self.max_len = max_len
        self.norm_in = LayerNorm(channels)
        for i in range(depth):
            setattr(self, f"norm_{i}", LayerNorm(channels))
            setattr(self, f"attn_{i}", FrameAxisAttention(channels, heads, head_dim))
            setattr(self, f"norm_ff_{i}", LayerNorm(channels))
            setattr(self, f"ff_{i}", GEGLUFeedForward(channels))
        self.proj_out = Dense(channels, channels, zero_init=True)

    def set_ring(self, mesh, axis: str = "context") -> None:
        """Ring attention over `axis` of `mesh` at every depth (None: off)."""
        for i in range(self.depth):
            attn = getattr(self, f"attn_{i}")
            attn.ring_mesh, attn.ring_axis = mesh, axis

    def forward(self, x: torch.Tensor, whole_clip: bool = False) -> torch.Tensor:
        """x: the clip's frames, or under the ring this rank's block of
        them, which takes the positional rows of its own frames; with
        whole_clip the whole clip on every rank of the ring."""
        b, t, h, w, c = x.shape
        attn0 = getattr(self, "attn_0")
        n = 1 if whole_clip else axis_size(attn0.ring_mesh, attn0.ring_axis)
        start = 0 if n == 1 else axis_rank(attn0.ring_mesh, attn0.ring_axis) * t
        if start + t > self.max_len:
            raise ValueError(f"frames {start}..{start + t} past the positional table's {self.max_len}")
        pe = sinusoidal_positions(self.max_len, c, device=x.device)[start:start + t].to(x.dtype)
        tokens = self.norm_in(x.reshape(b, t, h * w, c)) + pe[None, :, None, :]
        for i in range(self.depth):
            norm, attn = getattr(self, f"norm_{i}"), getattr(self, f"attn_{i}")
            qkv = _maybe_ln_qkv(norm, attn, tokens)
            tokens = tokens + attn(None if qkv is not None else norm(tokens), qkv=qkv, whole_clip=whole_clip)
            tokens = _ff_sublayer(getattr(self, f"norm_ff_{i}"), getattr(self, f"ff_{i}"), tokens)
        return x + self.proj_out(tokens).reshape(b, t, h, w, c)


class AudioCrossAttention(nn.Module):
    """Per-frame cross-attention: latent tokens (Q) -> audio window (K/V).
    x [B, T, H, W, C], audio [B, T, A, Ca]; zero-init output projection."""

    def __init__(self, channels: int, heads: int, head_dim: int, audio_dim: int):
        super().__init__()
        self.norm = LayerNorm(channels)
        self.attn = Attention(channels, heads, head_dim, context_dim=audio_dim, zero_init_out=True)

    def forward(self, x: torch.Tensor, audio: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
        b, t, h, w, c = x.shape
        _, _, a, ca = audio.shape
        tokens = self.norm(x.reshape(b * t, h * w, c))
        out = self.attn(tokens, context=audio.reshape(b * t, a, ca).to(tokens.dtype), impl=impl)
        return x + out.reshape(b, t, h, w, c)
