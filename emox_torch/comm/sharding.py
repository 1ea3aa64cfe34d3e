"""Sharding rules for the (data, context, model) mesh (counterpart of
emox/comm/sharding.py).

  * data    - the batch axis of every batch tensor (DP): a rank keeps its rows.
  * context - the video-frame axis (sequence parallelism): a rank keeps its
    frames, and the temporal attention runs as ring attention.
  * model   - tensor parallelism (TP) by the reference's path patterns, in
    the port's parameter names (its flax names, '.'-joined, `weight` for
    `kernel`): the projections whose output features shard over `model`
    (column-parallel: to_q, to_k, to_v, ff.proj_in, ff1) and those whose
    input features do (row-parallel: to_out, ff.proj_out, ff2); every other
    leaf, and any leaf whose dimension does not divide by the model size,
    is replicated. A column-parallel layer's bias is replicated as in the
    reference's plan; each rank adds its own slice of it.

Where GSPMD inserts the collectives for the reference, the port calls them
(`apply_tensor_parallel`): a column-parallel layer's input passes through
`ModelShard.copy_to` (identity forward, all-reduce of the gradient), a
row-parallel layer's product through `ModelShard.reduce_from` (all-reduce
forward, identity backward) before its bias is added, once. Attention under
TP splits heads: each rank attends with its own heads. A module whose heads
do not divide by the model size (the VAE's single-head mid-attention)
gathers q, k and v over `model` and attends with every head, then keeps its
slice of the output for the row-parallel out projection. GEGLU's proj_in
[2F, C] = [a | g] shards a and g alike: a rank's slice is a's rows
r*F/m..(r+1)*F/m and the same rows of g. The GEGLU FF under TP is LN(x) in
full on every rank, then the FF alone on the rank's shard (K6 through
emox_torch.ops.geglu_ff, with b2 on rank 0 only), then the all-reduce, then
the residual.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from emox_torch.comm.runtime import all_gather, all_reduce_
from emox_torch.core.mesh import BatchShard, MeshAxes, Spec, axis_group, axis_rank, axis_size, batch_spec, local_range

# weights whose OUTPUT features shard over `model` (the port's weight is [out, in])
_TP_OUT_PATTERNS = (
    r"to_q\.weight$", r"to_k\.weight$", r"to_v\.weight$",
    r"(^|\.)ff\.proj_in\.weight$", r"ff1\.weight$",
)
# weights whose INPUT features shard over `model` (row-parallel: the product is all-reduced)
_TP_IN_PATTERNS = (
    r"to_out\.weight$", r"(^|\.)ff\.proj_out\.weight$", r"ff2\.weight$",
)


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Iterable[Tuple[str, torch.Tensor]]:
    return params.named_parameters() if isinstance(params, nn.Module) else params.items()


def param_shardings(params: Union[nn.Module, Mapping[str, torch.Tensor]], mesh) -> Dict[str, Spec]:
    """{parameter name: spec} (MeshAxes.MODEL at the sharded dim of the
    port's layout, None elsewhere) by the TP rules; every leaf replicated
    without a model axis."""
    model_size = axis_size(mesh, MeshAxes.MODEL)
    out = {}
    for name, leaf in _named(params):
        spec = [None] * leaf.dim()
        if model_size > 1 and leaf.dim() >= 2:
            if any(re.search(p, name) for p in _TP_OUT_PATTERNS) and leaf.shape[0] % model_size == 0:
                spec[0] = MeshAxes.MODEL
            elif any(re.search(p, name) for p in _TP_IN_PATTERNS) and leaf.shape[1] % model_size == 0:
                spec[1] = MeshAxes.MODEL
        out[name] = tuple(spec)
    return out


# batch keys that carry a frame axis at dim 1
_FRAME_KEYS = {"frames", "speeds"}


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of a host batch (BatchShard.take), as host tensors:
    rows over data, and the frame axis of `frames` and `speeds` over context
    where it divides (else each context rank keeps every frame, as the
    reference's)."""
    shard = BatchShard.of(mesh)

    def put(key, arr):
        x = torch.as_tensor(np.asarray(arr))
        frame_axis = 1 if key in _FRAME_KEYS and x.dim() >= 2 and shard.frames_split(x.shape[1]) else None
        return shard.take(x, frame_axis)

    return {k: put(k, v) for k, v in batch.items()}


def with_context_sharding(x: torch.Tensor, mesh, frame_axis: int = 1) -> torch.Tensor:
    """This rank's block under batch_spec(x.dim(), frame_axis) of a
    whole-clip activation (the reference's sharding constraint, kept as a
    slice); x itself without a context axis."""
    shard = BatchShard.of(mesh)
    return x if shard.ctx_size <= 1 else shard.take(x, frame_axis)


# ---- the model axis's collectives, as autograd functions ----------------------------------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.width, ctx.rank = x.shape[-1], rank
        return all_gather(x.contiguous(), group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width], None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group = group
        w = x.shape[-1] // size
        return x[..., rank * w:(rank + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, dim=-1), None, None, None


class ModelShard:
    """This rank's place on the model axis: its group, index and the axis size."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def copy_to(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce_from(self, x):
        return _ReduceFromModel.apply(x, self.group)

    def gather(self, x):
        """x's last dim gathered over the model axis (backward: this rank's slice)."""
        return _GatherFromModel.apply(x, self.group, self.rank)

    def split(self, x):
        """This rank's slice of x's last dim (backward: the gradient gathered)."""
        return _SplitToModel.apply(x, self.group, self.rank, self.size)

    def rows(self, n: int, interleave: bool = False) -> torch.Tensor:
        """This rank's indices of n sharded rows: a contiguous slice, or with
        interleave the same slice of each half (GEGLU's [a | g])."""
        if not interleave:
            return torch.arange(n)[local_range(n, self.size, self.rank)]
        half = torch.arange(n // 2)[local_range(n // 2, self.size, self.rank, "GEGLU half")]
        return torch.cat([half, half + n // 2])


def attend_heads(shard: Optional[ModelShard], attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """attend(q, k, v). With `shard` (set on an attention module whose heads
    do not divide by the model axis) on every head: q, k and v gathered over
    the model axis, and this rank's slice of the output's last dim kept for
    the row-parallel out projection."""
    if shard is None:
        return attend(q, k, v)
    return shard.split(attend(*(shard.gather(t) for t in (q, k, v))))


class DenseShard:
    """The TP role of one Dense: "column" (output features sharded; the
    replicated bias sliced at use by this rank's index, kept on `device`)
    or "row" (input features sharded; the product all-reduced, then the
    bias added)."""

    def __init__(self, kind: str, shard: ModelShard, out_features: int, interleave: bool = False,
                 device: Optional[torch.device] = None):
        self.kind, self.shard, self.interleave = kind, shard, interleave
        self.index = shard.rows(out_features, interleave).to(device) if kind == "column" else None

    def local_bias(self, bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if bias is None or self.kind != "column":
            return bias
        return bias[self.index]

    def linear(self, dense: nn.Module, x: torch.Tensor) -> torch.Tensor:
        x = x.to(dense.weight.dtype)
        if self.kind == "column":
            return F.linear(self.shard.copy_to(x), dense.weight, self.local_bias(dense.bias))
        y = self.shard.reduce_from(F.linear(x, dense.weight))
        return y if dense.bias is None else y + dense.bias


class TensorParallel:
    """The TP plan applied to one model: the sharded parameters' specs, and
    the replicated leaves whose gradient each rank computes only in part (a
    column-parallel bias, GEGLU's b2), which the trainer all-reduces over
    `model`."""

    def __init__(self, plan: Dict[str, Spec], shard: ModelShard, partial: Set[str], interleaved: Set[str]):
        self.plan = {n: s for n, s in plan.items() if MeshAxes.MODEL in s}
        self.shard, self.partial, self.interleaved = shard, partial, interleaved

    def is_sharded(self, name: str) -> bool:
        return name in self.plan

    def local(self, name: str, full: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """This rank's shard of a whole parameter (itself if replicated), or
        of a tensor laid out along the parameter's split at its own `dim` (an
        optimizer moment)."""
        if name not in self.plan:
            return full
        dim = self.plan[name].index(MeshAxes.MODEL) if dim is None else dim
        idx = self.shard.rows(full.shape[dim], name in self.interleaved).to(full.device)
        return full.index_select(dim, idx)

    def full(self, name: str, local: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """The whole parameter from every rank's shard (a collective over
        `model`: every rank calls it for the same names), or the whole of a
        tensor split as `local` does at its own `dim`."""
        if name not in self.plan:
            return local
        dim = self.plan[name].index(MeshAxes.MODEL) if dim is None else dim
        moved = local.movedim(dim, -1).contiguous()
        if name in self.interleaved:
            a, g = moved.chunk(2, dim=-1)
            whole = torch.cat([all_gather(a.contiguous(), self.shard.group), all_gather(g.contiguous(), self.shard.group)],
                              dim=-1)
        else:
            whole = all_gather(moved, self.shard.group)
        return whole.movedim(-1, dim).contiguous()


def _heads_modules():
    from emox_torch.models.clip import CLIPAttention
    from emox_torch.nn.attention_blocks import Attention, FrameAxisAttention

    return (Attention, FrameAxisAttention, CLIPAttention)


def apply_tensor_parallel(modules: nn.Module, mesh) -> Optional[TensorParallel]:
    """Shard `modules` in place by param_shardings over the mesh's model
    axis: each sharded weight replaced by this rank's slice, each Dense
    given its DenseShard, each attention its local heads (or, where heads do
    not divide, the gather of q, k and v). None without a model axis.
    Raises where a sharded leaf sits in a module with no TP path."""
    size = axis_size(mesh, MeshAxes.MODEL)
    if size == 1:
        return None
    from emox_torch.nn.attention_blocks import GEGLUFeedForward
    from emox_torch.nn.layers import Dense

    shard = ModelShard(axis_group(mesh, MeshAxes.MODEL), axis_rank(mesh, MeshAxes.MODEL), size)
    plan = param_shardings(modules, mesh)
    partial: Set[str] = set()
    interleaved: Set[str] = set()
    mods = dict(modules.named_modules())
    parent_of = lambda name: name.rsplit(".", 1)[0] if "." in name else ""
    handled: Set[str] = set()
    for name, mod in mods.items():
        if isinstance(mod, GEGLUFeedForward) and MeshAxes.MODEL in plan[f"{name}.proj_in.weight"]:
            if MeshAxes.MODEL not in plan[f"{name}.proj_out.weight"]:
                raise ValueError(f"{name}: proj_in shards over model {size} but proj_out's {mod.proj_out.weight.shape[1]} "
                                 "features do not divide")
            interleaved.add(f"{name}.proj_in.weight")
            partial.update({f"{name}.proj_in.bias", f"{name}.proj_out.bias"})
            handled.update({f"{name}.proj_in", f"{name}.proj_out"})
        elif isinstance(mod, _heads_modules()) and MeshAxes.MODEL in plan[f"{name}.to_q.weight"]:
            if mod.heads % size == 0:
                mod.heads //= size
            else:
                mod.tp_gather = shard
            handled.update(f"{name}.{p}" for p in ("to_q", "to_k", "to_v", "to_out"))
    tp = TensorParallel(plan, shard, partial, interleaved)
    with torch.no_grad():
        for name, mod in mods.items():
            if not isinstance(mod, Dense) or f"{name}.weight" not in tp.plan:
                continue
            parent = mods[parent_of(name)]
            if name not in handled and not (name.endswith(("ff1", "ff2")) and type(parent).__name__ == "EncoderLayer"):
                raise ValueError(f"{name} shards over model {size}, but {type(parent).__name__} has no TP path")
            kind = "column" if tp.plan[f"{name}.weight"][0] == MeshAxes.MODEL else "row"
            mod.tp = DenseShard(kind, shard, mod.weight.shape[0], f"{name}.weight" in interleaved, mod.weight.device)
            if kind == "column" and mod.bias is not None:
                partial.add(f"{name}.bias")
            local = tp.local(f"{name}.weight", mod.weight.detach())
            mod.weight = nn.Parameter(local.clone(), requires_grad=mod.weight.requires_grad)
    return tp


def model_reduce_grads(tp: Optional[TensorParallel], names: Sequence[str], grads: List[torch.Tensor]) -> None:
    """All-reduce over `model`, in place, the gradients of the replicated
    leaves each rank computes in part (column-parallel biases, GEGLU's b2)."""
    if tp is None:
        return
    from emox_torch.comm.runtime import coalesced

    part = [g for n, g in zip(names, grads) if n in tp.partial]
    if part:
        coalesced(part, lambda flat: all_reduce_(flat, tp.shard.group))
