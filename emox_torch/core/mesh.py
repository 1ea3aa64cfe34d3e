"""The device mesh: data x context x model over the world's ranks
(counterpart of emox/core/mesh.py).

`create_mesh` lays the ranks of the torch.distributed world out as a
torch.distributed.device_mesh.DeviceMesh whose dims are named by
MeshConfig.axis_names; dim i plays role MeshAxes.ALL[i], whatever its name:

  data    - batch sharding (DP): each rank holds its rows of a batch;
  context - the video-frame axis (sequence parallelism): each rank holds its
            frames, and the temporal attention runs as ring attention
            (emox_torch.ops.ring);
  model   - tensor parallelism over attention heads and MLP features
            (emox_torch.comm.sharding).

The shape follows the reference's rules (`mesh_shape`, a pure function): a
-1 absorbs the ranks the fixed axes leave, a mesh smaller than the world
takes its first ranks (the others stand outside it), and a mesh that needs
more ranks than the world has raises. A process that never initialised
torch.distributed is a world of one rank with no process group: there
`create_mesh` checks the shape and returns None, which every helper here
reads as a mesh of 1 x 1 x 1.

Where the reference device-puts a host array with a sharding, a rank here
keeps its own block of the host array (`BatchShard`, through `put_batch`
and emox_torch.comm.sharding's `shard_batch`); where it replicates a param
tree, the mesh's first rank's values are broadcast
(`shard_params_replicated`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from emox_torch.core.config import MeshConfig

Mesh = Optional[DeviceMesh]
Spec = Tuple[Optional[str], ...]  # per tensor dim: the mesh axis it is sharded over, or None


class MeshAxes:
    DATA = "data"
    CONTEXT = "context"
    MODEL = "model"
    ALL = (DATA, CONTEXT, MODEL)


def mesh_shape(cfg: MeshConfig, num_ranks: int) -> Tuple[Tuple[int, int, int], int]:
    """(sizes, ranks used) of cfg's mesh over num_ranks ranks: a -1 axis
    absorbs what the fixed axes leave; a smaller mesh takes the first ranks."""
    sizes = [cfg.data, cfg.context, cfg.model]
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if n_free == 1:
        if num_ranks % fixed != 0:
            raise ValueError(f"{num_ranks} devices not divisible by fixed axes product {fixed}")
        sizes[sizes.index(-1)] = num_ranks // fixed
    elif fixed > num_ranks:
        raise ValueError(f"mesh {sizes} needs {fixed} devices, have {num_ranks}")
    return tuple(sizes), math.prod(sizes)


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The (data, context, model) DeviceMesh over the world's first ranks,
    its dims named cfg.axis_names; None in a process without a process group
    (after checking that the mesh fits one rank). Its device type is the
    backend's: cuda under nccl, cpu under gloo."""
    cfg = cfg or MeshConfig()
    if len(cfg.axis_names) != 3 or len(set(cfg.axis_names)) != 3:
        raise ValueError(f"mesh.axis_names must name three distinct axes, got {cfg.axis_names}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes, used = mesh_shape(cfg, world)
    if not dist.is_initialized():
        return None
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(used).reshape(sizes), mesh_dim_names=tuple(cfg.axis_names))
    # the gradient reductions' group over two dims, made here, where every
    # rank of the world takes part, even those outside a mesh smaller than it
    if axis_size(mesh, MeshAxes.DATA) > 1 and axis_size(mesh, MeshAxes.CONTEXT) > 1:
        axes_group(mesh, (MeshAxes.DATA, MeshAxes.CONTEXT))
    return mesh


def local_mesh(context: int = 1, model: int = 1) -> Mesh:
    """All the world's ranks, data-parallel by default."""
    return create_mesh(MeshConfig(data=-1, context=context, model=model))


def single_device_mesh() -> Mesh:
    """The mesh of one device: None (mesh_shape's 1 x 1 x 1)."""
    mesh_shape(MeshConfig(data=1, context=1, model=1), 1)
    return None


# ---- reading a mesh ------------------------------------------------------------------
def _dim(axis: str) -> int:
    if axis not in MeshAxes.ALL:
        raise ValueError(f"unknown mesh axis {axis!r}: one of {MeshAxes.ALL}")
    return MeshAxes.ALL.index(axis)


def in_mesh(mesh: Mesh) -> bool:
    """Whether this rank is one of the mesh's (always, without a mesh)."""
    return mesh is None or mesh.get_coordinate() is not None


def axis_size(mesh: Mesh, axis: str) -> int:
    """The ranks along a role's dim (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(_dim(axis))


def axis_rank(mesh: Mesh, axis: str) -> int:
    """This rank's index along a role's dim (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(_dim(axis))


def axis_group(mesh: Mesh, axis: str):
    """The process group along a role's dim; None (one rank) where it has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(_dim(axis))


def axes_group(mesh: Mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along several roles' dims
    (data x context for gradient reductions); None where it has one rank.
    A group over more than one dim of more than one rank is made once per
    mesh, by every rank of the world (create_mesh makes data x context's)."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return axis_group(mesh, axes[0])
    cache: Dict[tuple, object] = mesh.__dict__.setdefault("_emox_groups", {})
    if axes not in cache:
        dims = [_dim(a) for a in axes]
        rest = [d for d in range(3) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(mesh.size(d) for d in dims))
        mine = None
        for row in ranks.tolist():  # every rank makes every group, in the same order
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        cache[axes] = mine
    return cache[axes]


# ---- this rank's slice of a host array ----------------------------------------------------
def local_range(size: int, n: int, rank: int, what: str = "axis") -> slice:
    """Rank `rank`'s contiguous slice of `size` entries split over n ranks;
    raises where they do not divide."""
    if size % n:
        raise ValueError(f"{what} of {size} not divisible by {n} ranks")
    step = size // n
    return slice(rank * step, (rank + 1) * step)


class BatchShard:
    """This rank's block of a global batch: rows `data_rank` of
    `data_size` equal blocks, frames `ctx_rank` of `ctx_size`. Every
    batch-slicing name of the port (put_batch, shard_batch,
    with_context_sharding, the trainer's loss) takes its block through it.

    A clip whose frame count does not divide by `ctx_size` is not split:
    each context rank keeps every frame of its rows, as the reference's
    shard_batch leaves such an axis whole (`frames_split`). Rows that do not
    divide by `data_size` raise."""

    def __init__(self, data_rank: int = 0, data_size: int = 1, ctx_rank: int = 0, ctx_size: int = 1):
        self.data_rank, self.data_size, self.ctx_rank, self.ctx_size = data_rank, data_size, ctx_rank, ctx_size

    @classmethod
    def of(cls, mesh: Mesh) -> "BatchShard":
        return cls(axis_rank(mesh, MeshAxes.DATA), axis_size(mesh, MeshAxes.DATA),
                   axis_rank(mesh, MeshAxes.CONTEXT), axis_size(mesh, MeshAxes.CONTEXT))

    @property
    def whole(self) -> bool:
        """One block holds the whole batch."""
        return self.data_size == 1 and self.ctx_size == 1

    def row_range(self, n: int) -> slice:
        return local_range(n, self.data_size, self.data_rank, "batch")

    def frames_split(self, t: int) -> bool:
        """Whether a clip of t frames (motion frames included) is split over
        the context ranks: where there is more than one and t divides by
        their count."""
        return self.ctx_size > 1 and t % self.ctx_size == 0

    def frame_range(self, t: int) -> slice:
        return local_range(t, self.ctx_size, self.ctx_rank, "frame axis")

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """x's rows of this rank (axis 0)."""
        return x if x is None or self.data_size == 1 else x[self.row_range(x.shape[0])]

    def frames(self, x: Optional[torch.Tensor], axis: int = 1) -> Optional[torch.Tensor]:
        """x's frames of this rank (axis `axis`)."""
        if x is None or self.ctx_size == 1:
            return x
        return x[(slice(None),) * axis + (self.frame_range(x.shape[axis]),)]

    def take(self, x: torch.Tensor, frame_axis: Optional[int] = None) -> torch.Tensor:
        """x's block under batch_spec(x.dim(), frame_axis): its rows, and
        its frames where a frame axis is named."""
        x = self.rows(x)
        return x if frame_axis is None else self.frames(x, frame_axis)


def batch_spec(ndim: int, frame_axis: Optional[int] = None) -> Spec:
    """Axis 0 over `data`, the frame axis over `context`."""
    spec = [None] * ndim
    spec[0] = MeshAxes.DATA
    if frame_axis is not None and frame_axis < ndim:
        spec[frame_axis] = MeshAxes.CONTEXT
    return tuple(spec)


def batch_sharding(mesh: Mesh, ndim: int, frame_axis: Optional[int] = None) -> Spec:
    """batch_spec, the frame axis only where the mesh has a context axis
    (the reference's NamedSharding as a per-dim spec)."""
    return batch_spec(ndim, frame_axis if axis_size(mesh, MeshAxes.CONTEXT) > 1 else None)


def put_batch(batch, mesh: Mesh, frame_axis: Optional[int] = None):
    """This rank's block (BatchShard.take, as batch_sharding lays it out) of
    every array of a host batch, as host tensors."""
    shard = BatchShard.of(mesh)

    def put(x):
        x = torch.as_tensor(x)
        return shard.take(x, frame_axis if frame_axis is not None and x.dim() > frame_axis else None)

    return {k: put(v) for k, v in batch.items()}


def shard_params_replicated(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Every rank of the mesh takes its first rank's values of `tensors`, in
    place (the reference's replicated placement): a broadcast along each
    dim of more than one rank in turn, so that a mesh smaller than the world
    needs none of the ranks outside it."""
    from emox_torch.comm.runtime import broadcast_, coalesced

    for axis in MeshAxes.ALL:
        group = axis_group(mesh, axis)
        if group is not None:
            with torch.no_grad():
                coalesced(list(tensors), lambda flat: broadcast_(flat, 0, group))
