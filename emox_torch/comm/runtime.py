"""Multi-process bootstrap and the collectives of the port's distributed
runtime (counterpart of emox/comm/runtime.py).

`initialize_distributed` joins a torch.distributed world: the coordinator
is a `host:port` (tcp://) or a full init URL (`file://...`), and the
backend follows the device, nccl for CUDA and gloo for the CPU, unless the
caller names one. It is idempotent, and a no-op for one process, as the
reference's is. A backend is never swapped on failure.

The collectives take a process group (a DeviceMesh axis's, from
emox_torch.core.mesh) and move tensors by the transport the backend has for
them (`transport`):

  * "device": nccl moves CUDA tensors card to card;
  * "host": gloo moves CPU tensors;
  * "pinned-host": gloo has no send or receive for CUDA tensors (torch's
    backend table), so a gloo world that holds CUDA tensors stages every
    transfer through pinned host buffers: copied off the card, moved by
    gloo, copied back. This is the transport of the backend the caller
    chose (two ranks sharing one card, where nccl refuses), not a fallback.

A group of None is a group of one rank: every collective on it returns its
input.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]
COALESCE_BYTES = 256 << 20  # the largest flat buffer `coalesced` packs for one collective


class ProcessInfo(NamedTuple):
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def default_backend(device: Optional[Union[str, torch.device]] = None) -> str:
    """nccl where the ranks compute on CUDA cards, gloo on the CPU; device
    None means the card when there is one."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           timeout_s: Optional[float] = None) -> ProcessInfo:
    """Join the world of `num_processes` ranks as rank `process_id`, meeting
    at `coordinator_address`. Idempotent; with no coordinator and at most one
    process it initialises nothing (the reference's single-process no-op).
    backend: "nccl" or "gloo"; None follows `device` (default_backend)."""
    if dist.is_initialized() or (coordinator_address is None and num_processes in (None, 1)):
        return process_info()
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a distributed run needs --coordinator, --num-processes and --process-id together, got "
                         f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id, **kw)
    return process_info()


def process_info() -> ProcessInfo:
    """This process's rank and the world's size; the card count is this
    host's (0 without CUDA), the global count one per rank on the card."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dist.is_initialized():
        return ProcessInfo(0, 1, local, local)
    return ProcessInfo(dist.get_rank(), dist.get_world_size(), local, dist.get_world_size() if local else 0)


def is_master() -> bool:
    """Rank 0 of the world (or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: `device` where given, else cuda:<local rank>
    (LOCAL_RANK, else the world rank modulo the host's cards)."""
    if device is not None:
        return torch.device(device)
    from emox_torch.core.device import resolve_device

    if not dist.is_initialized():
        return resolve_device(None)
    if not torch.cuda.is_available():
        return resolve_device(None)  # raises: no card, and none was declined
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


# ---- transport -------------------------------------------------------------------
def transport(t: torch.Tensor) -> str:
    """How the world's backend moves t (module docstring)."""
    if dist.get_backend() == "nccl":
        if not t.is_cuda:
            raise ValueError("the nccl backend moves CUDA tensors only")
        return "device"
    return "pinned-host" if t.is_cuda else "host"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The buffer the backend moves for t: t itself, or a pinned host copy."""
    if transport(t) != "pinned-host":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _single(group: Group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """t summed over the group's ranks, in place; returns t."""
    if _single(group):
        return t
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    if w.data_ptr() != t.data_ptr():
        t.copy_(w)
    return t


def broadcast_(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """t from the group's rank `src` (a rank of the group), in place."""
    if _single(group):
        return t
    w = _wire(t)
    dist.broadcast(w, src=dist.get_global_rank(group, src), group=group)
    if w.data_ptr() != t.data_ptr():
        t.copy_(w)
    return t


def reduce_(t: torch.Tensor, dst: int, group: Group) -> torch.Tensor:
    """t summed over the group's ranks, in place on the group's rank `dst`
    (a rank of the group); the other ranks' t is left undefined."""
    if _single(group):
        return t
    w = _wire(t)
    dist.reduce(w, dst=dist.get_global_rank(group, dst), op=dist.ReduceOp.SUM, group=group)
    if w.data_ptr() != t.data_ptr():
        t.copy_(w)
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along dim in rank order. Gloo has no
    all_gather of CUDA tensors: the pinned-host transport gathers host copies."""
    if _single(group):
        return t
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def coalesced(tensors: Sequence[torch.Tensor], fn) -> None:
    """Apply the in-place collective fn(flat) to the tensors packed into flat
    buffers of one type at a time, at most COALESCE_BYTES each (or one
    larger tensor), and unpack the results into them."""
    by_type = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    for ts in by_type.values():
        start = 0
        while start < len(ts):
            stop, size = start, 0
            while stop < len(ts) and (stop == start or size + ts[stop].numel() * ts[stop].element_size() <= COALESCE_BYTES):
                size += ts[stop].numel() * ts[stop].element_size()
                stop += 1
            group = ts[start:stop]
            flat = torch.cat([t.reshape(-1) for t in group])
            fn(flat)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            start = stop


class _RingExchange:
    """Transfers posted to the rank `shift` places on in a group's ring and
    from the rank as far back (group rank (i + shift) mod n and
    (i - shift) mod n); `wait()` returns what came in, on the tensors'
    device."""

    def __init__(self, tensors: Sequence[torch.Tensor], group: Group, shift: int = 1):
        n = dist.get_world_size(group)
        r = dist.get_rank(group)
        nxt, prv = dist.get_global_rank(group, (r + shift) % n), dist.get_global_rank(group, (r - shift) % n)
        self.like = list(tensors)
        self.out = [_wire(t) for t in tensors]
        self.into = [torch.empty_like(w) for w in self.out]
        ops = [dist.P2POp(dist.isend, w, nxt, group) for w in self.out]
        ops += [dist.P2POp(dist.irecv, w, prv, group) for w in self.into]
        self.reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for req in self.reqs:
            req.wait()
        return [w if w.device == t.device else w.to(t.device, non_blocking=True) for w, t in zip(self.into, self.like)]


def ring_exchange(tensors: Sequence[torch.Tensor], group: Group, shift: int = 1) -> _RingExchange:
    """Post the transfer of `tensors` `shift` steps around the group's ring
    (-1: back to the previous rank); the result's wait() returns what came
    in."""
    return _RingExchange(tensors, group, shift)
