"""The sparse-causal frame exchange over the `context` axis.

Sparse-causal self-attention (model.use_sparse_causal) reads, for every
frame, the tokens of its clip's first frame and of the frame before it
(emox_torch.nn.attention_blocks.sc_gather). With a clip's frames split over
the context ranks, rank r holds frames [r t, (r + 1) t): the first frame
lives on rank 0, and the frame before rank r's first on rank r - 1. Where
GSPMD moves those frames for the reference, two autograd functions move
them here, on the collectives of emox_torch.comm.runtime:

  * `first_frame`: forward, a broadcast of the clip's frame 0 from context
    rank 0; backward, its gradient summed over the ranks onto rank 0;
  * `previous_frame`: forward, each rank's last frame to rank r + 1 (rank 0
    takes its own frame 0, as the whole clip's frame 0 sees itself);
    backward, the gradient shifted back to rank r - 1.

Every rank of the group posts them in the same order, and so does the
recomputation of a checkpointed transformer in the backward (each function
then runs forward again at the same site on every rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from emox_torch.comm.runtime import Group, broadcast_, reduce_, ring_exchange


class _FirstFrame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.root = group, dist.get_rank(group) == 0
        return broadcast_(x.clone(), 0, group)

    @staticmethod
    def backward(ctx, g):
        total = reduce_(g.contiguous().clone(), 0, ctx.group)
        return (total if ctx.root else None), None


class _PreviousFrame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, last, first, group):
        ctx.group, ctx.root = group, dist.get_rank(group) == 0
        got = ring_exchange([last.contiguous()], group).wait()[0]
        return first.clone() if ctx.root else got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        # rank 0's output is its own frame 0: the last frame of rank n - 1 is
        # nobody's previous, and rank 0 sends it a zero gradient
        back = ring_exchange([torch.zeros_like(g) if ctx.root else g], ctx.group, shift=-1).wait()[0]
        return back, (g if ctx.root else None), None


def first_frame(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Context rank 0's x (the clip's frame 0) on every rank of the group."""
    return _FirstFrame.apply(x, group)


def previous_frame(last: torch.Tensor, first: torch.Tensor, group: Group) -> torch.Tensor:
    """The frame before this rank's first: rank r - 1's `last`, on rank 0
    its own `first`."""
    return _PreviousFrame.apply(last, first, group)
