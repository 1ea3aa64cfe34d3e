"""The port's kernels as registered ops, so that a traced program sees them.

Each kernel entry of emox_torch/ops is an op in the `emox_torch` namespace
(torch.library.custom_op), with three implementations:

  * CUDA: the launch the wrapper makes on a CUDA tensor, with its launch
    counter; an input no kernel takes raises;
  * CPU: the kernel's plain version, which CPU tensors take;
  * fake: the same shape and type checks on tensors that carry no data (the
    fake tensors torch.export traces with), returning empty tensors of the
    real implementation's shapes, types and strides.

No other device has an implementation: a tensor there raises. torch.export
traces through the fake implementation, so an exported graph holds
`torch.ops.emox_torch.<name>` at every site where the eager program launches
a kernel, never the plain formula, and a loaded program launches the same
kernels as the eager one.

Eager calls on plain tensors do not go through the dispatcher: a call
whose first tensor is a plain torch.Tensor runs the same CUDA or CPU
implementation directly, which saves the op's host cost, 11-56 us a call on
an H100's host (PERF.md). Any other tensor (a fake or functional
tensor while tracing) goes through the op, and so does every call inside
`through_ops()`, which chip_smoke.py times and the tests count with. There
is one copy of each launch: the op's implementations are the functions the
direct route calls.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

NAMESPACE = "emox_torch"
_direct = True  # False inside through_ops()

OPS: Dict[str, Callable] = {}  # name -> the registered op (torch.ops.emox_torch.<name>)


def on_card_or_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def kernel_op(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable) -> Callable:
    """Register `emox_torch::<name>` with the given schema (its arguments
    and results, e.g. "(Tensor x, float eps) -> Tensor") and
    implementations; returns the op. The wrappers call it where `direct`
    is False, and else the CUDA or CPU implementation themselves."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(), device_types="cpu", schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    OPS[name] = getattr(torch.ops.emox_torch, name).default
    return op


def direct(t: torch.Tensor) -> bool:
    """Whether a wrapper's call on t runs its implementation directly: for a
    plain tensor (not a fake or functional one), outside through_ops()."""
    return _direct and type(t) is torch.Tensor


@contextlib.contextmanager
def through_ops():
    """Send every wrapper call through its registered op, plain tensors'
    too."""
    global _direct
    _direct = False
    try:
        yield
    finally:
        _direct = True


def route(op: Callable, on_card: bool, cuda: Callable, cpu: Callable, *args):
    """A wrapper's call: `cuda(*args)` or `cpu(*args)` (on_card: the
    wrapper's device check of its first tensor) where `direct`, else the op."""
    if not direct(args[0]):
        return op(*args)
    return (cuda if on_card else cpu)(*args)
