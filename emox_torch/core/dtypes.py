"""Mixed-precision policy: bf16 compute, fp32 masters and optimizer state
(the port's counterpart of emox.core.dtypes)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_by_name(name: str) -> torch.dtype:
    if name not in _NAMES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_NAMES)}")
    return _NAMES[name]


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    """Floating tensors in a dict / list / tuple tree cast to dtype; other
    leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree):
        return _cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast(tree, self.param_dtype)


def policy_from_names(param_dtype: str = "float32", compute_dtype: str = "bfloat16") -> Policy:
    return Policy(param_dtype=dtype_by_name(param_dtype), compute_dtype=dtype_by_name(compute_dtype))
