"""Ops: the hand-written CUDA kernels, their plain versions, and plain ops.

Kernels of this slice (each wrapper counts its launches in `.launches`):
  * flash_attention_nlc -> csrc/flash_attn_nlc.cu (TPU `_flash_nlc_kernel`)
  * fused_ln_geglu_ff   -> csrc/ln_geglu_ff.cu (TPU `_ln_ff_kernel` and
                           `_ln_ff_wide_kernel`)
"""

from emox_torch.ops.attention import (
    KERNEL_MIN_KV,
    attention_nlc_plain,
    attention_xla,
    dot_product_attention_nlc,
    flash_attention_nlc,
)
from emox_torch.ops.ff import fused_ln_geglu_ff, geglu_ff_xla, ln_geglu_ff_plain
from emox_torch.ops.groupnorm import group_norm_xla

KERNEL_WRAPPERS = {
    "flash_attn_nlc_fwd": flash_attention_nlc,
    "ln_geglu_ff": fused_ln_geglu_ff,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_MIN_KV",
    "KERNEL_WRAPPERS",
    "attention_nlc_plain",
    "attention_xla",
    "dot_product_attention_nlc",
    "flash_attention_nlc",
    "fused_ln_geglu_ff",
    "geglu_ff_xla",
    "group_norm_xla",
    "launch_counts",
    "ln_geglu_ff_plain",
    "reset_launch_counts",
]
