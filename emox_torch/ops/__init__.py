"""Ops: the hand-written CUDA kernels, their plain versions, and plain ops.

Kernels (each wrapper counts its launches in `.launches`):
  * flash_attention         -> the attention forward on [B, H, L, D]
                               operands with strides (TPU `_flash_kernel`),
                               counted per call, by one of the kernels below
  * flash_attention_nlc     -> the attention forward on packed tokens (TPU
                               `_flash_nlc_kernel`), counted per call
  * flash_fwd_sm90          -> csrc/flash_fwd_sm90.cu: both layouts' forward,
                               bfloat16, head dim <= 256
  * flash_fwd_wmma          -> csrc/flash_attn.cu: both layouts' forward,
                               float32, head dim <= 256
  * flash_fwd_wide          -> csrc/flash_attn_nlc.cu: the packed forward at
                               head dim 512
  * flash_attention_bwd     -> csrc/flash_attn_bwd.cu (TPU
                               `_flash_bwd_dq_kernel` and
                               `_flash_bwd_dkv_kernel`); the backward of
                               flash_attention
  * flash_attention_nlc_bwd -> csrc/flash_attn_nlc_bwd.cu (TPU
                               `_flash_bwd_nlc_dq_kernel` and
                               `_flash_bwd_nlc_dkv_kernel`) at head dims 64
                               and 128, csrc/flash_attn_bwd.cu on head-split
                               views at the others; the backward of
                               flash_attention_nlc
  * fused_ln_geglu_ff       -> csrc/ln_geglu_ff.cu (TPU `_ln_ff_kernel` and
                               `_ln_ff_wide_kernel`)
  * fused_geglu_ff          -> csrc/geglu_ff.cu (TPU `_ff_kernel`), behind
                               the dispatcher geglu_ff (EMOX_FF_IMPL)
  * fused_group_norm        -> csrc/group_norm.cu (TPU `_gn_kernel`), under
                               EMOX_GROUPNORM_IMPL=pallas
  * group_norm_stats        -> csrc/group_norm.cu (TPU `_gn_stats_kernel`),
                               under EMOX_GROUPNORM_IMPL=fast
  * fused_ln_qkv            -> csrc/ln_qkv.cu (TPU `_ln_qkv_kernel`), under
                               EMOX_LN_QKV=1
"""

from emox_torch.ops.attention import (
    ATTENTION_IMPLS,
    KERNEL_MIN_KV,
    attention_default_impl,
    attention_bwd_plain,
    attention_nlc_bwd_plain,
    attention_nlc_plain,
    attention_plain,
    attention_xla,
    dot_product_attention,
    dot_product_attention_nlc,
    flash_attention,
    flash_attention_bwd,
    flash_attention_nlc,
    flash_attention_nlc_bwd,
    flash_fwd_sm90,
    flash_fwd_wide,
    flash_fwd_wmma,
    pad_head_dim,
    padded_attention,
)
from emox_torch.ops.ff import (
    ff_default_impl,
    fused_geglu_ff,
    fused_ln_geglu_ff,
    geglu_ff,
    geglu_ff_plain,
    geglu_ff_xla,
    ln_geglu_ff_plain,
    ln_geglu_ff_xla,
)
from emox_torch.ops.groupnorm import (
    fused_group_norm,
    group_norm,
    group_norm_fast,
    group_norm_plain,
    group_norm_silu,
    group_norm_stats,
    group_norm_stats_plain,
    group_norm_xla,
)
from emox_torch.ops.ln_qkv import fused_ln_qkv, ln_qkv_plain, ln_qkv_xla

KERNEL_WRAPPERS = {
    "flash_attn_fwd": flash_attention,
    "flash_attn_bwd": flash_attention_bwd,
    "flash_attn_nlc_fwd": flash_attention_nlc,
    "flash_attn_nlc_bwd": flash_attention_nlc_bwd,
    "flash_fwd_sm90": flash_fwd_sm90,
    "flash_fwd_wmma": flash_fwd_wmma,
    "flash_fwd_wide": flash_fwd_wide,
    "ln_geglu_ff": fused_ln_geglu_ff,
    "geglu_ff": fused_geglu_ff,
    "group_norm": fused_group_norm,
    "group_norm_stats": group_norm_stats,
    "ln_qkv": fused_ln_qkv,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "ATTENTION_IMPLS",
    "KERNEL_MIN_KV",
    "KERNEL_WRAPPERS",
    "attention_bwd_plain",
    "attention_default_impl",
    "attention_nlc_bwd_plain",
    "attention_nlc_plain",
    "attention_plain",
    "attention_xla",
    "dot_product_attention",
    "dot_product_attention_nlc",
    "ff_default_impl",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_nlc",
    "flash_attention_nlc_bwd",
    "flash_fwd_sm90",
    "flash_fwd_wide",
    "flash_fwd_wmma",
    "fused_geglu_ff",
    "fused_group_norm",
    "fused_ln_geglu_ff",
    "fused_ln_qkv",
    "geglu_ff",
    "geglu_ff_plain",
    "geglu_ff_xla",
    "group_norm",
    "group_norm_fast",
    "group_norm_plain",
    "group_norm_silu",
    "group_norm_stats",
    "group_norm_stats_plain",
    "group_norm_xla",
    "launch_counts",
    "ln_geglu_ff_plain",
    "ln_geglu_ff_xla",
    "ln_qkv_plain",
    "ln_qkv_xla",
    "pad_head_dim",
    "padded_attention",
    "reset_launch_counts",
]
