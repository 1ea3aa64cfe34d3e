"""Ops: the hand-written CUDA kernels, their plain versions, and plain ops.

Kernels (each wrapper counts its launches in `.launches`):
  * flash_attention         -> the attention forward on [B, H, L, D]
                               operands with strides (TPU `_flash_kernel`),
                               counted per call, by one of the kernels below
  * flash_attention_nlc     -> the attention forward on packed tokens (TPU
                               `_flash_nlc_kernel`), counted per call
  * flash_fwd_sm90          -> csrc/flash_fwd_sm90.cu: both layouts' forward,
                               bfloat16, head dim <= 256 and 512
  * flash_fwd_f32_sm90      -> csrc/flash_fwd_sm90.cu on a two-part bf16
                               split: both layouts' forward, float32, head
                               dim <= 256
  * flash_fwd_d512_f32      -> csrc/flash_fwd_d512_f32.cu: both layouts'
                               forward at head dim 512, float32
  * flash_fwd_wide          -> csrc/flash_fwd_wide.cu: both layouts'
                               forward at head dims above 512, both types
                               (up to 2240 / 1152 in float32: a cluster of
                               column slices that computes S once)
  * flash_attention_bwd     -> the backward of flash_attention (TPU
                               `_flash_bwd_dq_kernel` and
                               `_flash_bwd_dkv_kernel`), counted per call, by
                               one of the kernels below
  * flash_attention_nlc_bwd -> the backward of flash_attention_nlc (TPU
                               `_flash_bwd_nlc_dq_kernel` and
                               `_flash_bwd_nlc_dkv_kernel`), on head-split
                               views, counted per call
  * flash_bwd_sm90          -> csrc/flash_bwd_sm90.cu: both layouts'
                               backward, bfloat16, head dim <= 128
  * flash_bwd_f32_sm90      -> csrc/flash_bwd_sm90.cu on a two-part bf16
                               split: the same in float32
  * flash_bwd_d256_sm90     -> csrc/flash_bwd_d512_sm90.cu at half its
                               width: both layouts' backward at head dims
                               129-256, both types
  * flash_bwd_d512_sm90     -> csrc/flash_bwd_d512_sm90.cu: both layouts'
                               backward at head dim 512, bfloat16
  * flash_bwd_d512_f32      -> csrc/flash_bwd_d512_sm90.cu on a two-part
                               bf16 split, a cluster of four blocks a tile:
                               the same in float32
  * flash_bwd_wide          -> csrc/flash_bwd_wide_sm90.cu (a cluster of
                               head-dim slices a tile; past its reach
                               csrc/flash_attn_wide.cu): both layouts'
                               backward at head dims above 512, both types
  * fused_ln_geglu_ff       -> LN + GEGLU FF + residual (TPU `_ln_ff_kernel`
                               and `_ln_ff_wide_kernel`), counted per call,
                               by one of the kernels below
  * fused_geglu_ff          -> GEGLU FF alone (TPU `_ff_kernel`), behind the
                               dispatcher geglu_ff (EMOX_FF_IMPL), counted
                               per call, by one of the kernels below
  * ff_sm90                 -> csrc/ff_sm90.cu: both FF functions, bfloat16
  * ff_f32_sm90             -> csrc/ff_sm90.cu on a two-part bf16 split:
                               both FF functions, float32
  * fused_group_norm        -> csrc/group_norm.cu (TPU `_gn_kernel`), under
                               EMOX_GROUPNORM_IMPL=pallas
  * group_norm_stats        -> csrc/group_norm.cu (TPU `_gn_stats_kernel`),
                               under EMOX_GROUPNORM_IMPL=fast
  * fused_ln_qkv            -> LN + q/k/v (TPU `_ln_qkv_kernel`), under
                               EMOX_LN_QKV=1, counted per call, by one of
                               the kernels below
  * ln_qkv_sm90             -> csrc/ln_qkv_sm90.cu: bfloat16
  * ln_qkv_f32_sm90         -> csrc/ln_qkv_sm90.cu's float32 entry: an LN +
                               split pass, then one GEMM on the split
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
    flash_bwd_d256_sm90,
    flash_bwd_d512_f32,
    flash_bwd_d512_sm90,
    flash_bwd_f32_sm90,
    flash_bwd_sm90,
    flash_bwd_wide,
    flash_fwd_d512_f32,
    flash_fwd_f32_sm90,
    flash_fwd_sm90,
    flash_fwd_wide,
    pad_head_dim,
    padded_attention,
)
from emox_torch.ops.ff import (
    ff_default_impl,
    ff_f32_sm90,
    ff_sm90,
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
from emox_torch.ops.ln_qkv import fused_ln_qkv, ln_qkv_f32_sm90, ln_qkv_plain, ln_qkv_sm90, ln_qkv_xla

KERNEL_WRAPPERS = {
    "flash_attn_fwd": flash_attention,
    "flash_attn_bwd": flash_attention_bwd,
    "flash_attn_nlc_fwd": flash_attention_nlc,
    "flash_attn_nlc_bwd": flash_attention_nlc_bwd,
    "flash_fwd_sm90": flash_fwd_sm90,
    "flash_fwd_f32_sm90": flash_fwd_f32_sm90,
    "flash_fwd_d512_f32": flash_fwd_d512_f32,
    "flash_fwd_wide": flash_fwd_wide,
    "flash_bwd_sm90": flash_bwd_sm90,
    "flash_bwd_f32_sm90": flash_bwd_f32_sm90,
    "flash_bwd_d256_sm90": flash_bwd_d256_sm90,
    "flash_bwd_d512_sm90": flash_bwd_d512_sm90,
    "flash_bwd_d512_f32": flash_bwd_d512_f32,
    "flash_bwd_wide": flash_bwd_wide,
    "ln_geglu_ff": fused_ln_geglu_ff,
    "geglu_ff": fused_geglu_ff,
    "ff_sm90": ff_sm90,
    "ff_f32_sm90": ff_f32_sm90,
    "group_norm": fused_group_norm,
    "group_norm_stats": group_norm_stats,
    "ln_qkv": fused_ln_qkv,
    "ln_qkv_sm90": ln_qkv_sm90,
    "ln_qkv_f32_sm90": ln_qkv_f32_sm90,
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
    "ff_f32_sm90",
    "ff_sm90",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_nlc",
    "flash_attention_nlc_bwd",
    "flash_bwd_d256_sm90",
    "flash_bwd_d512_f32",
    "flash_bwd_d512_sm90",
    "flash_bwd_f32_sm90",
    "flash_bwd_sm90",
    "flash_bwd_wide",
    "flash_fwd_d512_f32",
    "flash_fwd_f32_sm90",
    "flash_fwd_sm90",
    "flash_fwd_wide",
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
    "ln_qkv_f32_sm90",
    "ln_qkv_plain",
    "ln_qkv_sm90",
    "ln_qkv_xla",
    "pad_head_dim",
    "padded_attention",
    "reset_launch_counts",
]
