#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (emox_torch) on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--out DIR]

Each phase prints one JSON line; every phase always runs, and any failure
raises and the script exits non-zero. Phases:

  1. build: the card's name and power limit, then the CUDA kernels built
     from emox_torch/csrc (one nvcc per source, in parallel) and timed.
  2. kernels: every kernel held against its plain PyTorch version at the
     serving and training shapes in bf16 (and in float32; the strided
     layout on head-split views of packed tokens; the 512^2 shapes too),
     with max error against the stated tolerance, kernel / plain / library
     times (CUDA events, after warm-up), the bound (the least time the card
     could take) and, for the feed-forward, its grid against the card's SMs
     and the time of the unfused bf16 route (ln_geglu_ff_xla, what
     EMOX_FF_IMPL=xla runs). The FF runs on one kernel per type for both its
     functions (LN + FF + residual, and K6's FF alone): ff_sm90 (bf16, wgmma
     + TMA) at the four 256^2 and the four 512^2 sub-layer shapes, ragged M,
     M below one tile, twice on the same inputs (the same bits); ff_f32_sm90
     (float32: the same kernels on a two-part bf16 split) timed at the
     float32 step's level 0 (M 4096, C 320) in both functions, ragged M, C
     80 and 1280; every FF timing with device_ms (calls in one CUDA graph)
     and the bound of the bf16 products it issues. The attention forward runs on one kernel
     per type for both layouts: flash_fwd_sm90 (bf16, wgmma + TMA) at the
     serving shapes of both, at Lk 5 and 16, at head dims 4, 40, 80, 128,
     160, 256 and 512 (the VAE's mid-attention) and ragged;
     flash_fwd_f32_sm90 (float32: the same source's kernels on a two-part
     bf16 split) at the same head dims up to 256, timed at K5's shape and
     the float32 step's packed shape with device_ms;
     flash_fwd_d512_f32 (bf16 wgmma on a two-part split, a cluster of two
     blocks a tile) at head dim 512 in float32, timed at N 1 and 16 x 4096
     tokens with device_ms; head dims 257-511 are padded to 512 (d 384 at
     L 4096 and d 300 strided, both types, forward and backward); head dims
     above 512 on flash_fwd_wide.cu (forward) and flash_bwd_wide_sm90.cu
     (backward; flash_attn_wide.cu past its reach): flash_fwd_wide up to d
     2240 in bf16 and 1152 in float32, flash_bwd_wide up to 2048 / 1536, a
     cluster of column slices that computes S (and dP) once, wider a block a
     128-column slice; d 640 timed in float32 at the width-640 VAE's N 1 x
     1024 of stage 5 and in bf16 at N 1 x 4096, twice for the same bits, d
     1024 packed and 576 strided in both types and directions, twice; d 768,
     896, 1024 and 1152 forward (other cluster shapes, the keys split in
     two, single-stage rings) and one key tile, 2304 on the slice forward;
     the backward at d 768, 1024 and 2048 (four and eight slices; float32
     2048 and both at 2304 on the slice kernels), d 640 at N 1 x 300 (the
     streamed dimension in two
     parts) and with one key tile, twice, and with 2 heads dq only and dk/dv
     only). The
     backward runs on one kernel per
     type for both layouts too: flash_bwd_sm90 (bf16, head dim <= 128,
     wgmma + TMA) at the training shapes of both (timed), at head dims 4,
     40, 64, 80 and 128 on both layouts with ragged Lq/Lk, with dq only and
     with dk/dv only, and twice on the same inputs (the same bits);
     flash_bwd_f32_sm90 (float32 at head dim <= 128 on the same source's
     pair, two-part split) timed at the float32 train step's shape;
     flash_bwd_d256_sm90 (head dims 129-256, both types:
     flash_bwd_d512_sm90.cu's pair at half width) timed in float32 at the
     small VAE's d 256, N 1 x 1024 of stage 5 and in bf16 at d 160 (N 16,
     Lq 256, Lk 512) and d 256 (N 4, L 1024), twice for the same bits, and
     at d 160, 192 and 256 untimed. Head dim 512 (the VAE's
     mid-attention, which stage 5 trains): flash_bwd_d512_sm90 (bf16,
     wgmma + TMA, a cluster of two blocks a tile) at stage 5's shape (N 4,
     L 4096) and a ragged L 2304 with device_ms, flash_bwd_d512_f32 (the
     same source's kernels on the two-part split, a cluster of four blocks
     of 128 columns a tile) at N 1, L 1024 with device_ms and at N 2 x
     2304, each timed and twice for the same bits, with dq only, dk/dv only
     and Lq != Lk in both types (float32 twice). The fused-norm kernels: K7 on
     ln_qkv_sm90 (bf16, LN in the prologue of a wgmma + TMA GEMM) at the
     four 256^2 and four 512^2 self-attention shapes, ragged M and C, twice
     for the same bits, ln_qkv_f32_sm90 (float32: an LN + split pass, then
     a wgmma + TMA GEMM on the two-part split) timed at M 4096, C 320 and M
     2048, C 1280, twice for the same bits, ragged M and C, C past 1280;
     K8a and K8b (group_norm.cu:
     one cluster launch per call where the slab fits, else two) at the
     UNet's levels 0-2 at 256^2 and 512^2, the VAE's decode and stage 5's
     [4, 262144, 128], ragged L, both types, twice for the same bits. K7's
     and K8's rows carry device_ms beside ms: the device time of 20 calls
     captured in one CUDA graph (device_ms), without the host's cost of
     issuing them, for the kernel and for its library call.
  3. step: one CFG-batched denoise step of the flagship model at 256^2,
     2 frames, float32, on the card (kernels) against the same weights on
     the CPU (plain versions), TF32 off for matmuls and convolutions.
  4. serve: the flagship EMOPipeline in bf16 answers three requests (256^2
     reference image, 16 frames of audio, 3-axis speeds, face mask, CFG
     7.5, 10 DDIM steps, VAE decode); s/request, ms/step, peak memory and
     the kernels' launch counts during the requests. Then the attention
     switch: step_attn_pallas (one bf16 step under EMOX_ATTENTION_IMPL=pallas,
     a kernel launch at every dispatcher call, eps against the =xla step and
     a float32 one) and serve_attn_xla (two requests and a profiled one with
     plain attention at every site: 0 launches of the attention kernels).
     Then the rest of the sampling API, each path's launches counted from 0:
     step_long (one float32 windowed CFG step, T 6 at context 4, overlap 1:
     2 windows folded into one call, card against CPU), serve_long (two
     48-frame requests through the windowed sampler, 4 windows a step in one
     call, and a profiled one: s/request, s per second of video, ms/step,
     peak memory, the launches asserted at the count that the window plan
     and WINDOWS_PER_CALL give, reader_calls), serve_long_125 (one 5 s
     request: 11 windows a step in calls of 4, 4 and 3), serve_autoregressive
     (generate_long, 48 frames in segments of 16 with 2 motion frames),
     invert (a served clip's first 16 frames inverted, then sampled back),
     and one 16-frame request each with interpolation_factor=2, the two-call
     CFG program and model.use_gn_ref=True.
  5. profile: one more request under torch.profiler, with the device time
     per kernel group, the top kernels and the device's idle share.
  6. train_step: the loss and the trainable gradients of one float32
     stage-2 step (flagship widths, batch 1, 2 frames) on the card against
     the CPU, same weights and the same draws, TF32 off.
  7. train: emox_torch.train.Trainer trains the flagship in bf16, stage 2
     (batch 2, 8 frames: 2 warm-up and 5 timed steps) and then stage 1
     (batch 4, 1 frame: 3 steps); ms/step, frames/s, peak memory, losses
     finite, trainable leaves changed and frozen ones not, the kernels'
     launches per step, and one more step under torch.profiler; then stage 3 (batch 2, 8 frames, 3-axis
     speeds and a face mask: 3 steps) the same way. Every train phase
     asserts that each attention backward landed on exactly one kernel of
     its type (bf16: flash_bwd_sm90; float32: flash_bwd_f32_sm90), at the
     stage-2 counts per step of BWD_PER_STEP.
  8. step_sd15, serve_sd15, train_sd15: phases 3, 4 + 5 and 7 (stage 2) on
     "flagship-sd15", the flagship with the SD-1.5 head layout (8 heads,
     ResNet time embedding added, text cross-attention fed by the CLIP-L
     text encoder), every request and step with a text prompt; its level-0
     sites take the strided kernels (K5) where the flagship takes K1/K4.
  9. step_norms, serve_norms, serve_norms_fast, train_step_norms,
     train_norms: the flagship under the reference's fused-norm switches.
     The float32 step, card against CPU, with EMOX_GROUPNORM_IMPL=pallas and
     EMOX_LN_QKV=1, then with fast, EMOX_LN_QKV=1 and EMOX_FUSED_QKV=1;
     three requests and a profiled one under pallas + EMOX_LN_QKV=1, with
     the launches of GroupNorm (K8a) and LN + q/k/v (K7) asserted at the
     counts the code gives (norm_launches_per_request); one request under
     fast (K8b at its count, K8a at 0); the float32 stage-2 loss and
     gradients, card against CPU, and stage 2 in bf16 (as phase 7) under
     pallas + EMOX_LN_QKV=1. Each phase sets its switches and restores the
     environment; every other phase runs with them unset and asserts 0
     launches of K7, K8a and K8b. The kernels phase holds K8a, K8b and K7
     against their plain versions too, and every profile reports the device
     time of the GroupNorm and LayerNorm calls (norm_ranges_ms).
 10. geglu_ff, serve_ff_xla: the reference's FF switch. K6 behind
     GEGLUFeedForward with impl "fused", with EMOX_FF_IMPL unset and =fused
     (launches, output against impl "xla"), not under =xla, and its
     backward against geglu_ff_xla's autograd; two 256^2 requests and a
     profiled one under EMOX_FF_IMPL=xla, the plain FF at every sub-layer
     (0 launches of ln_geglu_ff, K6 and both FF kernels). Every serve phase
     asserts the FF launches at the count the code gives
     (ff_launches_per_request: 336 per request, each on ff_sm90).
 11. vae512, serve_512, train_512: the flagship at 512^2, the reference's
     train resolution. The VAE encodes and decodes one 512^2 image in
     float32, card (flash_fwd_d512_f32, head dim 512, in both mid-attentions)
     against CPU;
     three requests and a profiled one as phase 4 at 512^2; Trainer stage 2
     at 512^2, batch 2 x 8 frames (1 warm-up, 2 timed steps, one profiled)
     as phase 7. Every serve phase asserts the attention kernels' launches
     at the counts the code gives (attn_launches_per_request: 107 packed
     forwards per 512^2 request, all on flash_fwd_sm90, the VAE's 2 at d 512
     included).
 12. train_step_vae, train_vae512, face_nets, train_stage0: the two
     training stages that need neither the dataset nor ControlNet. Stage 5
     (VAE pretraining): one float32 step of the flagship VAE at 256^2,
     batch 1, card against CPU (loss and gradients, the same weights and
     posterior noise) under EMOX_ATTENTION_IMPL=pallas, so that both
     1024-token mid-attentions take flash_fwd_d512_f32 and the float32 d-512
     backward; then Trainer stage 5 at 512^2 in bf16, batch 4 (1 warm-up, 3
     timed steps, one profiled), 2 launches per step of flash_fwd_sm90 and
     of flash_bwd_d512_sm90 (the encoder's and the decoder's mid-attention);
     the float32 step again with the small preset's VAE at 128^2 (head dim
     256: flash_fwd_f32_sm90 and flash_bwd_d256_sm90) and with a VAE of last
     width 640 at 256^2 (flash_fwd_wide, flash_bwd_wide), card against CPU;
     then the same steps under EMOX_GROUPNORM_IMPL=pallas
     (train_vae512_norms: every GroupNorm of the VAE on K8a, 52 launches a
     step), with the GroupNorm calls' device time in its profile.
     Stage 0: the face nets with the trained weights the repository ships
     (emox/assets/face_nets.npz, read through the port), float32 at batch
     8, 256^2, card against CPU; then Trainer stage 0 from those weights in
     float32, batch 8 at 256^2 (1 warm-up, 5 timed steps), which launches
     no kernel of the port. Each checks that only the stage's submodels
     changed.
 13. the `kernels` line: every ported kernel with the TPU kernel it
     replaces and its numbers.
The line before the last repeats the card's name and power limit; the
last line is {"ok": true, "device": {...}}. Weights are random, from seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BF16_EPS = 2.0 ** -8  # spacing of bf16 values in [1, 2)
FORWARD_KERNELS = ("flash_attn_nlc_fwd", "flash_attn_fwd", "ln_geglu_ff")  # the kernels of the serving paths
# the FF kernels behind both FF functions (ln_geglu_ff: K2/K3, geglu_ff: K6):
# bf16 -> ff_sm90 (wgmma + TMA), float32 -> ff_f32_sm90 (the same kernels on
# the two-part bf16 split)
FF_SOURCES = {"bfloat16": "ff_sm90", "float32": "ff_f32_sm90"}
# The attention routes (forward, backward) each configuration's path takes at
# its level-0 reference-concat sites (Lk 2048): head dim 64 (the flagship) ->
# the packed layout (flash_attn_nlc_fwd counts its forward launches, K4 its
# backward); head dim 40 (the SD-1.5 head layout) -> the strided layout
# (flash_attn_fwd, K5's backward). Neither path launches the other's. Both
# layouts' forward runs on one kernel per type: FWD_SOURCES.
ATTN_KERNELS = {"flagship": ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd"),
                "flagship-sd15": ("flash_attn_fwd", "flash_attn_bwd")}
PROMPT = "a person talking to the camera, studio lighting, sharp focus"
# The reference's fused-norm switches, off (unset) in every phase but the *_norms
# ones, and the kernel each selects. NORMS is the configuration served and
# trained under them; NORMS_FAST its GroupNorm alternative (K8b), with the
# concatenated self-attention projection as well. EMOX_FF_IMPL, the FF impl
# switch, is unset too but in the phases that set it (geglu_ff, serve_ff_xla):
# K6 (geglu_ff) runs on no model path, and under "xla" neither does ln_geglu_ff
# nor any FF kernel.
SWITCH_VARS = ("EMOX_GROUPNORM_IMPL", "EMOX_LN_QKV", "EMOX_FUSED_QKV", "EMOX_FF_IMPL")
SWITCH_KERNELS = ("group_norm", "group_norm_stats", "ln_qkv")
# the kernels behind K7's calls (ln_qkv): bf16 -> ln_qkv_sm90 (wgmma + TMA),
# float32 -> ln_qkv_f32_sm90 (an LN + split pass, then a GEMM on the split)
QKV_SOURCES = {"bfloat16": "ln_qkv_sm90", "float32": "ln_qkv_f32_sm90"}
# (M, C) of the float32 FF and K7 sites: the float32 CFG step's levels 0, 1,
# 2 and mid (batch 1 x 2 frames under CFG at 256^2), then the float32 train
# step's (batch 1 x 2 frames)
F32_STEP_SITES = ((4096, 320), (1024, 640), (256, 1280), (64, 1280), (2048, 320), (512, 640), (128, 1280),
                  (32, 1280))
# The attention switch, EMOX_ATTENTION_IMPL, is unset too but in the phases that
# set it (serve_attn_xla, step_attn_pallas).
SWITCH_VARS += ("EMOX_ATTENTION_IMPL",)
# the forward kernels behind the two layouts: bf16 (head dim <= 256, and 512:
# the VAE's mid-attention), float32 (<= 256), float32 at head dim 512, and
# both types above 512
FWD_SOURCES = ("flash_fwd_sm90", "flash_fwd_f32_sm90", "flash_fwd_d512_f32", "flash_fwd_wide")
# the backward kernels behind the two layouts: head dim <= 128 in bf16 and in
# float32, 129-256 (both types), head dim 512 in bf16 and in float32 (the
# VAE's mid-attention, stage 5 only), above 512 (both types); and the
# backward launches per stage-2 step of each train path (name, image size):
# its kernel sites (Lk >= KERNEL_MIN_KV) that the loss differentiates
BWD_SOURCES = ("flash_bwd_sm90", "flash_bwd_f32_sm90", "flash_bwd_d256_sm90", "flash_bwd_d512_sm90",
               "flash_bwd_d512_f32", "flash_bwd_wide")
BWD_PER_STEP = {("flagship", 256): 4, ("flagship", 512): 9, ("flagship-sd15", 256): 4}
ATTN_XLA = {"EMOX_ATTENTION_IMPL": "xla"}
ATTN_PALLAS = {"EMOX_ATTENTION_IMPL": "pallas"}
NORMS = {"EMOX_GROUPNORM_IMPL": "pallas", "EMOX_LN_QKV": "1"}
NORMS_FAST = {"EMOX_GROUPNORM_IMPL": "fast", "EMOX_LN_QKV": "1", "EMOX_FUSED_QKV": "1"}
GN_PALLAS = {"EMOX_GROUPNORM_IMPL": "pallas"}
FF_XLA = {"EMOX_FF_IMPL": "xla"}


def model_config(name: str, image_size: int, num_frames: int):
    """The flagship preset, or with name "flagship-sd15" the flagship with
    the SD-1.5 head layout and nothing else changed: 8 heads (head dim 40,
    80, 160), ResNet time embedding added, text cross-attention fed by the
    CLIP-L text encoder."""
    import dataclasses

    from emox_torch.core.presets import flagship_config

    cfg = flagship_config(image_size=image_size, num_frames=num_frames)
    if name == "flagship":
        return cfg
    assert name == "flagship-sd15", name
    return cfg.replace(
        model=dataclasses.replace(cfg.model, attention_heads=8, resnet_temb_mode="add", use_cross_attention=True),
        clip=dataclasses.replace(cfg.clip, text_enabled=True),
    )


@contextlib.contextmanager
def switches(env=None):
    """Run a phase with exactly the switches in `env` set (none by default)
    and restore the environment afterwards, so no phase leaks a switch."""
    saved = {k: os.environ.get(k) for k in SWITCH_VARS}
    try:
        for k in SWITCH_VARS:
            os.environ.pop(k, None)
        os.environ.update(env or {})
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def switch_kernels(env=None) -> tuple:
    """The kernels that the switches in `env` select."""
    env = env or {}
    gn = {"pallas": "group_norm", "fast": "group_norm_stats"}.get(env.get("EMOX_GROUPNORM_IMPL", ""))
    return tuple(k for k in (gn, "ln_qkv" if env.get("EMOX_LN_QKV", "0") != "0" else None) if k)


def check_path_launches(name: str, counts: dict, train: bool, what: str, env=None, dtype: str = "bfloat16") -> None:
    """Every kernel of the configuration's path launched, with those the
    switches select; the other configuration's attention kernels, the
    kernels of switches left off and K6 (on no model path) never; under
    EMOX_FF_IMPL=xla not the fused FF either, under EMOX_ATTENTION_IMPL=xla
    no attention kernel. Every forward launch of either layout went through
    exactly one kernel, the one for the type (dtype): FWD_SOURCES, bf16 never
    on flash_fwd_d512_f32, no model path on the wide kernels (no preset
    reaches a head dim above 512); every backward launch (train) too: BWD_SOURCES, none
    without training; every FF call on the FF kernel of the type:
    FF_SOURCES; every K7 call on the K7 kernel of the type: QKV_SOURCES."""
    env = env or {}
    on = switch_kernels(env)
    other = [k for n, ks in ATTN_KERNELS.items() if n != name for k in ks]
    other += [k for k in SWITCH_KERNELS if k not in on] + ["geglu_ff"]
    qkv = QKV_SOURCES[dtype]
    other += [k for k in QKV_SOURCES.values() if k != qkv or "ln_qkv" not in on]
    if "ln_qkv" in on:
        on += (qkv,)
    ff = FF_SOURCES[dtype]
    other += [k for k in FF_SOURCES.values() if k != ff]
    if env.get("EMOX_FF_IMPL") == "xla":
        other += ["ln_geglu_ff", ff]
    fwd = {"bfloat16": "flash_fwd_sm90", "float32": "flash_fwd_f32_sm90"}[dtype]
    other += [k for k in ("flash_fwd_sm90", "flash_fwd_f32_sm90", "flash_fwd_wide") if k != fwd]
    if dtype == "bfloat16":
        other.append("flash_fwd_d512_f32")
    bwd = {"bfloat16": "flash_bwd_sm90", "float32": "flash_bwd_f32_sm90"}[dtype]
    other += [k for k in BWD_SOURCES if k != bwd or not train]
    if env.get("EMOX_ATTENTION_IMPL") == "xla":
        other += [*ATTN_KERNELS[name], *FWD_SOURCES, *BWD_SOURCES]
    need = tuple(k for k in (*FORWARD_KERNELS, fwd, ff) if k not in other)
    need += tuple(k for k in (ATTN_KERNELS[name][1], bwd) if train and k not in other) + on
    if min(counts[k] for k in need) <= 0 or any(counts[k] for k in other):
        raise AssertionError(f"{what}: kernels {need} must launch and {other} must not: {counts}")
    layouts, sources = counts["flash_attn_nlc_fwd"] + counts["flash_attn_fwd"], sum(counts[k] for k in FWD_SOURCES)
    if layouts != sources:
        raise AssertionError(f"{what}: {layouts} attention forwards but {sources} kernel launches: {counts}")
    layouts, sources = counts["flash_attn_nlc_bwd"] + counts["flash_attn_bwd"], sum(counts[k] for k in BWD_SOURCES)
    if layouts != sources:
        raise AssertionError(f"{what}: {layouts} attention backwards but {sources} kernel launches: {counts}")
    calls, sources = counts["ln_geglu_ff"] + counts["geglu_ff"], sum(counts[k] for k in FF_SOURCES.values())
    if calls != sources:
        raise AssertionError(f"{what}: {calls} FF calls but {sources} FF kernel launches: {counts}")
    calls, sources = counts["ln_qkv"], sum(counts[k] for k in QKV_SOURCES.values())
    if calls != sources:
        raise AssertionError(f"{what}: {calls} K7 calls but {sources} K7 kernel launches: {counts}")


def norm_launches_per_request(cfg, steps: int, env) -> dict:
    """Exact launches of the switch kernels in one serving request, from the
    code: every GroupNorm of the VAE encode (the reference image), the
    writer (one batched pass for all steps), the reader (one CFG-batched
    pass per step) and the VAE decode (one call, decode_chunk 0) goes
    through FusedGroupNorm; every TransformerBlock self-attention (writer
    and reader) and every temporal attention (reader) takes K7.
      UNet: 2 per ResBlock (L*lpb down, 2 mid, L*(lpb+1) up), 1 per spatial
            transformer site, 1 norm_out;
      VAE:  2 per ResBlock (encoder L*nrb + 2, decoder 2 + L*(nrb+1)), 1 mid
            attention, 1 norm_out, each."""
    m = cfg.model
    levels, lpb = len(m.block_channels), m.layers_per_block
    sites = len(m.attention_levels) * (2 * lpb + 1) + 1
    unet_gn = 2 * (levels * lpb + 2 + levels * (lpb + 1)) + sites + 1
    enc_gn, dec_gn = vae_group_norms(cfg)
    gn = enc_gn + unet_gn * (1 + steps) + dec_gn
    qkv = sites * (1 + steps * (2 if m.use_temporal else 1))
    want = dict.fromkeys(SWITCH_KERNELS, 0)
    for k in switch_kernels(env):
        want[k] = qkv if k == "ln_qkv" else gn
    return want


def vae_group_norms(cfg) -> tuple:
    """The GroupNorm calls of one VAE encode and of one decode: 2 per
    ResBlock (encoder L*nrb + 2, decoder 2 + L*(nrb+1)), 1 mid attention,
    1 norm_out, each."""
    v = cfg.vae
    vlevels, nrb = len(v.channel_multipliers), v.num_res_blocks
    return 2 * (vlevels * nrb + 2) + 2, 2 * (2 + vlevels * (nrb + 1)) + 2


def reader_calls(cfg, steps: int, frames: int) -> int:
    """The reader's CFG-batched predict_noise calls in one request of
    `frames` frames: one per DDIM step for a clip of one context window;
    for a longer clip, per step one per group of WINDOWS_PER_CALL real
    windows of the step's window plan."""
    from emox_torch.diffusion.context import window_plan
    from emox_torch.infer.pipeline import WINDOWS_PER_CALL

    icfg = cfg.inference
    if frames <= icfg.context_frames:
        return steps
    plan = window_plan(steps, frames, icfg.context_frames, icfg.context_stride, icfg.context_overlap)
    return sum(-(-int((w > 0).sum()) // WINDOWS_PER_CALL) for w in plan.weights)


def attn_launches_per_request(cfg, calls: int) -> dict:
    """Exact launches of the attention forward kernels in one serving
    request whose reader makes `calls` predict_noise calls (the steps for a
    clip of one window, reader_calls for a longer one), from the code. A
    site takes a kernel where its K/V length reaches KERNEL_MIN_KV: the
    packed one (K1) for a head dim % 64 == 0, the strided one (K5)
    otherwise. The sites: every spatial transformer (2 * lpb + 1 per
    attention level, and the mid block at the deepest level) in the writer
    (one batched pass for all steps, Lk = the level's tokens) and in each
    reader call (CFG-batched, the reference tokens appended: Lk = 2 x
    tokens); the VAE's single-head mid-attention, head dim its last width,
    at the encode of the reference image and at the decode (decode_chunk
    0), Lk = the latent's tokens. Text, audio and temporal attention stay
    far below the cutoff."""
    from emox_torch.ops.attention import KERNEL_MIN_KV

    m, v = cfg.model, cfg.vae
    lat = cfg.data.height // v.downscale
    kernel = lambda d: "flash_attn_nlc_fwd" if d % 64 == 0 else "flash_attn_fwd"
    head_dim = lambda ch: ch // m.attention_heads if m.attention_heads > 0 else m.attention_head_dim
    sites = [(level, 2 * m.layers_per_block + 1) for level in m.attention_levels]
    sites.append((len(m.block_channels) - 1, 1))
    want = {"flash_attn_nlc_fwd": 0, "flash_attn_fwd": 0}
    for level, count in sites:
        tokens = (lat >> level) ** 2
        for lk, passes in ((2 * tokens, calls), (tokens, 1)):  # reader, writer
            if lk >= KERNEL_MIN_KV:
                want[kernel(head_dim(m.block_channels[level]))] += count * passes
    if lat * lat >= KERNEL_MIN_KV:
        want[kernel(v.base_channels * v.channel_multipliers[-1])] += 2
    return want


def fwd_sources_per_request(cfg, calls: int) -> dict:
    """The same launches by kernel in a bf16 request: every site, the VAE's
    head-dim-512 mid-attention included, on flash_fwd_sm90."""
    return {"flash_fwd_sm90": sum(attn_launches_per_request(cfg, calls).values()), "flash_fwd_f32_sm90": 0,
            "flash_fwd_d512_f32": 0, "flash_fwd_wide": 0}


def ff_launches_per_request(cfg, calls: int) -> int:
    """Exact FF sub-layers (fused_ln_geglu_ff calls) in one serving request
    whose reader makes `calls` predict_noise calls, from the code: one per
    TransformerBlock, so as many as K7's sites (norm_launches_per_request):
    every spatial transformer of the writer (one batched pass) and, per
    reader call, of the reader and its temporal ones."""
    m = cfg.model
    sites = len(m.attention_levels) * (2 * m.layers_per_block + 1) + 1
    return sites * (1 + calls * (2 if m.use_temporal else 1))


def train_step_sublayers(cfg) -> int:
    """Exact TransformerBlock calls in one stage-2 loss-and-gradient step
    with remat, each one FF sub-layer (and, under EMOX_LN_QKV, one K7 call),
    from the code: the forward's writer pass and one reader call
    (ff_launches_per_request), then remat's recompute in the backward of
    every reader block whose output carries a gradient: the temporal ones
    (stage 2 trains them) and every spatial one but the first, which no
    trained parameter precedes. The writer is frozen."""
    m = cfg.model
    sites = len(m.attention_levels) * (2 * m.layers_per_block + 1) + 1
    return ff_launches_per_request(cfg, 1) + sites + (sites - 1)


def step_sublayer_launches(cfg, sublayers: int, env=None) -> dict:
    """The float32 FF's and K7's launches expected in a float32 step of
    `sublayers` TransformerBlock calls: every FF sub-layer on the float32
    FF kernel and, with EMOX_LN_QKV on, every K7 call on the float32 K7
    kernel."""
    want = {"ln_geglu_ff": sublayers, FF_SOURCES["float32"]: sublayers}
    if "ln_qkv" in switch_kernels(env):
        want.update({"ln_qkv": sublayers, QKV_SOURCES["float32"]: sublayers})
    return want


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of fn, without the host's cost of issuing it:
    `iters` calls captured in one CUDA graph (the kernels' ctypes launches
    go onto the capturing stream that their wrappers pass them), the graph
    replayed once to warm up, then once between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def _same_bits(a, b) -> bool:
    """Two tuples of tensors hold the same bits."""
    import torch

    return all(torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)) for x, y in zip(a, b))


# ---- phase 1 ------------------------------------------------------------------
def phase_build(out_dir):
    from emox_torch.ops import build

    t0 = time.perf_counter()
    info = build.build()
    secs = time.perf_counter() - t0
    regs = {}
    for name, i in info.items():
        regs[name] = [ln.split("ptxas info    : ")[-1] for ln in i["ptxas"].splitlines() if "Used" in ln]
        if out_dir:
            with open(os.path.join(out_dir, f"ptxas_{name}.txt"), "w") as f:
                f.write(i["ptxas"])
    emit({"phase": "build", "seconds": round(secs, 3),
          "per_kernel_s": {n: round(i["seconds"], 3) for n, i in info.items()}, "ptxas": regs})


# ---- phase 2 ------------------------------------------------------------------
def _rand(gen, *shape, scale=1.0, dtype=None, shift=0.0):
    import torch

    t = torch.randn(shape, generator=gen, device="cuda") * scale + shift
    return t if dtype is None else t.to(dtype)


def _by_rows(fn, chunk, *tensors):
    """fn (a plain version, per sample along dim 0) over row chunks of the
    batch, its outputs concatenated: the same function in pieces, so that
    its fp32 [Lq, Lk] maps fit the card at the 512^2 shapes."""
    import torch

    n = tensors[0].shape[0]
    chunk = chunk or n
    parts = [fn(*(t[i:i + chunk] for t in tensors)) for i in range(0, n, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _sdpa_backend(q, k, v) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    names = {int(val): name for name, val in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v)), "unknown")


def _fwd_kernel(dtype, d: int) -> str:
    """The kernel that takes an attention forward of this type and head dim
    (either layout): emox_torch.ops.attention's routing."""
    import torch

    if d > 512:
        return "flash_fwd_wide"
    if dtype == torch.bfloat16:
        return "flash_fwd_sm90"
    return "flash_fwd_d512_f32" if d > 256 else "flash_fwd_f32_sm90"


def _padded(d: int, multiple: int = 64) -> int:
    return -(-d // multiple) * multiple


def _issued_flops(kernel: str, dtype, n: int, heads: int, lq: int, lk: int, d: int, sms: int = 0) -> float:
    """The bf16 tensor-core work a kernel issues for one call (the bound of
    its own products, beside the function's): the head dim padded as the
    kernel pads it, S shared by two warpgroups or S and dP recomputed where
    its kernels do, and three products for each on float32's two-part split.
    sms: the SMs the wide kernels' plans take (default: the card's)."""
    unit = 2.0 * n * heads * lq * lk  # one [Lq, Lk] product over one head-dim column
    parts = _parts(dtype)
    if kernel in ("flash_fwd_wide", "flash_bwd_wide"):
        import torch
        from emox_torch.ops import attention

        slices, width, depth = -(-d // 128), _padded(d, 128), _padded(d)
        # the plan takes the operand parts (float32's hi and lo), not the products
        plan = (attention.wide_plan(n, heads, lq, lk, d, 2 if dtype == torch.float32 else 1, sms) if sms
                else attention.card_wide_plan(n, heads, lq, lk, d, dtype, 0))
        fwd = plan["fwd"]
        if kernel == "flash_fwd_wide" and fwd["cluster"] > 1:  # S once, then P v, over the slices' columns
            return unit * 2 * fwd["width"] * parts
        if kernel == "flash_bwd_wide" and plan["dq"]["cluster"] > 1:  # S and dP once in each kernel, 7 products
            return unit * 7 * plan["dq"]["width"] * parts
        # every slice's block: S (and dP) over every 64-column chunk, then its slice's products
        products = slices * depth + width if kernel == "flash_fwd_wide" else 2 * slices * depth * 2 + 3 * width
        return unit * products * parts
    if kernel == "flash_fwd_sm90":  # d 512: both warpgroups compute S
        return unit * (3 * 512 if d > 256 else 2 * _padded(d))
    if kernel == "flash_fwd_f32_sm90":  # d 129-256: both warpgroups compute S, at 256 columns
        return unit * (3 * 256 if d > 128 else 2 * _padded(d)) * parts
    if kernel == "flash_fwd_d512_f32":
        return unit * 2 * 512 * parts
    dp = 512 if d > 256 else (256 if d > 128 else _padded(d))
    return unit * 7 * dp * parts  # the backward pairs (and four): S and dP in both kernels, 7 products


def _peak(dtype) -> float:
    import torch

    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def check_flash(gen, n, lq, lk, c=320, heads=5, dtype=None, timing=True, chunk=0, repeat=False):
    """The packed layout's forward (flash_attention_nlc: the kernel of
    _fwd_kernel) against attention_nlc_plain (fp32 math on the same inputs,
    over batch chunks of `chunk` rows where the full batch's maps would not
    fit); with repeat, twice on the same inputs (the same bits of out and
    lse)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.attention import attention_nlc_plain, flash_attention_nlc

    dtype = dtype or torch.bfloat16
    d = c // heads
    scale = d ** -0.5
    q, k, v = (_rand(gen, n, l, c, dtype=dtype) for l in (lq, lk, lk))
    out, lse = flash_attention_nlc(q, k, v, heads, return_lse=True)
    torch.cuda.synchronize()
    plain = lambda *a: attention_nlc_plain(*a, heads, scale)
    ref, ref_lse = _by_rows(plain, chunk, q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if dtype == torch.bfloat16:
        # P and the output are rounded to bf16: a few bf16 steps at the
        # largest output value
        tol = 4 * BF16_EPS * ref.abs().max().item()
    else:
        tol = 2e-4 * max(ref.abs().max().item(), 1.0)  # 3xTF32: float32-level sums
    res = {"kernel": _fwd_kernel(dtype, d), "layout": "packed", "dtype": str(dtype).split(".")[-1], "n": n,
           "lq": lq, "lk": lk, "c": c, "heads": heads, "head_dim": d, "max_abs_err": err, "tol": tol,
           "lse_max_abs_err": lse_err, "lse_tol": 1e-3}
    del ref, ref_lse
    if repeat:
        res["bit_identical"] = _same_bits((out, lse), flash_attention_nlc(q, k, v, heads, return_lse=True))
    if not (err <= tol and lse_err <= 1e-3 and math.isfinite(err) and res.get("bit_identical", True)):
        emit(res)
        raise AssertionError(f"{res['kernel']} (packed) disagrees with its plain version: {res}")
    if timing:
        flops = 4.0 * n * heads * lq * lk * d
        nbytes = q.element_size() * (2 * n * lq * c + 2 * n * lk * c) + 4 * n * lq * heads
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
        res["ms"] = time_ms(lambda: flash_attention_nlc(q, k, v, heads), iters=20 if flops < 1e12 else 5)
        res["plain_ms"] = time_ms(lambda: _by_rows(plain, chunk, q, k, v), iters=3, warmup=1)
        if chunk:
            res["plain_rows_per_call"] = chunk
        split = lambda t: t.view(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=20)
        res["library_backend"] = _sdpa_backend(qh, kh, vh)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        _device_extras(res, dtype, n, heads, lq, lk, d, nbytes, lambda: flash_attention_nlc(q, k, v, heads))
    emit(res)
    return res


# the kernels whose rows carry device_ms, the bound of the products they
# issue and their launch plan
DEVICE_TIMED = ("flash_fwd_f32_sm90", "flash_fwd_d512_f32", "flash_fwd_wide", "flash_bwd_f32_sm90",
                "flash_bwd_d256_sm90", "flash_bwd_d512_sm90", "flash_bwd_d512_f32", "flash_bwd_wide")


def _device_extras(res, dtype, n, heads, lq, lk, d, nbytes, run) -> None:
    """For the kernels of DEVICE_TIMED: device_ms of run() (the wrapper: split
    launches, padding and delta included), the bound of the products the
    kernel issues (issued_bound_ms) and its grid and shared memory."""
    import torch
    from emox_torch.ops import attention

    kernel = res["kernel"]
    if kernel not in DEVICE_TIMED:
        return
    res["issued_bound_ms"] = bound(_issued_flops(kernel, dtype, n, heads, lq, lk, d), nbytes)[0]
    parts = 2 if dtype == torch.float32 else 1
    if kernel == "flash_fwd_d512_f32":
        plan = attention.fwd_d512_f32_plan(n, heads, lq, lk)
        res.update(_d512_plan(plan, plan["cluster"]))
    elif kernel in ("flash_bwd_d512_sm90", "flash_bwd_d256_sm90", "flash_bwd_d512_f32"):
        shape = {"flash_bwd_d512_sm90": (), "flash_bwd_d256_sm90": (128, parts), "flash_bwd_d512_f32": (128, 2, 4)}
        plan = attention.bwd_d512_plan(n, heads, lq, lk, *shape[kernel])
        res.update(_d512_plan(plan["dq"], plan["cluster"]), dkv_grid_blocks=math.prod(plan["dkv"]["grid"]),
                   dkv_smem_bytes=plan["dkv"]["smem"])
    elif kernel in ("flash_fwd_wide", "flash_bwd_wide"):
        plan = attention.card_wide_plan(n, heads, lq, lk, d, dtype, 0)
        first = plan["fwd" if kernel == "flash_fwd_wide" else "dq"]
        res.update(grid_blocks=math.prod(first["grid"]), smem_bytes=first["smem"], slices=first["slices"],
                   slice_cols=first["slice_cols"], cluster=first["cluster"], stages=first["stages"])
        if kernel == "flash_fwd_wide":
            res.update(key_parts=first["key_parts"])
        if kernel == "flash_bwd_wide":
            res.update(dkv_grid_blocks=math.prod(plan["dkv"]["grid"]), dkv_smem_bytes=plan["dkv"]["smem"],
                       dkv_cluster=plan["dkv"]["cluster"], stream_parts=[first.get("stream_parts", 1),
                                                                         plan["dkv"].get("stream_parts", 1)])
    else:
        plan = attention.f32_plan(n, heads, lq, lk, d)
        first = plan["fwd" if kernel == "flash_fwd_f32_sm90" else "dq"]
        res.update(grid_blocks=math.prod(first["grid"]), smem_bytes=first["smem"])
        if kernel == "flash_bwd_f32_sm90":
            res.update(dkv_grid_blocks=math.prod(plan["dkv"]["grid"]), dkv_smem_bytes=plan["dkv"]["smem"])
    res["device_ms"] = device_ms(run, iters=10)


def _bwd_kernel(dtype, d: int) -> str:
    """The kernel that takes an attention backward of this type and head dim
    (either layout): emox_torch.ops.attention's routing."""
    import torch

    if d > 512:
        return "flash_bwd_wide"
    if d > 256:  # 257-511 are padded to 512
        return "flash_bwd_d512_sm90" if dtype == torch.bfloat16 else "flash_bwd_d512_f32"
    if d > 128:
        return "flash_bwd_d256_sm90"
    return "flash_bwd_sm90" if dtype == torch.bfloat16 else "flash_bwd_f32_sm90"


def _check_grads(res, run, want, dtype, need_dq: bool, need_dkv: bool, repeat: bool) -> bool:
    """The backward checks both layouts share: one call of run() (the
    wrapper) launches the kernel of res["kernel"] once and the other
    backward kernel never, returns exactly the gradients asked for, and each
    is within the tolerance of want's (the plain version's); with repeat, a
    second call on the same inputs gives the same bits. Fills res."""
    import torch
    from emox_torch.ops import launch_counts

    before = launch_counts()
    got = run()
    torch.cuda.synchronize()
    after = launch_counts()
    res["launched"] = {k: after[k] - before[k] for k in BWD_SOURCES}
    ok = res["launched"] == {k: int(k == res["kernel"]) for k in BWD_SOURCES}
    asked = dict(zip(("dq", "dk", "dv"), (need_dq, need_dkv, need_dkv)))
    for (name, on), g, w in zip(asked.items(), got, want):
        ok = ok and (g is not None) == on
        if g is None:
            continue
        err = (g.float() - w).abs().max().item()
        # bf16: P and dS are rounded to bf16 for the products and the output
        # once: a few bf16 steps at the largest value; float32: 3xTF32 sums
        tol = (4 * BF16_EPS if dtype == torch.bfloat16 else 2e-4) * w.abs().max().item()
        res[f"{name}_max_abs_err"], res[f"{name}_tol"] = err, tol
        ok = ok and math.isfinite(err) and err <= tol
    res["max_abs_err"] = max(res[f"{x}_max_abs_err"] for x, on in asked.items() if on)
    if repeat:
        again = run()
        res["bit_identical"] = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        ok = ok and res["bit_identical"]
    return ok


def check_flash_bwd(gen, n, lq, lk, c=320, heads=5, dtype=None, timing=True, chunk=0, need_dq=True,
                    need_dkv=True, repeat=False):
    """K4: dq, dk, dv of flash_attention_nlc_bwd (the kernel of _bwd_kernel)
    against the plain version (fp32 math on the same inputs, over batch
    chunks of `chunk` rows where needed), from the fp32 forward's lse and its
    output rounded to the input type; only the gradients asked for (need_dq,
    need_dkv)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.attention import attention_nlc_bwd_plain, attention_nlc_plain, flash_attention_nlc_bwd

    dtype = dtype or torch.bfloat16
    d = c // heads
    scale = d ** -0.5
    q, k, v = (_rand(gen, n, l, c, dtype=dtype) for l in (lq, lk, lk))
    dout = _rand(gen, n, lq, c, dtype=dtype)
    o32, lse = _by_rows(lambda *a: attention_nlc_plain(*a, heads, scale), chunk, q.float(), k.float(), v.float())
    o = o32.to(dtype)
    del o32
    plain = lambda *a: attention_nlc_bwd_plain(*a, heads, scale)
    want = _by_rows(plain, chunk, q.float(), k.float(), v.float(), o.float(), lse, dout.float())
    res = {"kernel": _bwd_kernel(dtype, d), "layout": "packed", "dtype": str(dtype).split(".")[-1], "n": n,
           "lq": lq, "lk": lk, "c": c, "heads": heads, "head_dim": d, "need_dq": need_dq, "need_dkv": need_dkv}
    if res["kernel"] == "flash_bwd_wide":  # the cluster plan (slices, width, stages, parts), [] the slice kernels
        from emox_torch.ops import attention

        res["bwd_plan"] = list(attention.cluster_bwd_args(attention.card_wide_plan(n, heads, lq, lk, d, dtype, 0)))
    run = lambda: flash_attention_nlc_bwd(q, k, v, o, lse, dout, heads, scale, need_dq=need_dq, need_dkv=need_dkv)
    ok = _check_grads(res, run, want, dtype, need_dq, need_dkv, repeat)
    del want
    if not ok:
        emit(res)
        raise AssertionError(f"{res['kernel']} (packed) disagrees with its plain version: {res}")
    if timing:
        flops = 10.0 * n * heads * lq * lk * d
        nbytes = q.element_size() * n * c * (4 * lq + 4 * lk) + 4 * n * lq * heads
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
        res["ms"] = time_ms(lambda: flash_attention_nlc_bwd(q, k, v, o, lse, dout, heads, scale),
                            iters=10 if flops < 2e12 else 3)
        res["plain_ms"] = time_ms(lambda: _by_rows(plain, chunk, q, k, v, o, lse, dout), iters=3, warmup=1)
        if chunk:
            res["plain_rows_per_call"] = chunk
        split = lambda t: t.view(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
        qh, kh, vh = (split(t).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh)
        g = split(dout)
        res["library_ms"] = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True),
                                    iters=10)
        res["library_backend"] = _sdpa_backend(qh, kh, vh)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        del out
        _device_extras(res, dtype, n, heads, lq, lk, d, nbytes,
                       lambda: flash_attention_nlc_bwd(q, k, v, o, lse, dout, heads, scale))
    emit(res)
    return res


def _d512_plan(launch: dict, cluster: int) -> dict:
    """A head-dim-512 launch's grid, shared memory and cluster, as the
    kernels line reports them."""
    return {"grid_blocks": math.prod(launch["grid"]), "smem_bytes": launch["smem"], "cluster": cluster}


def _packed_heads(gen, n, l, heads, d, dtype):
    """Packed tokens [n, l, heads*d] and their head-split view [n, heads, l, d]
    (strided, no copy), as the nn modules hand them to the strided kernels."""
    t = _rand(gen, n, l, heads * d, dtype=dtype)
    return t.view(n, l, heads, d).transpose(1, 2)


def check_flash_strided(gen, n, lq, lk, heads=8, d=40, dtype=None, timing=True, repeat=False):
    """The strided layout's forward (flash_attention: the kernel of
    _fwd_kernel) on head-split views of packed tokens against its plain
    version (fp32 math on the same inputs); with repeat, twice on the same
    inputs (the same bits)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.attention import attention_plain, flash_attention

    dtype = dtype or torch.bfloat16
    scale = d ** -0.5
    q, k, v = (_packed_heads(gen, n, l, heads, d, dtype) for l in (lq, lk, lk))
    assert not q.is_contiguous() and q.stride() == (lq * heads * d, d, heads * d, 1)
    out, lse = flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # as K1: a few bf16 steps at the largest output value; 3xTF32 sums in float32
    tol = (4 * BF16_EPS * ref.abs().max().item() if dtype == torch.bfloat16
           else 2e-4 * max(ref.abs().max().item(), 1.0))
    res = {"kernel": _fwd_kernel(dtype, d), "layout": "strided", "dtype": str(dtype).split(".")[-1], "n": n,
           "lq": lq, "lk": lk, "c": heads * d, "heads": heads, "head_dim": d, "max_abs_err": err, "tol": tol,
           "lse_max_abs_err": lse_err, "lse_tol": 1e-3, "out_strides_packed": out.stride() == q.stride()}
    if repeat:
        res["bit_identical"] = _same_bits((out, lse), flash_attention(q, k, v, return_lse=True))
    if not (err <= tol and lse_err <= 1e-3 and math.isfinite(err) and res.get("bit_identical", True)):
        emit(res)
        raise AssertionError(f"{res['kernel']} (strided) disagrees with its plain version: {res}")
    if timing:
        flops = 4.0 * n * heads * lq * lk * d
        nbytes = q.element_size() * n * heads * d * (2 * lq + 2 * lk) + 4 * n * lq * heads
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
        res["ms"] = time_ms(lambda: flash_attention(q, k, v), iters=20)
        res["plain_ms"] = time_ms(lambda: attention_plain(q, k, v, scale), iters=3, warmup=1)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=20)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        _device_extras(res, dtype, n, heads, lq, lk, d, nbytes, lambda: flash_attention(q, k, v))
    emit(res)
    return res


def check_flash_strided_bwd(gen, n, lq, lk, heads=8, d=40, dtype=None, timing=True, need_dq=True,
                            need_dkv=True, repeat=False):
    """K5 backward: dq, dk, dv of flash_attention_bwd (the kernel of
    _bwd_kernel) on head-split views against the plain version (fp32 math
    on the same inputs), from the fp32 forward's lse and its output rounded
    to the input type; only the gradients asked for; with repeat, twice on
    the same inputs (the same bits)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.attention import attention_bwd_plain, attention_plain, flash_attention_bwd

    dtype = dtype or torch.bfloat16
    scale = d ** -0.5
    q, k, v = (_packed_heads(gen, n, l, heads, d, dtype) for l in (lq, lk, lk))
    dout = _packed_heads(gen, n, lq, heads, d, dtype)
    o32, lse = attention_plain(q.float(), k.float(), v.float(), scale)
    o = o32.to(dtype)
    del o32
    want = attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, dout.float(), scale)
    res = {"kernel": _bwd_kernel(dtype, d), "layout": "strided", "dtype": str(dtype).split(".")[-1], "n": n,
           "lq": lq, "lk": lk, "c": heads * d, "heads": heads, "head_dim": d, "need_dq": need_dq,
           "need_dkv": need_dkv}
    run = lambda: flash_attention_bwd(q, k, v, o, lse, dout, scale, need_dq=need_dq, need_dkv=need_dkv)
    ok = _check_grads(res, run, want, dtype, need_dq, need_dkv, repeat)
    del want
    if not ok:
        emit(res)
        raise AssertionError(f"{res['kernel']} (strided) disagrees with its plain version: {res}")
    if timing:
        flops = 10.0 * n * heads * lq * lk * d
        nbytes = q.element_size() * n * heads * d * (4 * lq + 4 * lk) + 4 * n * lq * heads
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
        res["ms"] = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, scale), iters=10)
        res["plain_ms"] = time_ms(lambda: attention_bwd_plain(q, k, v, o, lse, dout, scale), iters=3, warmup=1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg)
        res["library_ms"] = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True),
                                    iters=10)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        del out
        _device_extras(res, dtype, n, heads, lq, lk, d, nbytes,
                       lambda: flash_attention_bwd(q, k, v, o, lse, dout, scale))
    emit(res)
    return res


def _ff_kernel(dtype) -> str:
    """The kernel that takes either FF function in this type:
    emox_torch.ops.ff's routing."""
    import torch

    return FF_SOURCES[str(dtype).split(".")[-1]]


def _ff_plan(m, c, f, dtype) -> dict:
    """The launch geometry of the FF kernel of this type, against the card's SMs."""
    import torch
    from emox_torch.ops.ff import ff_f32_sm90_plan, ff_sm90_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ff_sm90_plan if dtype == torch.bfloat16 else ff_f32_sm90_plan
    return dict(plan(m, c, f, sms), sms=sms)


def _parts(dtype) -> int:
    """The bf16 products a kernel issues for each product of the function:
    3 on float32's two-part split (hi hi + hi lo + lo hi), else 1."""
    import torch

    return 3 if dtype == torch.float32 else 1


def _time_ff(res, run, plain, unfused, flops, nbytes, dtype):
    """The FF checks' times: the kernel's (CUDA events, and device_ms from
    calls in one CUDA graph), its bounds (the function on the type's peak:
    float32 on the CUDA cores; the bf16 products it issues, issued_bound_ms),
    the plain version's, and the unfused route's that EMOX_FF_IMPL=xla takes
    (host and device time)."""
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
    res["issued_bound_ms"] = _parts(dtype) * flops / PEAK_BF16_FLOPS * 1e3
    res["ms"] = time_ms(run, iters=10)
    res["device_ms"] = device_ms(run)
    res["plain_ms"] = time_ms(plain, iters=3, warmup=1)
    res["library_ms"] = None  # no single PyTorch call computes the gated FF
    res["unfused_ms"] = time_ms(unfused, iters=10)
    res["unfused_device_ms"] = device_ms(unfused)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["device_tflops"] = flops / (res["device_ms"] * 1e-3) / 1e12


def _check_ff_out(res, out, again, ref, dtype, what):
    """Within a few bf16 steps (float32: 2e-4) of the plain version's largest
    value, and with `again` (the same call repeated) the same bits."""
    import torch

    res["max_abs_err"] = err = (out.float() - ref).abs().max().item()
    res["tol"] = tol = _tol(ref, dtype)  # xn, h and y rounded to bf16; float32: 3xTF32 sums
    if again is not None:
        res["same_bits"] = bool(torch.equal(out, again))
    if not (err <= tol and math.isfinite(err)) or res.get("same_bits") is False:
        emit(res)
        raise AssertionError(f"{what} disagrees with its plain version or with itself: {res}")


def check_ff(gen, m, c, dtype=None, timing=True, repeat=False):
    """fused_ln_geglu_ff (ff_sm90 in bf16, ff_f32_sm90 in float32) against
    ln_geglu_ff_plain on x [m, c] with F = 4C; with repeat, twice on the
    same inputs for the same bits. Timed (_time_ff): the kernel, the plain
    version and the unfused route EMOX_FF_IMPL=xla takes (ln_geglu_ff_xla)."""
    import torch
    from emox_torch.ops.ff import fused_ln_geglu_ff, ln_geglu_ff_plain, ln_geglu_ff_xla

    dtype = dtype or torch.bfloat16
    f = 4 * c
    args = (
        _rand(gen, m, c, dtype=dtype),
        _rand(gen, c, scale=0.1, shift=1.0, dtype=dtype), _rand(gen, c, scale=0.1, dtype=dtype),
        _rand(gen, 2 * f, c, scale=c ** -0.5, dtype=dtype), _rand(gen, 2 * f, scale=0.1, dtype=dtype),
        _rand(gen, c, f, scale=f ** -0.5, dtype=dtype), _rand(gen, c, scale=0.1, dtype=dtype),
    )
    out = fused_ln_geglu_ff(*args)
    again = fused_ln_geglu_ff(*args) if repeat else None
    torch.cuda.synchronize()
    ref = ln_geglu_ff_plain(*(a.float() for a in args))
    res = {"kernel": _ff_kernel(dtype), "function": "ln_geglu_ff", "dtype": str(dtype).split(".")[-1], "m": m,
           "c": c, "f": f}
    _check_ff_out(res, out, again, ref, dtype, "fused_ln_geglu_ff")
    del ref, again
    if timing:
        nbytes = args[0].element_size() * (2 * m * c + 3 * c * f + 2 * f + 3 * c)
        _time_ff(res, lambda: fused_ln_geglu_ff(*args), lambda: ln_geglu_ff_plain(*args),
                 lambda: ln_geglu_ff_xla(*args), 6.0 * m * c * f, nbytes, dtype)
        res.update(_ff_plan(m, c, f, dtype))
    emit(res)
    return res


def check_geglu_ff(gen, m, c, dtype=None, timing=True, repeat=False):
    """fused_geglu_ff (K6: ff_sm90 in bf16, ff_f32_sm90 in float32) against
    geglu_ff_plain (h rounded to x's type, fp32 products, the output rounded
    once) on x [m, c] with F = 4C; repeat and timing as check_ff."""
    import torch
    from emox_torch.ops.ff import fused_geglu_ff, geglu_ff_plain, geglu_ff_xla

    dtype = dtype or torch.bfloat16
    f = 4 * c
    args = (_rand(gen, m, c, dtype=dtype),
            _rand(gen, 2 * f, c, scale=c ** -0.5, dtype=dtype), _rand(gen, 2 * f, scale=0.1, dtype=dtype),
            _rand(gen, c, f, scale=f ** -0.5, dtype=dtype), _rand(gen, c, scale=0.1, dtype=dtype))
    out = fused_geglu_ff(*args)
    again = fused_geglu_ff(*args) if repeat else None
    torch.cuda.synchronize()
    ref = geglu_ff_plain(*(a.float() for a in args))
    res = {"kernel": _ff_kernel(dtype), "function": "geglu_ff", "dtype": str(dtype).split(".")[-1], "m": m,
           "c": c, "f": f}
    _check_ff_out(res, out, again, ref, dtype, "fused_geglu_ff")
    del ref, again
    if timing:
        nbytes = args[0].element_size() * (2 * m * c + 3 * c * f + 2 * f + c)
        _time_ff(res, lambda: fused_geglu_ff(*args), lambda: geglu_ff_plain(*args), lambda: geglu_ff_xla(*args),
                 6.0 * m * c * f, nbytes, dtype)
        res.update(_ff_plan(m, c, f, dtype))
    emit(res)
    return res


def _tol(ref, dtype):
    """A few bf16 steps at the output's largest value (the output is rounded
    to bf16 once); float32: 2e-4 of it (products on the two-part split keep
    about 16 bits of each operand, sums in another order)."""
    import torch

    top = ref.abs().max().item()
    return 4 * BF16_EPS * top if dtype == torch.bfloat16 else 2e-4 * max(top, 1.0)


def check_group_norm(gen, n, l, c, silu=True, dtype=None, timing=True, groups=32, repeat=False):
    """K8a against group_norm_plain (the same rounding: fp32 statistics and
    apply, one cast) on x [n, l, c]; its launch regime from gn_plan (one
    cluster launch, or two launches); with repeat, twice on the same inputs
    (the same bits)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.groupnorm import fused_group_norm, gn_plan_for, group_norm_plain

    dtype = dtype or torch.bfloat16
    x = _rand(gen, n, l, c, scale=3.0, shift=1.0, dtype=dtype)
    gamma, beta = _rand(gen, c, scale=0.1, shift=1.0, dtype=dtype), _rand(gen, c, scale=0.1, dtype=dtype)
    out = fused_group_norm(x, gamma, beta, groups, silu=silu)
    again = fused_group_norm(x, gamma, beta, groups, silu=silu) if repeat else out
    torch.cuda.synchronize()
    ref = group_norm_plain(x, gamma, beta, groups, silu=silu)
    err = (out.float() - ref.float()).abs().max().item()
    tol = _tol(ref.float(), dtype)
    regime, cluster, chunks = gn_plan_for(x, groups)
    res = {"kernel": "group_norm", "dtype": str(dtype).split(".")[-1], "n": n, "l": l, "c": c, "groups": groups,
           "silu": silu, "regime": regime, "cluster": cluster, "chunks": chunks,
           "max_abs_err": err, "tol": tol, "same_bits_twice": _same_bits((out,), (again,))}
    if not (err <= tol and math.isfinite(err) and res["same_bits_twice"]):
        emit(res)
        raise AssertionError(f"group_norm disagrees with its plain version or with itself: {res}")
    if timing:
        # per element: 3 operations for the statistics, 4 for the apply, 4 for SiLU, fp32 on the CUDA cores
        flops = n * l * c * (7 + (4 if silu else 0))
        nbytes = x.element_size() * (2 * n * l * c + 2 * c)
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, PEAK_FP32_FLOPS)
        run = lambda: fused_group_norm(x, gamma, beta, groups, silu=silu)
        res["ms"] = time_ms(run, iters=20)
        res["device_ms"] = device_ms(run)
        res["plain_ms"] = time_ms(lambda: group_norm_plain(x, gamma, beta, groups, silu=silu), iters=3, warmup=1)
        xt = x.transpose(1, 2)  # [n, c, l]: the layout F.group_norm normalises
        lib = (lambda: F.silu(F.group_norm(xt, groups, gamma, beta))) if silu else (
            lambda: F.group_norm(xt, groups, gamma, beta))
        res["library_ms"] = time_ms(lib, iters=20)
        res["library_device_ms"] = device_ms(lib)
        res["gb_per_s"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
    emit(res)
    return res


def check_group_norm_stats(gen, n, l, c, dtype=None, timing=True, repeat=False):
    """K8b against group_norm_stats_plain: per-channel fp32 sum and sum of
    squares over l; with repeat, twice on the same inputs (the same bits)."""
    import torch
    from emox_torch.ops.groupnorm import gn_plan_for, group_norm_stats, group_norm_stats_plain

    dtype = dtype or torch.bfloat16
    x = _rand(gen, n, l, c, scale=3.0, shift=1.0, dtype=dtype)
    got = group_norm_stats(x)
    again = group_norm_stats(x) if repeat else got
    torch.cuda.synchronize()
    want = group_norm_stats_plain(x)
    regime, cluster, chunks = gn_plan_for(x, apply=False)
    res = {"kernel": "group_norm_stats", "dtype": str(dtype).split(".")[-1], "n": n, "l": l, "c": c,
           "regime": regime, "cluster": cluster, "chunks": chunks, "same_bits_twice": _same_bits(got, again)}
    ok = res["same_bits_twice"]
    for name, g, w in zip(("sum", "sumsq"), got, want):
        err = (g - w).abs().max().item()
        tol = 2e-5 * w.abs().max().item()  # fp32 sums of the same values in another order
        res[f"{name}_max_abs_err"], res[f"{name}_tol"] = err, tol
        ok = ok and math.isfinite(err) and err <= tol
    res["max_abs_err"] = max(res["sum_max_abs_err"], res["sumsq_max_abs_err"])
    if not ok:
        emit(res)
        raise AssertionError(f"group_norm_stats disagrees with its plain version or with itself: {res}")
    if timing:
        flops = 3 * n * l * c
        nbytes = x.element_size() * n * l * c + 2 * 4 * n * c
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, PEAK_FP32_FLOPS)
        res["ms"] = time_ms(lambda: group_norm_stats(x), iters=20)
        res["device_ms"] = device_ms(lambda: group_norm_stats(x))
        res["plain_ms"] = time_ms(lambda: group_norm_stats_plain(x), iters=3, warmup=1)
        # the same statistics (per-channel mean and variance over l) in one call
        res["library_ms"] = time_ms(lambda: torch.var_mean(x, dim=1), iters=20)
        res["library_device_ms"] = device_ms(lambda: torch.var_mean(x, dim=1))
        res["gb_per_s"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
    emit(res)
    return res


def check_ln_qkv(gen, m, c, dtype=None, timing=True, repeat=False):
    """K7 against ln_qkv_plain (xn rounded to x's type, fp32 products, each
    output rounded once) on x [m, c] with three [c, c] projections: bf16 on
    ln_qkv_sm90, float32 on ln_qkv_f32_sm90 (each with its plan: tiles,
    blocks); with repeat, twice on the same inputs (the same bits). Timed:
    the kernel (device_ms too), its bounds (the function on the type's peak;
    the bf16 products it issues), the plain version, and LN + one matmul of
    the concatenated weights (the library)."""
    import torch
    import torch.nn.functional as F
    from emox_torch.ops.ln_qkv import fused_ln_qkv, ln_qkv_f32_sm90_plan, ln_qkv_plain, ln_qkv_sm90_plan

    dtype = dtype or torch.bfloat16
    args = (_rand(gen, m, c, dtype=dtype), _rand(gen, c, scale=0.1, shift=1.0, dtype=dtype),
            _rand(gen, c, scale=0.1, dtype=dtype), *(_rand(gen, c, c, scale=c ** -0.5, dtype=dtype) for _ in range(3)))
    got = fused_ln_qkv(*args)
    again = fused_ln_qkv(*args) if repeat else got
    torch.cuda.synchronize()
    want = ln_qkv_plain(*args)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    tol = max(_tol(w.float(), dtype) for w in want)
    bf16 = dtype == torch.bfloat16
    res = {"kernel": QKV_SOURCES["bfloat16" if bf16 else "float32"], "function": "ln_qkv",
           "dtype": str(dtype).split(".")[-1], "m": m, "c": c, "inner": c,
           "max_abs_err": err, "tol": tol, "same_bits_twice": _same_bits(got, again)}
    if bf16:
        plan = ln_qkv_sm90_plan(m, c, c, torch.cuda.get_device_properties(0).multi_processor_count)
        res.update(row_tile=plan["bm"], col_tile=plan["bn"], col_tiles_per_block=plan["per"],
                   grid_blocks=plan["blocks"])
    else:
        plan = ln_qkv_f32_sm90_plan(m, c, c)
        res.update(row_tile=plan["bm"], col_tile=plan["bn"], grid_blocks=plan["blocks"],
                   smem_bytes=plan["smem_bytes"])
    if not (err <= tol and math.isfinite(err) and res["same_bits_twice"]):
        emit(res)
        raise AssertionError(f"ln_qkv disagrees with its plain version or with itself: {res}")
    if timing:
        flops = 6.0 * m * c * c
        nbytes = args[0].element_size() * (m * c + 3 * m * c + 3 * c * c + 2 * c)
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, _peak(dtype))
        res["issued_bound_ms"] = _parts(dtype) * flops / PEAK_BF16_FLOPS * 1e3
        res["ms"] = time_ms(lambda: fused_ln_qkv(*args), iters=20)
        res["device_ms"] = device_ms(lambda: fused_ln_qkv(*args))
        res["plain_ms"] = time_ms(lambda: ln_qkv_plain(*args), iters=3, warmup=1)
        w_cat = torch.cat(args[3:])
        lib = lambda: torch.matmul(F.layer_norm(args[0], (c,), args[1], args[2]), w_cat.t())
        res["library_ms"] = time_ms(lib, iters=20)
        res["library_device_ms"] = device_ms(lib)
        res["tflops"] = flops / (res["device_ms"] * 1e-3) / 1e12
    emit(res)
    return res


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    # flash_fwd_sm90 on the packed layout (K1's sites): the reader's level-0
    # self-attention with the reference tokens appended (Lk = 2 * 1024),
    # without and with CFG, plus a ragged Lk; float32 takes flash_fwd_f32_sm90,
    # timed at the float32 step's site (batch 1 x 2 frames under CFG)
    results["flash_n16"] = check_flash(gen, 16, 1024, 2048)
    results["flash_n32"] = check_flash(gen, 32, 1024, 2048)
    # the windowed sampler's calls: 4 windows x 16 frames under CFG (N 128)
    results["flash_n128"] = check_flash(gen, 128, 1024, 2048, chunk=32)
    check_flash(gen, 4, 1000, 2000, timing=False)
    results["flash_f32_packed"] = check_flash(gen, 2, 1024, 2048, dtype=torch.float32)
    # the audio and temporal lengths (Lk 5 and 16), which the kernels take
    # under EMOX_ATTENTION_IMPL=pallas, on both layouts
    for lk in (5, 16):
        check_flash(gen, 32, 1024, lk, timing=False)
        check_flash_strided(gen, 32, 1024, lk, timing=False)
    # every class of head dim on both layouts, ragged Lq and Lk: 40, 80 and
    # 160 pad in shared memory to 64, 128 and 192 columns; 4 pads its rows
    # (16-byte alignment) in the wrapper first; float32 on flash_fwd_f32_sm90
    # (its split pads 40 to 64, 80 to 128, 160 to 256)
    for d in (40, 80, 128, 160, 256):
        check_flash(gen, 2, 1000, 2100, c=2 * d, heads=2, timing=False)
        check_flash_strided(gen, 2, 1000, 2100, heads=3, d=d, timing=False)
    check_flash_strided(gen, 2, 300, 333, heads=3, d=4, timing=False)
    for d in (4, 128, 160, 256):
        check_flash_strided(gen, 2, 1000, 2100, heads=2, d=d, dtype=torch.float32, timing=False)
    check_flash(gen, 2, 1000, 2100, c=256, heads=2, dtype=torch.float32, timing=False)
    # flash_fwd_f32_sm90 timed at K5's serving shape (the float32 step's route),
    # and both types at d 64 on the same shape: what padding d 40 to 64 costs
    results["flash_f32_n32"] = check_flash_strided(gen, 32, 1024, 2048, dtype=torch.float32)
    results["flash_f32_n32_d64"] = check_flash_strided(gen, 32, 1024, 2048, d=64, dtype=torch.float32)
    results["flash_strided_n32_d64"] = check_flash_strided(gen, 32, 1024, 2048, d=64)
    # ff_sm90 at the FF sub-layers under CFG at 16 frames: levels 0, 1, 2 and
    # mid at 256^2 (the mid block splits F in GEMM 2), then at 512^2; levels 0
    # and mid twice on the same inputs (the same bits); ragged M and M below
    # one 128-row tile; float32 on ff_f32_sm90, timed at the float32 step's
    # level 0 (batch 1 x 2 frames under CFG), then at every other float32
    # step and train step site (F32_STEP_SITES: at M 64, C 1280 GEMM 2 splits
    # F the most), ragged M, C 80 (parts padded to 128 columns) and C 1280;
    # step sites and ragged M twice (the same bits)
    results["ff_l0"] = check_ff(gen, 32768, 320, repeat=True)
    results["ff_l1"] = check_ff(gen, 8192, 640)
    results["ff_l2"] = check_ff(gen, 2048, 1280)
    results["ff_mid"] = check_ff(gen, 512, 1280, repeat=True)
    for key, (m, c) in (("ff_512_l0", (131072, 320)), ("ff_512_l1", (32768, 640)), ("ff_512_l2", (8192, 1280)),
                        ("ff_512_mid", (2048, 1280))):
        results[key] = check_ff(gen, m, c)
    check_ff(gen, 1000, 320, timing=False, repeat=True)
    check_ff(gen, 500, 1280, timing=False, repeat=True)
    check_ff(gen, 37, 640, timing=False)
    results["ff_f32"] = check_ff(gen, 4096, 320, dtype=torch.float32, repeat=True)
    for m, c in F32_STEP_SITES[1:]:
        check_ff(gen, m, c, dtype=torch.float32, timing=False, repeat=True)
    check_ff(gen, 1000, 320, dtype=torch.float32, timing=False, repeat=True)
    check_ff(gen, 500, 1280, dtype=torch.float32, timing=False)
    check_ff(gen, 37, 80, dtype=torch.float32, timing=False)
    # flash_bwd_sm90 at K4's level-0 reference-concat sites of training:
    # stage 2 (batch 2 x 8 frames; twice, the same bits) and stage 1 (batch 4)
    results["flash_bwd_n16"] = check_flash_bwd(gen, 16, 1024, 2048, repeat=True)
    results["flash_bwd_n4"] = check_flash_bwd(gen, 4, 1024, 2048)
    check_flash_bwd(gen, 4, 1000, 2100, timing=False)
    # every head-dim class it takes on both layouts (4 pads its rows in the
    # wrapper; 40 and 80 pad in shared memory to 64 and 128), ragged Lq and
    # Lk, with dq only and with dk/dv only
    for d in (4, 40, 64, 80, 128):
        for lq, lk in ((1000, 2100), (300, 333)):
            check_flash_bwd(gen, 2, lq, lk, c=2 * d, heads=2, timing=False)
            check_flash_strided_bwd(gen, 2, lq, lk, heads=3, d=d, timing=False)
        check_flash_bwd(gen, 2, 1000, 2100, c=2 * d, heads=2, timing=False, need_dkv=False)
        check_flash_strided_bwd(gen, 2, 1000, 2100, heads=3, d=d, timing=False, need_dq=False)
    # flash_bwd_f32_sm90 timed at the float32 train step's site (batch 1 x 2
    # frames), twice (the same bits), then float32 packed head dim 128 (dq
    # only, dk/dv only)
    results["flash_bwd_f32"] = check_flash_bwd(gen, 2, 1024, 2048, dtype=torch.float32, repeat=True)
    check_flash_bwd(gen, 2, 1000, 2100, c=256, heads=2, dtype=torch.float32, timing=False, need_dkv=False)
    check_flash_bwd(gen, 2, 1000, 2100, c=256, heads=2, dtype=torch.float32, timing=False, need_dq=False)
    # the strided layout (K5's sites, flash_fwd_sm90 in bf16) with the SD-1.5
    # head layout (8 heads), on head-split views of packed
    # tokens: the reader's level-0 site at 256^2 (d 40) under CFG in serving
    # and at batch 2 x 8 frames in training; d 80 (level 1 at 512^2), ragged
    # Lq and Lk, and float32
    results["flash_strided_n32"] = check_flash_strided(gen, 32, 1024, 2048)
    results["flash_strided_n16"] = check_flash_strided(gen, 16, 1024, 2048)
    check_flash_strided(gen, 4, 1024, 2048, d=80, timing=False)
    check_flash_strided(gen, 4, 1000, 2100, timing=False)
    check_flash_strided(gen, 2, 1024, 2048, dtype=torch.float32, timing=False)
    check_flash_strided(gen, 2, 1000, 2100, d=80, dtype=torch.float32, timing=False)
    # flash_bwd_sm90 at K5's site: the SD-1.5 head layout's level 0 (d 40) at
    # batch 2 x 8 frames, and d 80 (level 1 at 512^2)
    results["flash_strided_bwd_n16"] = check_flash_strided_bwd(gen, 16, 1024, 2048)
    check_flash_strided_bwd(gen, 2, 1024, 2048, d=80, timing=False)
    check_flash_strided_bwd(gen, 4, 1000, 2100, timing=False)
    # float32 (d 40, 80 on flash_bwd_f32_sm90; 160 on flash_bwd_d256_sm90);
    # flash_bwd_d256_sm90 in bf16 timed at SD-1.5's level 2 at 256^2 under
    # EMOX_ATTENTION_IMPL=pallas (d 160: batch 2 x 8 frames, Lq 256, Lk 512)
    # and at the small preset's VAE mid-attention in stage 5 at 256^2 (d 256,
    # batch 4, L 1024), each twice (the same bits); ragged at d 160 and 256,
    # dq only, dk/dv only, and the packed layout at d 192 (head-split views)
    check_flash_strided_bwd(gen, 2, 1024, 2048, dtype=torch.float32, timing=False)
    check_flash_strided_bwd(gen, 2, 1000, 2100, d=80, dtype=torch.float32, timing=False)
    check_flash_strided_bwd(gen, 2, 1000, 2100, d=160, dtype=torch.float32, timing=False)
    # float32 at the small VAE's stage-5 step at 128^2 (batch 1, 1024 tokens),
    # the kernel's main path
    results["flash_bwd_d256_f32"] = check_flash_bwd(gen, 1, 1024, 1024, c=256, heads=1, dtype=torch.float32,
                                                    repeat=True)
    results["flash_bwd_d160"] = check_flash_strided_bwd(gen, 16, 256, 512, d=160, repeat=True)
    results["flash_bwd_d256"] = check_flash_bwd(gen, 4, 1024, 1024, c=256, heads=1, repeat=True)
    check_flash_strided_bwd(gen, 2, 1000, 2100, d=160, timing=False, repeat=True)
    check_flash_strided_bwd(gen, 2, 1000, 2100, heads=2, d=256, timing=False)
    check_flash_bwd(gen, 2, 1000, 2100, c=384, heads=2, timing=False)
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_bwd(gen, 2, 1000, 2100, c=512, heads=2, dtype=dtype, timing=False, need_dkv=False)
        check_flash_bwd(gen, 2, 1000, 2100, c=512, heads=2, dtype=dtype, timing=False, need_dq=False)
    # K8a (with and without SiLU) and K8b at the GroupNorm slabs of a request
    # under CFG at 16 frames: the UNet's levels 0, 1 and 2 at 256^2 and at
    # 512^2 (each sample's slab in one cluster launch in bf16), the VAE's
    # full-resolution decode of the 16 frames at 256^2 and stage 5's batch of
    # 4 at 512^2 (two launches); each bf16 kernel twice on the same inputs
    # (the same bits); float32 too. Then C 2560 (the up path's concatenated
    # input at level 3, wider than a block's threads), ragged L in both
    # regimes and a small slab.
    for key, (n, l, c) in (("gn_l0", (32, 1024, 320)), ("gn_l1", (32, 256, 640)), ("gn_l2", (32, 64, 1280)),
                           ("gn_vae", (16, 65536, 128)), ("gn_512_l0", (32, 4096, 320)),
                           ("gn_512_l1", (32, 1024, 640)), ("gn_512_l2", (32, 256, 1280)),
                           ("gn_vae512", (4, 262144, 128))):
        results[key] = check_group_norm(gen, n, l, c, repeat=True)
        check_group_norm(gen, n, l, c, silu=False, timing=False)
        results[f"{key}_stats"] = check_group_norm_stats(gen, n, l, c, repeat=True)
        for silu in (True, False):
            check_group_norm(gen, n, l, c, silu=silu, dtype=torch.float32, timing=False, repeat=silu)
        check_group_norm_stats(gen, n, l, c, dtype=torch.float32, timing=False, repeat=True)
    check_group_norm(gen, 32, 64, 2560, timing=False, repeat=True)
    check_group_norm(gen, 32, 64, 2560, dtype=torch.float32, timing=False)
    check_group_norm_stats(gen, 32, 64, 2560, timing=False)
    for n, l, c in ((32, 1000, 320), (2, 66000, 128)):
        check_group_norm(gen, n, l, c, timing=False, repeat=True)
        check_group_norm(gen, n, l, c, dtype=torch.float32, timing=False)
        check_group_norm_stats(gen, n, l, c, timing=False, repeat=True)
    check_group_norm(gen, 2, 100, 64, timing=False)
    # K7 at the self-attention sites under CFG at 16 frames: levels 0, 1, 2 and
    # mid at 256^2 (M 32768 / 8192 / 2048 / 512, C 320 / 640 / 1280 / 1280) and at
    # 512^2 (M x 4), bf16 on ln_qkv_sm90, each twice (the same bits); ragged M,
    # M below one row tile and C past a 64-column chunk (200); float32 on
    # ln_qkv_f32_sm90, timed at the float32 step's level 0 (batch 1 x 2 frames
    # under CFG) and at M 2048, C 1280, each twice (the same bits), then at
    # every other float32 step and train step site twice, ragged M twice, C
    # 200 and C 1344 (past bf16's 1280)
    for key, (m, c) in (("ln_qkv_l0", (32768, 320)), ("ln_qkv_l1", (8192, 640)), ("ln_qkv_l2", (2048, 1280)),
                        ("ln_qkv_mid", (512, 1280)), ("ln_qkv_512_l0", (131072, 320)),
                        ("ln_qkv_512_l1", (32768, 640)), ("ln_qkv_512_l2", (8192, 1280)),
                        ("ln_qkv_512_mid", (2048, 1280))):
        results[key] = check_ln_qkv(gen, m, c, repeat=True)
    for m, c in ((1000, 320), (1000, 640), (1000, 1280), (37, 640), (500, 200)):
        check_ln_qkv(gen, m, c, timing=False, repeat=True)
    results["ln_qkv_f32"] = check_ln_qkv(gen, 4096, 320, dtype=torch.float32, repeat=True)
    results["ln_qkv_f32_l2"] = check_ln_qkv(gen, 2048, 1280, dtype=torch.float32, repeat=True)
    for m, c in F32_STEP_SITES[1:]:
        check_ln_qkv(gen, m, c, dtype=torch.float32, timing=False, repeat=True)
    check_ln_qkv(gen, 1000, 320, dtype=torch.float32, timing=False, repeat=True)
    check_ln_qkv(gen, 500, 200, dtype=torch.float32, timing=False)
    check_ln_qkv(gen, 100, 1344, dtype=torch.float32, timing=False)
    # K6 (ff_sm90 without LN) at level 0 under CFG at 256^2 (M 32768 x C 320,
    # the only width the TPU kernel takes), then C 640 and 1280 (which the
    # port takes and the reference leaves to XLA), a ragged M twice (the same
    # bits), and float32 on ff_f32_sm90 (timed at M 4096, twice; ragged M twice)
    results["geglu_ff_l0"] = check_geglu_ff(gen, 32768, 320)
    results["geglu_ff_l1"] = check_geglu_ff(gen, 8192, 640)
    results["geglu_ff_l2"] = check_geglu_ff(gen, 2048, 1280)
    check_geglu_ff(gen, 1000, 320, timing=False, repeat=True)
    results["geglu_ff_f32"] = check_geglu_ff(gen, 4096, 320, dtype=torch.float32, repeat=True)
    check_geglu_ff(gen, 500, 1280, dtype=torch.float32, timing=False, repeat=True)
    # head dim 512, the VAE's mid-attention at 512^2: bf16 on flash_fwd_sm90 at
    # the 16-frame decode (N 16, L 4096), the reference image's encode with a
    # ragged L, and a ragged Lq != Lk; float32 on flash_fwd_d512_f32,
    # timed at one image (the float32 vae512 phase) and at N 16, with device_ms
    results["flash_d512"] = check_flash(gen, 16, 4096, 4096, c=512, heads=1)
    check_flash(gen, 1, 4000, 4000, c=512, heads=1, timing=False)
    check_flash(gen, 2, 1000, 2100, c=512, heads=1, timing=False)
    results["flash_d512_f32"] = check_flash(gen, 1, 4096, 4096, c=512, heads=1, dtype=torch.float32)
    results["flash_d512_f32_n16"] = check_flash(gen, 16, 4096, 4096, c=512, heads=1, dtype=torch.float32, chunk=4)
    check_flash(gen, 2, 1000, 2100, c=512, heads=1, dtype=torch.float32, timing=False)
    # head dims 257-511: padded to 512 in the wrapper, on the d-512
    # kernels of each type, forward and backward: d 384 at L 4096 (a VAE of
    # last width 384 at 512^2) on the packed layout, d 300 on the strided one
    for dtype in (torch.bfloat16, torch.float32):
        check_flash(gen, 1, 4096, 4096, c=768, heads=2, dtype=dtype, timing=False)
        check_flash_bwd(gen, 1, 4096, 4096, c=768, heads=2, dtype=dtype, timing=False, chunk=1)
        check_flash_strided(gen, 2, 1000, 2100, heads=2, d=300, dtype=dtype, timing=False)
        check_flash_strided_bwd(gen, 2, 1000, 2100, heads=2, d=300, dtype=dtype, timing=False)
    # flash_fwd_sm90 and flash_bwd_sm90 at the 512^2 level-0 sites (Lq 4096, Lk 8192: reference tokens
    # appended) and level-1 sites (C 640, 10 heads, Lk 2048): serving under
    # CFG (N 32) and stage-2 training (N 16)
    results["flash_512_l0"] = check_flash(gen, 32, 4096, 8192, chunk=4)
    results["flash_512_l1"] = check_flash(gen, 32, 1024, 2048, c=640, heads=10, chunk=8)
    results["flash_bwd_512_l0"] = check_flash_bwd(gen, 16, 4096, 8192, chunk=2)
    results["flash_bwd_512_l1"] = check_flash_bwd(gen, 16, 1024, 2048, c=640, heads=10, chunk=4)
    # K4 at head dim 512, the VAE's mid-attention that stage 5 trains: bf16 on
    # flash_bwd_d512_sm90 at stage 5's 512^2 shape (batch 4, 4096
    # tokens) and at 384^2 (2304 tokens, ragged against the 64-row tiles), each
    # twice for the same bits, with device_ms; float32 on flash_bwd_d512_f32 (a
    # cluster of four a tile) at one 256^2 image (the float32 step) and at
    # 384^2, twice, with device_ms; dq only, dk/dv only and Lq != Lk in both
    # types, float32 twice
    results["flash_bwd_d512"] = check_flash_bwd(gen, 4, 4096, 4096, c=512, heads=1, chunk=1, repeat=True)
    results["flash_bwd_d512_2304"] = check_flash_bwd(gen, 2, 2304, 2304, c=512, heads=1, chunk=1, repeat=True)
    results["flash_bwd_d512_f32"] = check_flash_bwd(gen, 1, 1024, 1024, c=512, heads=1, dtype=torch.float32,
                                                    repeat=True)
    results["flash_bwd_d512_f32_2304"] = check_flash_bwd(gen, 2, 2304, 2304, c=512, heads=1, dtype=torch.float32,
                                                         chunk=1, repeat=True)
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        check_flash_bwd(gen, 2, 1000, 2100, c=1024, heads=2, dtype=dtype, timing=False, repeat=f32)
        check_flash_bwd(gen, 2, 1000, 2100, c=512, heads=1, dtype=dtype, timing=False, need_dkv=False, repeat=f32)
        check_flash_bwd(gen, 2, 1000, 2100, c=512, heads=1, dtype=dtype, timing=False, need_dq=False, repeat=f32)
    # head dims above 512 on flash_fwd_wide.cu and flash_bwd_wide_sm90.cu: d 640 (a
    # VAE of last width 640) timed in float32 at its stage-5 step at 256^2 (one image of 1024 tokens,
    # the kernels' main path) and in bf16 at 512^2 (4096 tokens), forward and
    # backward (twice, the same bits); d 1024 packed and d 576 strided in both
    # types and both directions, ragged, the forward twice, dq only and dk/dv
    # only; the cluster forward's other shapes (d 768, 896, 1024, 1152: other
    # slice widths and cluster sizes, the keys split in two over an odd count
    # of tiles, single-stage rings; one key tile, where bf16's second
    # warpgroup has none) and the slice forward past the cluster's reach (d 2304);
    # the cluster backward's (d 768, 1024, 2048: four and eight slices in bf16,
    # float32 2048 past its reach; d 640 at 300 rows, its streamed dimension in
    # two parts; one key tile, dk/dv in two parts) and the slice backward past
    # its reach (d 2304), twice each
    results["flash_wide_f32"] = check_flash(gen, 1, 1024, 1024, c=640, heads=1, dtype=torch.float32, repeat=True)
    results["flash_bwd_wide_f32"] = check_flash_bwd(gen, 1, 1024, 1024, c=640, heads=1, dtype=torch.float32,
                                                    repeat=True)
    results["flash_wide"] = check_flash(gen, 1, 4096, 4096, c=640, heads=1, repeat=True)
    results["flash_bwd_wide"] = check_flash_bwd(gen, 1, 4096, 4096, c=640, heads=1, repeat=True)
    for dtype in (torch.bfloat16, torch.float32):
        check_flash(gen, 2, 1000, 2100, c=1024, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash_bwd(gen, 2, 1000, 2100, c=1024, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash_strided(gen, 2, 1000, 2100, heads=2, d=576, dtype=dtype, timing=False, repeat=True)
        for d in (768, 896, 1024, 1152, 2304):
            check_flash(gen, 1, 1000, 1030, c=d, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash(gen, 1, 70, 45, c=640, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash_strided_bwd(gen, 2, 1000, 2100, heads=2, d=576, dtype=dtype, timing=False)
        check_flash_bwd(gen, 2, 300, 333, c=1280, heads=2, dtype=dtype, timing=False, need_dkv=False)
        check_flash_bwd(gen, 2, 300, 333, c=1280, heads=2, dtype=dtype, timing=False, need_dq=False)
        for d in (768, 2048, 2304):
            check_flash_bwd(gen, 1, 1000, 1030, c=d, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash_bwd(gen, 1, 300, 333, c=640, heads=1, dtype=dtype, timing=False, repeat=True)
        check_flash_bwd(gen, 1, 70, 45, c=640, heads=1, dtype=dtype, timing=False, repeat=True)
    return results


# ---- phase 3 ------------------------------------------------------------------
def _fill_zero_init(model, seed: int) -> None:
    """Small seeded values in the zero-initialised output projections, so
    that every conditioning branch reaches the output."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(seed)
    den = model.modules.denoiser
    targets = [den.speed_embed.fc2, den.face_mask_encoder.zero_conv]
    for name, mod in den.named_modules():
        if name.endswith("_temporal"):
            targets.append(mod.proj_out)
        elif name.endswith("_audio"):
            targets.append(mod.attn.to_out)
    with torch.no_grad():
        for mod in targets:
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * (0.5 / math.sqrt(mod.fan_in())))


def _request_inputs(gen, device, size: int, frames: int, dtype):
    import torch

    img = (torch.rand((1, size, size, 3), generator=gen, device=device) * 2 - 1).to(dtype)
    wav = (torch.randn((1, int(16000 * (frames + 4) / 25.0)), generator=gen, device=device) * 0.1).to(dtype)
    speeds = (torch.rand((1, frames, 3), generator=gen, device=device) * 2 - 1).to(dtype)
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device), indexing="ij")
    mask = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2).to(dtype)[None, :, :, None]
    return img, wav, speeds, mask


def phase_step(name: str = "flagship", runs=(("", None),)):
    """runs: (phase suffix, switches) pairs, each one step on the card and on
    the CPU with the same weights and inputs under those switches."""
    import torch
    from emox_torch.data.tokenizer import CLIPTokenizer
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, frames = 256, 2
    cfg = model_config(name, size, frames)
    prompted = cfg.clip.text_enabled
    t0 = time.perf_counter()
    cpu = EMOModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    _fill_zero_init(cpu, seed=8)
    gpu = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    setup_s = time.perf_counter() - t0

    gen = torch.Generator(device="cpu").manual_seed(9)
    img, wav, speeds, mask = _request_inputs(gen, "cpu", size, frames, torch.float32)
    lat = size // cfg.vae.downscale
    noisy = torch.randn((1, frames, lat, lat, 4), generator=gen)
    t = torch.tensor([500])
    if prompted:  # the prompt and, for the CFG uncond half, the empty prompt
        ids = torch.from_numpy(CLIPTokenizer().encode([PROMPT, ""], max_length=cfg.clip.max_positions))

    def run(model, dev):
        mv = lambda x: x.to(dev)
        ref = model.encode_images(mv(img))
        audio = model.encode_audio(mv(wav), frames)
        face = model.encode_face_mask(mv(mask), lat)
        out = {"ref_latent": ref, "audio": audio, "face_feat": face}
        context = None
        if prompted:
            out["context"] = model.encode_text(mv(ids))
            context = out["context"].flip(0)  # [uncond, cond]
        cat = lambda x: torch.cat([x, x])
        out["eps"] = model.predict_noise(
            cat(mv(noisy)), cat(mv(t)), cat(ref), audio_windows=torch.cat([torch.zeros_like(audio), audio]),
            speeds=cat(mv(speeds)), face_feat=cat(face), context=context,
            ref_dropout=mv(torch.tensor([True, False])),
        )
        return out

    results = []
    for suffix, env in runs:
        with switches(env):
            t0 = time.perf_counter()
            on_cpu = run(cpu, "cpu")
            cpu_s = time.perf_counter() - t0
            reset_launch_counts()
            t0 = time.perf_counter()
            on_gpu = run(gpu, "cuda")
            torch.cuda.synchronize()
            gpu_s = time.perf_counter() - t0
            counts = launch_counts()
        tol = 3e-4  # float32 on both sides; sums in other orders, 3xTF32 in the kernels
        rel = {}
        for key, ref in on_cpu.items():
            got = on_gpu[key].cpu().double()
            rel[key] = (torch.linalg.vector_norm(got - ref.double()) /
                        torch.linalg.vector_norm(ref.double()).clamp_min(1e-30)).item()
        want = step_sublayer_launches(cfg, ff_launches_per_request(cfg, 1), env)
        res = {"phase": ("step" if name == "flagship" else "step_sd15") + suffix,
               "config": f"{name} 256^2, 2 frames, CFG-batched{', prompt' if prompted else ''}, float32",
               "switches": env or {}, "rel_l2": rel, "tol": tol, "launches": counts, "launches_expected": want,
               "setup_s": setup_s, "cpu_s": cpu_s, "gpu_s": gpu_s,
               "eps_abs_mean": on_cpu["eps"].abs().mean().item()}
        emit(res)
        if not all(math.isfinite(v) and v <= tol for v in rel.values()):
            raise AssertionError(f"card and CPU disagree: {rel}")
        check_path_launches(name, counts, train=False, what=f"the float32 {name} step{suffix}", env=env,
                            dtype="float32")
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"the float32 {name} step{suffix}: launched {counts}, expected {want}")
        results.append(res)
        del on_cpu, on_gpu
    del cpu, gpu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    return results


def phase_step_attn_pallas():
    """One bf16 CFG-batched denoise step of the flagship at 256^2, 2 frames
    (the reference image's encode, the audio encoder, the face mask and
    predict_noise), on the card under EMOX_ATTENTION_IMPL=pallas (a kernel
    at every call of the attention dispatcher, whatever its K/V length: the
    audio cross-attention at Lk 5, the audio encoder, the VAE) and under
    =xla (plain PyTorch at every call), from the same weights and inputs,
    and the same step in float32 under xla as the reference. Asserts a kernel
    launch at every dispatcher call under pallas and none under xla, and that
    the pallas step's eps lies no farther from the float32 eps than twice the
    xla step's: both are bf16 (each rounds P to bf16 for P v, the kernel in
    registers, the plain path in memory), so neither is exact."""
    import torch
    from emox_torch.models.emo import EMOModel
    from emox_torch.nn import attention_blocks
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, frames = 256, 2
    cfg = model_config("flagship", size, frames)
    t0 = time.perf_counter()
    bf = EMOModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _fill_zero_init(bf, seed=8)
    f32 = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    f32.modules.load_state_dict(bf.modules.state_dict())  # the bf16 weights, exactly, in float32
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device="cpu").manual_seed(9)
    img, wav, speeds, mask = _request_inputs(gen, "cpu", size, frames, torch.float32)
    lat = size // cfg.vae.downscale
    noisy = torch.randn((1, frames, lat, lat, 4), generator=gen)
    calls = [0]
    dispatch = attention_blocks.dot_product_attention_nlc

    def counted(*a, **kw):
        calls[0] += 1
        return dispatch(*a, **kw)

    def run(model, dtype):
        mv = lambda x: x.to("cuda", dtype)
        cat = lambda x: torch.cat([x, x])
        with torch.inference_mode():
            ref = model.encode_images(mv(img))
            audio = model.encode_audio(mv(wav), frames)
            face = model.encode_face_mask(mv(mask), lat)
            eps = model.predict_noise(
                cat(mv(noisy)), torch.tensor([500, 500], device="cuda"), cat(ref),
                audio_windows=torch.cat([torch.zeros_like(audio), audio]), speeds=cat(mv(speeds)),
                face_feat=cat(face), ref_dropout=torch.tensor([True, False], device="cuda"))
        torch.cuda.synchronize()
        return eps.double()

    runs = {}
    attention_blocks.dot_product_attention_nlc = counted
    try:
        for label, model, dtype, env in (("pallas", bf, torch.bfloat16, ATTN_PALLAS),
                                         ("xla", bf, torch.bfloat16, ATTN_XLA),
                                         ("float32_xla", f32, torch.float32, ATTN_XLA)):
            with switches(env):
                calls[0] = 0
                reset_launch_counts()
                t0 = time.perf_counter()
                eps = run(model, dtype)
                runs[label] = {"eps": eps, "s": time.perf_counter() - t0, "dispatcher_calls": calls[0],
                               "launches": launch_counts()}
    finally:
        attention_blocks.dot_product_attention_nlc = dispatch
    rel = lambda a, b: (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    ref = runs["float32_xla"]["eps"]
    err = {k: rel(runs[k]["eps"], ref) for k in ("pallas", "xla")}
    on = runs["pallas"]["launches"]
    layouts = on["flash_attn_nlc_fwd"] + on["flash_attn_fwd"]
    res = {"phase": "step_attn_pallas", "config": "flagship 256^2, 2 frames, CFG-batched, bf16, "
           "EMOX_ATTENTION_IMPL=pallas against =xla, float32 xla as the reference",
           "dispatcher_calls": runs["pallas"]["dispatcher_calls"], "launches": on,
           "xla_launches": runs["xla"]["launches"], "rel_l2_to_float32": err,
           "rel_l2_pallas_to_xla": rel(runs["pallas"]["eps"], runs["xla"]["eps"]),
           "tol": "pallas no farther than 2x xla", "seconds": {k: v["s"] for k, v in runs.items()},
           "setup_s": setup_s}
    emit(res)
    if not (layouts == runs["pallas"]["dispatcher_calls"] == on["flash_fwd_sm90"] + on["flash_fwd_d512_f32"] > 0):
        raise AssertionError(f"step_attn_pallas: a kernel must launch at each of the "
                             f"{runs['pallas']['dispatcher_calls']} attention calls: {on}")
    if any(v for k, v in runs["xla"]["launches"].items() if k in ("flash_attn_nlc_fwd", "flash_attn_fwd", *FWD_SOURCES)):
        raise AssertionError(f"step_attn_pallas: attention kernels launched under xla: {runs['xla']['launches']}")
    if not (math.isfinite(err["pallas"]) and err["pallas"] <= 2 * err["xla"]):
        raise AssertionError(f"step_attn_pallas: eps {err} (relative L2 to the float32 step)")
    del bf, f32
    torch.backends.cudnn.allow_tf32 = True
    return res


# ---- phases 6 and 7: training -------------------------------------------------------
# the reference's learning rates: configs/training/stage{0,1,2,3}.yaml and its stage-5 preset
_STAGE_LR = {0: 1e-4, 1: 1e-4, 2: 1e-5, 3: 1e-5, 5: 1e-4}


def _train_config(stage: int, batch: int, frames: int, dtype: str, checkpoint_dir: str, name: str = "flagship",
                  size: int = 256):
    import dataclasses

    cfg = model_config(name, size, frames)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=batch, num_frames=frames),
        train=dataclasses.replace(cfg.train, stage=stage, learning_rate=_STAGE_LR[stage], compute_dtype=dtype,
                                  checkpoint_dir=checkpoint_dir, resume=False),
    )


def _train_batch(gen, stage: int, batch: int, frames: int, cfg, device):
    """A synthetic batch shaped as the reference's train benchmark builds it
    (bench.py), with random audio in place of silence."""
    import torch

    size = cfg.data.height
    normal = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=device)
    if stage in (0, 5):  # single images; stage 0 with a face-region mask and 6 landmarks
        out = {"images": normal(batch, size, size, 3)}
        if stage == 0:
            yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device),
                                    indexing="ij")
            disc = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2).float()
            out["images"] += 0.5 * disc[None, :, :, None]
            out["masks"] = disc[None, :, :, None].expand(batch, size, size, 1).contiguous()
            out["landmarks"] = torch.rand((batch, 6, 2), generator=gen, device=device) * 0.6 + 0.2
        return out
    out = {"ref_image": normal(batch, size, size, 3)}
    if stage == 1:
        out["images"] = normal(batch, size, size, 3)
    else:
        out["frames"] = normal(batch, frames, size, size, 3)
        out["wav"] = normal(batch, int(16000 * (frames + 2 * cfg.audio.context_frames) / 25.0))
    if stage == 3:
        out["speeds"] = torch.rand((batch, frames, cfg.model.speed_axes), generator=gen, device=device) * 2 - 1
        yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device), indexing="ij")
        disc = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2).float()
        out["masks"] = disc[None, :, :, None].expand(batch, size, size, 1).contiguous()
    return out


def phase_train_step(tmp: str, env=None):
    """env: the switches of the step (none: phase train_step; with some:
    train_step_norms)."""
    import torch
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer, sample_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _train_config(2, batch=1, frames=2, dtype="float32", checkpoint_dir=tmp)
    t0 = time.perf_counter()
    cpu = EMOModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    _fill_zero_init(cpu, seed=8)
    gpu = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    tr_cpu, tr_gpu = Trainer(cfg, model=cpu), Trainer(cfg, model=gpu)
    gen = torch.Generator(device="cpu").manual_seed(21)
    batch = _train_batch(gen, 2, 1, 2, cfg, "cpu")
    draws = sample_draws(cfg, tr_cpu.sched, 2, batch, gen)
    setup_s = time.perf_counter() - t0
    to_gpu = lambda d: {k: v.to("cuda") for k, v in d.items()}
    with switches(env):
        t0 = time.perf_counter()
        m_cpu, g_cpu = tr_cpu.loss_and_grads(batch, draws)
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        m_gpu, g_gpu = tr_gpu.loss_and_grads(to_gpu(batch), to_gpu(draws))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counts = launch_counts()
    loss_cpu, loss_gpu = m_cpu["loss"].double().item(), m_gpu["loss"].double().item()
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    diff = sum(float(torch.linalg.vector_norm(a.cpu().double() - b.double()) ** 2) for a, b in zip(g_gpu, g_cpu))
    norm = sum(float(torch.linalg.vector_norm(b.double()) ** 2) for b in g_cpu)
    grads_rel = math.sqrt(diff / norm)
    leaf_rel = max(float(torch.linalg.vector_norm(a.cpu().double() - b.double())
                         / torch.linalg.vector_norm(b.double()).clamp_min(1e-30)) for a, b in zip(g_gpu, g_cpu))
    # measured on an H100: loss 1.1e-6, grads 4.3e-5 relative; the limits keep
    # a margin of about 10x and 5x
    limits = {"loss_rel": 1e-5, "grads_rel_l2": 2e-4}
    want = step_sublayer_launches(cfg, train_step_sublayers(cfg), env)
    res = {"phase": "train_step_norms" if env else "train_step", "config": "flagship 256^2 stage 2, batch 1, "
           "2 frames, float32, remat, full depth", "switches": env or {}, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_rel": loss_rel,
           "grads_rel_l2": grads_rel, "worst_leaf_rel_l2": leaf_rel, "limits": limits,
           "trainable_leaves": len(g_cpu), "trainable_params": sum(g.numel() for g in g_cpu),
           "launches": counts, "launches_expected": want, "setup_s": setup_s, "cpu_s": cpu_s, "gpu_s": gpu_s}
    emit(res)
    tr_cpu.close()
    tr_gpu.close()
    if not (loss_rel <= limits["loss_rel"] and grads_rel <= limits["grads_rel_l2"]):
        raise AssertionError(f"card and CPU gradients disagree: loss {loss_rel}, grads {grads_rel}")
    check_path_launches("flagship", counts, train=True, what=f"the float32 train step {env or ''}", env=env,
                        dtype="float32")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the float32 train step {env or ''}: launched {counts}, expected {want}")
    torch.backends.cudnn.allow_tf32 = True
    return res


def phase_train(tmp: str, stage: int, batch: int, frames: int, warmup: int, steps: int, out_dir: str = "",
                name: str = "flagship", env=None, size: int = 256, dtype: str = "bfloat16", phase: str = "",
                prepare=None):
    """env: the switches of the run (none: phase train / train_sd15 /
    train_512; with some: train_norms). Stages 0 and 5 (phase names
    train_stage0, train_vae512) train the face nets and the VAE: their
    launches are asserted by check_stage05_launches. prepare(model), if
    given, runs before the trainer is built (stage 0 loads the shipped face
    nets)."""
    import torch
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer

    torch.cuda.empty_cache()
    cfg = _train_config(stage, batch=batch, frames=frames, dtype=dtype, checkpoint_dir=tmp, name=name, size=size)
    tag = ("" if name == "flagship" else "_sd15") + ("" if size == 256 else f"_{size}") + ("_norms" if env else "")
    t0 = time.perf_counter()
    model = EMOModel(cfg, dtype=getattr(torch, dtype), device="cuda", seed=0)
    _fill_zero_init(model, seed=3)  # every trainable leaf of stage 2 gets a gradient from step 1
    if prepare is not None:
        prepare(model)
    tr = Trainer(cfg, model=model)
    gen = torch.Generator(device="cuda").manual_seed(30 + stage)
    data = _train_batch(gen, stage, batch, frames, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    names = tr.trainable_names()
    snapshot = lambda t: t.detach().to("cpu", copy=True)
    before_train = {n: snapshot(m) for n, m in tr.state.masters.items()}
    before_frozen = {n: snapshot(p) for n, p in model.modules.named_parameters() if n not in tr.state.masters}
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with switches(env):
        reset_launch_counts()
        for _ in range(warmup):
            losses.append(float(tr.train_step(data, gen)["loss"]))
        warm_counts = launch_counts()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(float(tr.train_step(data, gen)["loss"]))  # loss.item() synchronises each step
        secs = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        phase_profile(lambda: tr.train_step(data, gen), f"one {name} {size}^2 stage-{stage} train step"
                      + (f" under {env}" if env else ""), out_dir, f"profile_train{tag}_stage{stage}_kernels.json")
    unchanged = [n for n in names if torch.equal(tr.state.masters[n].cpu(), before_train[n])]
    # AdamW with decoupled decay leaves a leaf alone only when its gradient
    # and its value are both zero (e.g. zero-init biases of ReferenceNet
    # layers past its last bank in stage 1); any other unchanged leaf is a fault
    stuck = [n for n in unchanged if bool(before_train[n].any())]
    module_changed = sum(not torch.equal(p.detach().cpu(), before_train[n].to(p.dtype))
                         for n, p in model.modules.named_parameters() if n in before_train)
    frozen_changed = sum(not torch.equal(p.detach().cpu(), before_frozen[n])
                         for n, p in model.modules.named_parameters() if n in before_frozen)
    ms = 1e3 * secs / steps
    compute = "bf16 compute, fp32 masters" if dtype == "bfloat16" else "float32"
    remat = ", remat" if stage in (1, 2, 3) else ""  # of the UNets' attention stacks, which stages 0 and 5 leave out
    res = {"phase": phase or f"train{tag}", "stage": stage,
           "config": f"{name} {size}^2 stage {stage}, batch {batch}, {frames} frame(s), {compute}, "
                     f"AdamW lr {_STAGE_LR[stage]}{remat}; {warmup} warm-up + {steps} timed steps",
           "switches": env or {},
           "params": sum(p.numel() for p in model.modules.parameters()),
           "trainable_params": sum(m.numel() for m in tr.state.masters.values()),
           "trainable_leaves": len(names), "frozen_leaves": len(before_frozen),
           "setup_s": setup_s, "ms_per_step": ms, "frames_per_s": batch * frames * 1e3 / ms,
           "peak_mem_gb": peak, "losses": losses, "all_finite": all(math.isfinite(x) for x in losses),
           "trainable_masters_changed": len(names) - len(unchanged),
           "trainable_unchanged_all_zero": len(unchanged) - len(stuck), "trainable_stuck": stuck[:8],
           "trainable_module_leaves_changed": module_changed, "frozen_leaves_changed": frozen_changed,
           "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
           "warmup_launches_per_step": {k: v / warmup for k, v in warm_counts.items()},
           "bwd_sources_per_step": {k: counts[k] / steps for k in BWD_SOURCES},
           "bwd_sm90_per_step_expected": BWD_PER_STEP.get((name, size)) if stage == 2 else None}
    emit(res)
    tr.close()
    if not res["all_finite"]:
        raise AssertionError(f"stage {stage}: a loss is not finite: {losses}")
    if stuck or frozen_changed:
        raise AssertionError(f"stage {stage}: trainable leaves left unchanged {stuck[:8]}, "
                             f"{frozen_changed} frozen leaves changed")
    if stage in (0, 5):
        check_stage05_launches(stage, counts, steps, res["phase"], env=env)
    else:
        check_path_launches(name, counts, train=True, what=f"{name} stage {stage} training {env or ''}", env=env)
    want = res["bwd_sm90_per_step_expected"]
    if want is not None and res["bwd_sources_per_step"] != {**dict.fromkeys(BWD_SOURCES, 0), "flash_bwd_sm90": want}:
        raise AssertionError(f"{name} {size}^2 stage 2: backward kernels per step {res['bwd_sources_per_step']}, "
                             f"expected {want} on flash_bwd_sm90")
    del tr, model, data
    return res


def stage05_launches(stage: int, dtype: str = "bfloat16", calls: int = 1, env=None, cfg=None,
                     head_dim: int = 512) -> dict:
    """The kernel launches of `calls` loss-and-gradient passes of stage 0 or
    5, by counter: stage 0's face nets are convolutions and launch none;
    stage 5 differentiates the VAE, whose two mid-attentions (one head of
    dim head_dim, the VAE's last width: 512 in the flagship; at 512^2 their
    4096 tokens reach KERNEL_MIN_KV) each take one packed forward and one
    backward, on the kernels of _fwd_kernel and _bwd_kernel (at d 512:
    flash_fwd_sm90 and flash_bwd_d512_sm90 in bf16, flash_fwd_d512_f32 and
    flash_bwd_d512_f32 in float32). Under EMOX_GROUPNORM_IMPL=pallas (env)
    every GroupNorm of the VAE's encode and decode (vae_group_norms of cfg,
    the flagship's by default) takes K8a once; its backward recomputes
    through the plain formula."""
    import torch
    from emox_torch.ops import KERNEL_WRAPPERS

    want = dict.fromkeys(KERNEL_WRAPPERS, 0)
    if stage == 5:
        dt = getattr(torch, dtype)
        for k in ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd", _fwd_kernel(dt, head_dim), _bwd_kernel(dt, head_dim)):
            want[k] = 2 * calls
        if "group_norm" in switch_kernels(env):
            want["group_norm"] = sum(vae_group_norms(cfg or model_config("flagship", 512, 1))) * calls
    return want


def check_stage05_launches(stage: int, counts: dict, steps: int, what: str, dtype: str = "bfloat16",
                           env=None, head_dim: int = 512) -> None:
    want = stage05_launches(stage, dtype, steps, env, head_dim=head_dim)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


# The VAEs of phase_train_step_vae: the flagship's (mid-attention head dim
# 512), the small preset's (256: the float32 head-dim-256 forward and the
# cluster pair at half width) and one of last width 640 (the wide kernels)
VAE_VARIANTS = {"flagship": None, "small": dict(base_channels=64, channel_multipliers=(1, 2, 4), num_res_blocks=1,
                                                norm_groups=16),
                "640": dict(base_channels=160, channel_multipliers=(1, 2, 4, 4))}


def phase_train_step_vae(tmp: str, size: int = 256, vae: str = "flagship", impl: str = "pallas",
                         check: bool = True):
    """One float32 stage-5 step (VAE pretraining) of the flagship VAE (or a
    VAE_VARIANTS one) at size^2, batch 1: the loss and the VAE's gradients on
    the card against the same weights, images and posterior noise on the
    CPU, TF32 off, under EMOX_ATTENTION_IMPL=impl. Under "pallas" both
    mid-attentions take the float32 kernels of the VAE's last width (the
    flagship's: flash_fwd_d512_f32, flash_bwd_d512_f32) and nothing else
    launches. The result carries the eight trainable leaves with the largest
    gradient gap; with check, the phase fails outside its limits or on other
    launches."""
    import dataclasses

    import torch
    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer, sample_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _train_config(5, batch=1, frames=1, dtype="float32", checkpoint_dir=tmp, size=size)
    # the loss reads the VAE alone: the UNets and the audio encoder, which it
    # never runs, are cut to the tiny preset's widths so that the float32 CPU
    # model builds in seconds
    tiny = tiny_config(size, 1)
    cfg = cfg.replace(model=tiny.model, audio=tiny.audio)
    if VAE_VARIANTS[vae]:
        cfg = cfg.replace(vae=dataclasses.replace(cfg.vae, **VAE_VARIANTS[vae]))
    head_dim = cfg.vae.base_channels * cfg.vae.channel_multipliers[-1]
    phase = "train_step_vae" + ("" if vae == "flagship" else f"_{vae}")
    t0 = time.perf_counter()
    cpu = EMOModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    gpu = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.vae.load_state_dict(cpu.modules.vae.state_dict())  # the stage differentiates the VAE alone
    tr_cpu, tr_gpu = Trainer(cfg, model=cpu), Trainer(cfg, model=gpu)
    gen = torch.Generator(device="cpu").manual_seed(23)
    batch = _train_batch(gen, 5, 1, 1, cfg, "cpu")
    draws = sample_draws(cfg, tr_cpu.sched, 5, batch, gen)
    setup_s = time.perf_counter() - t0
    to_gpu = lambda d: {k: v.to("cuda") for k, v in d.items()}
    with switches({"EMOX_ATTENTION_IMPL": impl}):
        t0 = time.perf_counter()
        m_cpu, g_cpu = tr_cpu.loss_and_grads(batch, draws)
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        m_gpu, g_gpu = tr_gpu.loss_and_grads(to_gpu(batch), to_gpu(draws))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counts = launch_counts()
    loss_cpu, loss_gpu = m_cpu["loss"].double().item(), m_gpu["loss"].double().item()
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    # (gap L2, CPU gradient L2, name) per trainable leaf
    l2 = lambda t: float(torch.linalg.vector_norm(t.double()))
    leaves = [(l2(a.cpu().double() - b.double()), l2(b), name)
              for a, b, name in zip(g_gpu, g_cpu, tr_cpu.trainable_names())]
    grads_rel = math.sqrt(sum(x[0] ** 2 for x in leaves) / sum(x[1] ** 2 for x in leaves))
    limits = {"loss_rel": 1e-5, "grads_rel_l2": 2e-4}  # as train_step
    metrics = {k: v.item() for k, v in m_gpu.items()}
    res = {"phase": phase, "config": f"{vae} VAE (mid-attention head dim {head_dim}) {size}^2 stage 5, batch 1, "
           f"float32, EMOX_ATTENTION_IMPL={impl} (the UNets and audio encoder, which stage 5 never runs, at tiny "
           f"widths)", "loss_cpu": loss_cpu, "loss_gpu": loss_gpu, "loss_rel": loss_rel,
           "grads_rel_l2": grads_rel, "worst_leaves": sorted(leaves, reverse=True)[:8], "limits": limits,
           "metrics_gpu": metrics, "trainable_leaves": len(g_cpu),
           "trainable_params": sum(g.numel() for g in g_cpu), "launches": counts, "setup_s": setup_s,
           "cpu_s": cpu_s, "gpu_s": gpu_s}
    emit(res)
    tr_cpu.close()
    tr_gpu.close()
    if check and not (loss_rel <= limits["loss_rel"] and grads_rel <= limits["grads_rel_l2"]):
        raise AssertionError(f"{phase}: card and CPU disagree: loss {loss_rel}, grads {grads_rel}")
    if check:
        check_stage05_launches(5, counts, 1, phase, dtype="float32", head_dim=head_dim)
    del cpu, gpu, tr_cpu, tr_gpu
    torch.backends.cudnn.allow_tf32 = True
    return res


def face_nets_path() -> str:
    """The trained face nets the repository ships, beside this script."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "emox", "assets", "face_nets.npz")


def phase_face_nets(batch: int = 8, size: int = 256):
    """The shipped face nets, read through the port (load_face_nets), run
    by EMOModel.locate_face and locate_landmarks on `batch` size^2 images in
    float32 on the card against the CPU, TF32 off. Both sides build the
    tiny preset's EMOModel: the face nets' widths do not depend on the
    preset."""
    import torch
    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train.face_nets import load_face_nets, load_face_nets_into

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = load_face_nets(face_nets_path())
    if tree is None:
        raise FileNotFoundError(f"face_nets: no weights at {face_nets_path()}")
    cfg = tiny_config(size, 1)
    models = {dev: EMOModel(cfg, device=dev, seed=0) for dev in ("cpu", "cuda")}
    for m in models.values():
        load_face_nets_into(m.modules, tree)
    gen = torch.Generator(device="cpu").manual_seed(24)
    data = _train_batch(gen, 0, batch, 1, cfg, "cpu")
    out = {}
    reset_launch_counts()
    for dev, m in models.items():
        t0 = time.perf_counter()
        with torch.no_grad():
            x = data["images"].to(dev)
            out[dev] = {"logits": m.locate_face(x), "landmarks": m.locate_landmarks(x)}
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev]["s"] = time.perf_counter() - t0
    counts = launch_counts()
    rel = {k: (torch.linalg.vector_norm(out["cuda"][k].cpu().double() - v.double())
               / torch.linalg.vector_norm(v.double()).clamp_min(1e-30)).item()
           for k, v in out["cpu"].items() if k != "s"}
    mask = data["masks"] > 0.5
    pred = out["cuda"]["logits"].cpu() > 0
    tol = 3e-4  # as the step phases: float32 both sides, convolutions summed in other orders
    res = {"phase": "face_nets", "config": f"FaceLocator + FaceLandmarkNet, shipped weights, {batch} x {size}^2, "
           "float32", "rel_l2": rel, "tol": tol, "iou_vs_disc": ((pred & mask).sum() / (pred | mask).sum()).item(),
           "cpu_s": out["cpu"]["s"], "gpu_s": out["cuda"]["s"], "launches": counts,
           "shapes": {k: list(v.shape) for k, v in out["cuda"].items() if k != "s"}}
    emit(res)
    if not all(math.isfinite(v) and v <= tol for v in rel.values()):
        raise AssertionError(f"face_nets: card and CPU disagree: {rel}")
    if any(counts.values()):
        raise AssertionError(f"face_nets: the face nets launch no kernel of the port: {counts}")
    torch.backends.cudnn.allow_tf32 = True
    return res, tree


# ---- phase 4 ------------------------------------------------------------------
def phase_serve(out_dir: str, requests: int = 3, steps: int = 10, name: str = "flagship", prompt=None, env=None,
                profile: bool = True, size: int = 256):
    """env: the switches of the run (none: phase serve / serve_sd15 /
    serve_512; with norm switches: serve_norms, whose launches of the switch
    kernels are asserted at the count norm_launches_per_request derives;
    EMOX_FF_IMPL=xla: serve_ff_xla). The attention kernels' launches are
    asserted at the count attn_launches_per_request derives."""
    import torch
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    frames = 16
    cfg = model_config(name, size, frames)
    tag = ("" if name == "flagship" else "_sd15") + ("" if size == 256 else f"_{size}")
    if env and "EMOX_FF_IMPL" in env:
        tag += "_ff_" + env["EMOX_FF_IMPL"]
    elif env and "EMOX_ATTENTION_IMPL" in env:
        tag += "_attn_" + env["EMOX_ATTENTION_IMPL"]
    elif env:
        tag += "_norms" + ("_fast" if env.get("EMOX_GROUPNORM_IMPL") == "fast" else "")
    t0 = time.perf_counter()
    model = EMOModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    pipe = EMOPipeline(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.modules.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = [_request_inputs(gen, "cuda", size, frames, torch.bfloat16) for _ in range(requests)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_request = []
    with switches(env):
        reset_launch_counts()
        for r, (img, wav, speeds, mask) in enumerate(inputs):
            timings = {}
            t0 = time.perf_counter()
            video = pipe(img, wav, video_length=frames, num_inference_steps=steps, guidance_scale=7.5,
                         speeds=speeds, face_mask=mask,
                         generator=torch.Generator(device="cuda").manual_seed(100 + r), prompt=prompt,
                         timings=timings)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            finite = bool(torch.isfinite(video.float()).all().item())
            shape = list(video.shape)
            per_request.append({"s": secs, "ms_per_step": 1e3 * timings["denoise_s"] / steps,
                                "phases_s": timings, "finite": finite, "shape": shape,
                                "abs_mean": video.float().abs().mean().item()})
            if not finite or shape != [1, frames, size, size, 3]:
                emit({"phase": f"serve{tag}", "request": r, **per_request[-1]})
                raise AssertionError(f"request {r}: output finite={finite} shape={shape}")
        counts = launch_counts()
        steady = per_request[1:] or per_request
        res = {"phase": f"serve{tag}",
               "config": f"{name} {size}^2, 16 frames, CFG 7.5 batched, {steps} DDIM steps, bf16"
                         + (f", prompt {prompt!r}" if prompt is not None else ""),
               "switches": env or {}, "params": n_params, "setup_s": setup_s, "requests": per_request,
               "s_per_request": sum(p["s"] for p in steady) / len(steady),
               "ms_per_step": sum(p["ms_per_step"] for p in steady) / len(steady),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
               "launches_per_request": {k: v / requests for k, v in counts.items()}}
        # under EMOX_ATTENTION_IMPL=xla no site takes a kernel
        attn_on = (env or {}).get("EMOX_ATTENTION_IMPL") != "xla"
        res["attn_launches_per_request_expected"] = {
            k: v * attn_on for k, v in {**attn_launches_per_request(cfg, steps),
                                        **fwd_sources_per_request(cfg, steps)}.items()}
        # every FF sub-layer on ff_sm90, none under EMOX_FF_IMPL=xla
        ff_on = (env or {}).get("EMOX_FF_IMPL") != "xla"
        res["ff_launches_per_request_expected"] = {k: ff_launches_per_request(cfg, steps) * ff_on
                                                   for k in ("ln_geglu_ff", FF_SOURCES["bfloat16"])}
        emit(res)
        check_path_launches(name, counts, train=False, what=f"{name} serving {env or ''}", env=env)
        attn = {k: requests * v for k, v in res["attn_launches_per_request_expected"].items()}
        if {k: counts[k] for k in attn} != attn:
            raise AssertionError(f"{name} {size}^2 serving: attention kernels launched {counts}, expected {attn}")
        ff = {k: requests * v for k, v in res["ff_launches_per_request_expected"].items()}
        if {k: counts[k] for k in ff} != ff:
            raise AssertionError(f"{name} {size}^2 serving: FF launched {counts}, expected {ff}")
        want = {k: requests * v for k, v in norm_launches_per_request(cfg, steps, env).items()}
        if {k: counts[k] for k in SWITCH_KERNELS} != want:
            raise AssertionError(f"{name} serving {env}: switch kernels launched {counts}, expected {want}")
        if profile:
            img, wav, speeds, mask = inputs[-1]
            phase_profile(lambda: pipe(img, wav, video_length=frames, num_inference_steps=steps, guidance_scale=7.5,
                                       speeds=speeds, face_mask=mask,
                                       generator=torch.Generator(device="cuda").manual_seed(99), prompt=prompt),
                          f"one {name} {size}^2 serving request, {steps} DDIM steps" + (f", under {env}" if env else ""),
                          out_dir, f"profile{tag}_kernels.json")
    return res


# ---- long clips and the rest of the sampling API -----------------------------------------
def long_segments(total: int, segment: int, motion: int) -> list:
    """Frames of each segment of EMOPipeline.generate_long (the first has no
    motion frames, each later one `motion` locked frames and up to
    segment - motion new ones)."""
    frames, produced = [], 0
    while produced < total:
        lead = motion if frames else 0
        new = min(segment - lead, total - produced)
        frames.append(new + lead)
        produced += new
    return frames


def bf16_launches_per_request(cfg, calls: int) -> dict:
    """The exact attention and FF launches of one bf16 request whose reader
    makes `calls` predict_noise calls."""
    ff = ff_launches_per_request(cfg, calls)
    return {**attn_launches_per_request(cfg, calls), **fwd_sources_per_request(cfg, calls),
            "ln_geglu_ff": ff, FF_SOURCES["bfloat16"]: ff}


def phase_step_long():
    """One windowed CFG-batched denoise step of the flagship at 256^2 (T 6,
    context 4, overlap 1: 2 windows, wrapping around the clip, folded into
    one call), float32, on the card (kernels) against the same weights on
    the CPU (plain versions), TF32 off: the per-frame average of the
    windows' eps at t 500."""
    import dataclasses

    import torch
    from emox_torch.diffusion.context import window_plan
    from emox_torch.diffusion.sampler import windowed_model_out
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, frames, t = 256, 6, 500
    cfg = model_config("flagship", size, frames)
    cfg = cfg.replace(inference=dataclasses.replace(cfg.inference, context_frames=4, context_overlap=1))
    icfg = cfg.inference
    plan = window_plan(1, frames, icfg.context_frames, icfg.context_stride, icfg.context_overlap)
    t0 = time.perf_counter()
    cpu = EMOModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    _fill_zero_init(cpu, seed=8)
    gpu = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device="cpu").manual_seed(10)
    img, wav, speeds, mask = _request_inputs(gen, "cpu", size, frames, torch.float32)
    lat = size // cfg.vae.downscale
    noisy = torch.randn((1, frames, lat, lat, 4), generator=gen)

    @torch.inference_mode()
    def run(model, dev):
        pipe = EMOPipeline(model)
        ref, audio = pipe._prepare(img.to(dev), wav.to(dev), frames)
        face = model.encode_face_mask(mask.to(dev), lat)
        feats, _ = pipe._precompute_banks(ref, torch.tensor([t]))
        rf = [[x[0] for x in site] for site in feats]
        eps = windowed_model_out(
            lambda wl, tw, wi: pipe._denoise_windows(wl, tw, wi, ref, audio, speeds.to(dev), face, 7.5, None, None,
                                                     rf, None),
            noisy.to(dev), torch.full((1,), t, device=dev), plan.indices[0], plan.weights[0])
        return {"ref_latent": ref, "audio": audio, "face_feat": face, "eps": eps}

    with switches():
        t0 = time.perf_counter()
        on_cpu = run(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        on_gpu = run(gpu, "cuda")
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counts = launch_counts()
    tol = 3e-4  # float32 on both sides, as phase_step
    rel = {k: (torch.linalg.vector_norm(on_gpu[k].cpu().double() - v.double()) /
               torch.linalg.vector_norm(v.double()).clamp_min(1e-30)).item() for k, v in on_cpu.items()}
    calls = reader_calls(cfg, 1, frames)
    want = {"flash_attn_nlc_fwd": attn_launches_per_request(cfg, calls)["flash_attn_nlc_fwd"],
            "flash_fwd_f32_sm90": sum(attn_launches_per_request(cfg, calls).values()),
            "ln_geglu_ff": ff_launches_per_request(cfg, calls),
            FF_SOURCES["float32"]: ff_launches_per_request(cfg, calls)}
    res = {"phase": "step_long",
           "config": f"flagship {size}^2, {frames} frames, context {icfg.context_frames}, overlap "
                     f"{icfg.context_overlap}: windows {plan.indices[0].tolist()} in {calls} call, CFG-batched, "
                     "float32",
           "rel_l2": rel, "tol": tol, "launches": counts, "launches_expected": want, "setup_s": setup_s,
           "cpu_s": cpu_s, "gpu_s": gpu_s, "eps_abs_mean": on_cpu["eps"].abs().mean().item()}
    emit(res)
    if not all(math.isfinite(v) and v <= tol for v in rel.values()):
        raise AssertionError(f"step_long: card and CPU disagree: {rel}")
    check_path_launches("flagship", counts, train=False, what="the float32 windowed step", dtype="float32")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"step_long: launched {counts}, expected {want}")
    del on_cpu, on_gpu, cpu, gpu
    torch.backends.cudnn.allow_tf32 = True
    return res


def phase_long(out_dir: str, requests: int = 2, steps: int = 10, frames: int = 48, long_frames: int = 125):
    """The rest of the sampling API on the flagship in bf16 at 256^2, CFG 7.5,
    10 DDIM steps, 3-axis speeds and a face mask. Each path's kernel launches
    are counted from 0 and read just after it; each output is finite and of
    its shape.
      serve_long: `requests` requests of `frames` frames (1.92 s at 25 fps;
        the windowed sampler, 4 windows a step folded into one call at
        WINDOWS_PER_CALL 4) and a profiled one; the launches asserted at the
        count derived from the window plan (reader_calls);
      serve_long_125: one request of long_frames frames (5 s, 11 windows a
        step: calls of 4, 4 and 3 windows), its launches and peak memory;
      serve_autoregressive: generate_long, `frames` frames in segments of 16
        with 2 motion frames (16, 16, 16 and 6 frames);
      invert: the first 16 frames of a served clip inverted in 10 steps, then
        sampled back from the inverted latents (no CFG, as the inversion),
        with the round trip's rel L2 on the latents;
      serve_interp, serve_two_call_cfg, serve_gn_ref: one 16-frame request
        each with interpolation_factor=2 (31 frames decoded), with
        inference.cfg_batching=False and with model.use_gn_ref=True."""
    import dataclasses

    import torch
    from emox_torch.diffusion.context import window_plan
    from emox_torch.infer.pipeline import WINDOWS_PER_CALL, EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    size = 256
    cfg = model_config("flagship", size, frames)
    icfg = cfg.inference
    fps = icfg.fps
    t0 = time.perf_counter()
    model = EMOModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    pipe = EMOPipeline(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(12)
    inputs = [_request_inputs(gen, "cuda", size, frames, torch.bfloat16) for _ in range(requests)]
    long_inputs = _request_inputs(gen, "cuda", size, long_frames, torch.bfloat16)
    short_inputs = _request_inputs(gen, "cuda", size, 16, torch.bfloat16)
    by_path = {}

    def checked(video, shape, what):
        finite = bool(torch.isfinite(video.float()).all().item())
        if not finite or list(video.shape) != shape:
            raise AssertionError(f"{what}: output finite={finite} shape={list(video.shape)}, expected {shape}")
        return {"finite": finite, "shape": shape, "abs_mean": video.float().abs().mean().item()}

    def request(p, inp, n, seed, **kw):
        """One timed request through p: its record and its video."""
        img, wav, speeds, mask = inp
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = p(img, wav, video_length=n, num_inference_steps=steps, guidance_scale=7.5, speeds=speeds,
                  face_mask=mask, generator=torch.Generator(device="cuda").manual_seed(seed), timings=timings, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = (n - 1) * kw.get("interpolation_factor", 1) + 1
        rec = {"s": secs, "s_per_video_s": secs / (n / fps), "ms_per_step": 1e3 * timings["denoise_s"] / steps,
               "phases_s": timings, **checked(video, [1, out, size, size, 3], f"{n}-frame request")}
        return rec, video

    def windows(n):
        plan = window_plan(steps, n, icfg.context_frames, icfg.context_stride, icfg.context_overlap)
        return [int((w > 0).sum()) for w in plan.weights]

    def launches_match(name, counts, want):
        check_path_launches("flagship", counts, train=False, what=name)
        if want is not None and {k: counts[k] for k in want} != want:
            raise AssertionError(f"{name}: launched {counts}, expected {want}")

    with switches():
        # serve_long: the windowed sampler
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        per_request, videos = [], []
        for r, inp in enumerate(inputs):
            rec, video = request(pipe, inp, frames, 200 + r)
            per_request.append(rec)
            videos.append(video)
        counts = launch_counts()
        calls = reader_calls(cfg, steps, frames)
        want = {k: requests * v for k, v in bf16_launches_per_request(cfg, calls).items()}
        steady = per_request[1:] or per_request
        res = {"phase": "serve_long",
               "config": f"flagship {size}^2, {frames} frames ({frames / fps:.2f} s), context {icfg.context_frames}, "
                         f"overlap {icfg.context_overlap}, CFG 7.5 batched, {steps} DDIM steps, bf16",
               "windows_per_call": WINDOWS_PER_CALL, "windows_per_step": windows(frames),
               "reader_calls_per_request": calls, "setup_s": setup_s, "requests": per_request,
               "s_per_request": sum(p["s"] for p in steady) / len(steady),
               "s_per_video_s": sum(p["s_per_video_s"] for p in steady) / len(steady),
               "ms_per_step": sum(p["ms_per_step"] for p in steady) / len(steady),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
               "launches_expected": want}
        emit(res)
        launches_match("serve_long", counts, want)
        by_path["serve_long"] = counts
        img, wav, speeds, mask = inputs[-1]
        res["profile"] = phase_profile(
            lambda: pipe(img, wav, video_length=frames, num_inference_steps=steps, guidance_scale=7.5,
                         speeds=speeds, face_mask=mask, generator=torch.Generator(device="cuda").manual_seed(99)),
            f"one flagship {size}^2 {frames}-frame request (windowed), {steps} DDIM steps", out_dir,
            "profile_long_kernels.json")

        # one 5 s request: 11 windows a step in calls of up to WINDOWS_PER_CALL
        del videos[1:]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        rec, _ = request(pipe, long_inputs, long_frames, 300)
        counts = launch_counts()
        calls = reader_calls(cfg, steps, long_frames)
        want = bf16_launches_per_request(cfg, calls)
        res_long = {"phase": "serve_long_125",
                    "config": f"flagship {size}^2, {long_frames} frames ({long_frames / fps:.2f} s), CFG 7.5 batched, "
                              f"{steps} DDIM steps, bf16", "windows_per_call": WINDOWS_PER_CALL,
                    "windows_per_step": windows(long_frames), "reader_calls_per_request": calls, **rec,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
                    "launches_expected": want}
        emit(res_long)
        launches_match("serve_long_125", counts, want)
        by_path["serve_long_125"] = counts

        # generate_long: segments of 16 frames, 2 motion frames
        segs = long_segments(frames, 16, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        video = pipe.generate_long(img, wav, frames, segment_length=16, num_motion_frames=2, num_inference_steps=steps,
                                   guidance_scale=7.5, speeds=speeds, face_mask=mask,
                                   generator=torch.Generator(device="cuda").manual_seed(400))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        # each segment is one request of at most one window (at 256^2 the VAE's
        # attention stays below the cutoff, so its encode per segment and one
        # decode launch nothing)
        want = {k: len(segs) * v for k, v in bf16_launches_per_request(cfg, steps).items()}
        res_ar = {"phase": "serve_autoregressive",
                  "config": f"generate_long, flagship {size}^2, {frames} frames in segments of 16 with 2 motion "
                            f"frames, CFG 7.5 batched, {steps} DDIM steps, bf16", "segments": segs, "s": secs,
                  "s_per_video_s": secs / (frames / fps), **checked(video, [1, frames, size, size, 3], "generate_long"),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
                  "launches_expected": want}
        emit(res_ar)
        launches_match("serve_autoregressive", counts, want)
        by_path["serve_autoregressive"] = counts
        del video

        # DDIM inversion of a served clip's first 16 frames, then sampling back
        clip = videos[0][:, :16]
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inv = pipe.invert(clip, img, wav, num_inference_steps=steps)
        torch.cuda.synchronize()
        invert_s = time.perf_counter() - t0
        counts = launch_counts()
        back = pipe.generate_latents(img, wav, video_length=16, num_inference_steps=steps, guidance_scale=1.0,
                                     latents=inv)
        start = model.encode_images(clip).float()
        lat = size // cfg.vae.downscale
        res_inv = {"phase": "invert",
                   "config": f"DDIM inversion of a served 16-frame {size}^2 clip, {steps} steps (no CFG), then "
                             "sampled back from the inverted latents, bf16", "invert_s": invert_s,
                   "inverted": checked(inv, [1, 16, lat, lat, 4], "invert"),
                   "sampled_back": checked(back, [1, 16, lat, lat, 4], "sampling back"),
                   "round_trip_rel_l2": (torch.linalg.vector_norm(back - start) /
                                         torch.linalg.vector_norm(start)).item(),
                   "launches": counts}
        emit(res_inv)
        if not math.isfinite(res_inv["round_trip_rel_l2"]):
            raise AssertionError(f"invert: round trip {res_inv['round_trip_rel_l2']}")
        launches_match("invert", counts, None)
        by_path["invert"] = counts
        del videos, clip, inv, back, start

        # one 16-frame request each: slerp interpolation, two-call CFG, AdaIN
        two_call = cfg.replace(inference=dataclasses.replace(icfg, cfg_batching=False))
        gn_cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_gn_ref=True))
        runs = [("serve_interp", "interpolation_factor=2", lambda: pipe, dict(interpolation_factor=2)),
                ("serve_two_call_cfg", "inference.cfg_batching=False", lambda: EMOPipeline(model, two_call), {}),
                ("serve_gn_ref", "model.use_gn_ref=True",
                 lambda: EMOPipeline(EMOModel(gn_cfg, dtype=torch.bfloat16, device="cuda", seed=0)), {})]
        extras = []
        for name, label, make, kw in runs:
            p = make()
            reset_launch_counts()
            rec, _ = request(p, short_inputs, 16, 500, **kw)
            counts = launch_counts()
            extras.append({"phase": name, "config": f"flagship {size}^2, 16 frames, {steps} DDIM steps, CFG 7.5, "
                                                    f"bf16, {label}", **rec, "launches": counts})
            emit(extras[-1])
            launches_match(name, counts, None)
            by_path[name] = counts
    return {"serve_long": res, "serve_long_125": res_long, "serve_autoregressive": res_ar, "invert": res_inv,
            "extras": extras, "launches_by_path": by_path}


# ---- phase 5: where the time of a request goes ---------------------------------------
_GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("group_norm", ("gn_cluster_kernel", "gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("ln_qkv", ("ln_qkv_kernel", "ln_qkv_f32::")),
    ("float32 split", ("split_rows", "split_matrices", "ln_rows_kernel<float")),  # ahead of "sm90::"
    ("flash_bwd_sm90", ("bwd_sm90::",)),  # ahead of the forward's "sm90::"
    # the cluster backward above head dim 512 (CLUSTER 0), ahead of the pair's namespace
    ("flash_bwd_wide", tuple(f"_kernel<{h}, {p}, 0," for h, p in ((320, 1), (192, 1), (256, 1), (192, 2), (128, 2)))),
    ("flash_bwd_d512_f32", ("dq_kernel<128, 2, 4", "dkv_kernel<128, 2, 4")),  # ahead of the pair's namespace
    ("flash_bwd_d512_sm90", ("bwd_d512_sm90::",)),
    ("flash_fwd_d512_f32", ("fwd_d512_f32::",)),
    ("ff_sm90", ("ff_sm90::", "ln_rows_kernel<__nv_bfloat16")),  # the FF's GEMMs and LN pass, ahead of "sm90::"
    ("flash_fwd_sm90", ("sm90::",)),
    ("flash_attn_wide", ("wide::",)),  # both wide files' kernels
    ("convolution", ("conv", "fprop", "dgrad", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas", "wgmma")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce", "norm")),
    ("copy / cat / fill", ("copy", "cat", "fill", "memcpy", "memset", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


# module function -> the range it is recorded under while profiling: the
# device time of every GroupNorm and LayerNorm, whichever path runs it, and of
# the self-attention sites' fused LN + q/k/v (0 with the switch off)
_NORM_RANGES = (("emox_torch.nn.blocks", "FusedGroupNorm", "forward", "emox.group_norm"),
                ("emox_torch.nn.layers", "LayerNorm", "forward", "emox.layer_norm"),
                ("emox_torch.nn.attention_blocks", None, "_maybe_ln_qkv", "emox.ln_qkv_sites"))


@contextlib.contextmanager
def _norm_ranges():
    """Record each norm call under a torch.profiler range, for the profiled
    run only."""
    import importlib

    import torch

    def ranged(fn, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run

    saved = []
    for mod_name, cls, attr, label in _NORM_RANGES:
        owner = importlib.import_module(mod_name)
        owner = getattr(owner, cls) if cls else owner
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, ranged(getattr(owner, attr), label))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def phase_profile(run, label: str, out_dir: str, filename: str) -> dict:
    """One more run (a request, a train step) under torch.profiler: device
    time per kernel group, the device's busy share of the run's span, the
    device time of the norm calls (the ranges of _NORM_RANGES), and the top
    kernels (all of them in out_dir/filename)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with _norm_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    labels = [r[-1] for r in _NORM_RANGES]
    ranges_us = dict.fromkeys(labels, 0.0)
    for e in events:
        if e.name in ranges_us and e.device_type == DeviceType.CPU:
            ranges_us[e.name] += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    # device events, without the ranges that user annotations (such as the
    # optimizer's step) open on the device timeline over real kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        res = {"phase": "profile", "device_time": "not measured (the profiler recorded no device events)"}
        emit(res)
        return res
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy, last_end = 0.0, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        if last_end is None or start >= last_end:
            busy += end - start
            last_end = end
        elif end > last_end:
            busy += end - last_end
            last_end = end
    groups, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        group = next((g for g, keys in _GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    kernel_us = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    res = {"phase": "profile", "config": f"{label}, under torch.profiler",
           "span_ms": span / 1e3, "kernel_ms": kernel_us / 1e3, "busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / span, "kernel_launches": len(kernels),
           "groups_ms": {g: t / 1e3 for g, t in sorted(groups.items(), key=lambda kv: -kv[1])},
           "norm_ranges_ms": {k.split(".")[-1]: v / 1e3 for k, v in ranges_us.items()},
           "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3} for n, (c, t) in top[:12]]}
    emit(res)
    if out_dir:
        with open(os.path.join(out_dir, filename), "w") as f:
            json.dump({n: {"count": c, "ms": t / 1e3} for n, (c, t) in top}, f, indent=1)
    return res


# ---- the 512^2 VAE and K6's entry points -----------------------------------------
def phase_vae512(size: int = 512):
    """The flagship VAE (random weights from a seed) encodes one size^2
    image (posterior mean) and decodes it, float32, on the card
    (flash_fwd_d512_f32, head dim 512, in both mid-attentions: (size/8)^2 tokens) against the same
    weights on the CPU (plain versions), TF32 off for matmuls and
    convolutions."""
    import copy

    import torch
    from emox_torch.models.vae import AutoencoderKL
    from emox_torch.nn.layers import init_weights
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config("flagship", size, 1).vae
    t0 = time.perf_counter()
    cpu = AutoencoderKL(cfg)
    init_weights(cpu, torch.Generator().manual_seed(5))
    cpu.eval().requires_grad_(False)
    gpu = copy.deepcopy(cpu).to("cuda", memory_format=torch.channels_last)
    img = torch.rand((1, size, size, 3), generator=torch.Generator().manual_seed(6)) * 2 - 1
    setup_s = time.perf_counter() - t0

    def run(vae, x):
        with torch.inference_mode():
            mean = vae.encode(x).mode()
            return {"latent_mean": mean, "image": vae.decode(mean)}

    t0 = time.perf_counter()
    on_cpu = run(cpu, img)
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    on_gpu = run(gpu, img.to("cuda"))
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    counts = launch_counts()
    tol = 3e-4  # as the step phases: float32 both sides, sums in other orders, 3xTF32 in the kernels
    rel = {k: (torch.linalg.vector_norm(on_gpu[k].cpu().double() - v.double())
               / torch.linalg.vector_norm(v.double()).clamp_min(1e-30)).item() for k, v in on_cpu.items()}
    res = {"phase": "vae512", "config": f"flagship VAE, one {size}^2 image, encode (posterior mean) + decode, "
           f"float32, mid-attention {(size // 8) ** 2} tokens at head dim {cfg.base_channels * cfg.channel_multipliers[-1]}",
           "rel_l2": rel, "tol": tol, "launches": counts, "setup_s": setup_s, "cpu_s": cpu_s, "gpu_s": gpu_s,
           "shapes": {k: list(v.shape) for k, v in on_gpu.items()}}
    emit(res)
    if not all(math.isfinite(v) and v <= tol for v in rel.values()):
        raise AssertionError(f"vae512: card and CPU disagree: {rel}")
    want = {"flash_attn_nlc_fwd": 2, "flash_fwd_d512_f32": 2}  # the float32 head-dim-512 kernel
    if any(n != want.get(k, 0) for k, n in counts.items()):
        raise AssertionError(f"vae512: flash_fwd_d512_f32 must launch at both mid-attentions and nothing else: {counts}")
    del cpu, gpu, on_cpu, on_gpu
    torch.backends.cudnn.allow_tf32 = True
    return res


def phase_geglu_ff():
    """K6's entry points: the flagship's level-0 GEGLUFeedForward(320) on
    [32, 1024, 320] bf16 tokens with impl "fused", with EMOX_FF_IMPL unset
    and with EMOX_FF_IMPL=fused (K6 launches, each on ff_sm90, output within
    4 bf16 steps of impl "xla"), under EMOX_FF_IMPL=xla (no launch); then
    one backward through the autograd function, dx and the weight gradients
    against geglu_ff_xla's autograd; then the module in float32 with impl
    "fused" (one launch of ff_f32_sm90), within 2e-4 of "xla" in
    float32."""
    import torch
    from emox_torch.nn.attention_blocks import GEGLUFeedForward
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.ops.ff import fused_geglu_ff, geglu_ff_xla

    gen = torch.Generator(device="cuda").manual_seed(77)
    c = 320
    ff = GEGLUFeedForward(c).to("cuda", torch.bfloat16)
    with torch.no_grad():
        for lin in (ff.proj_in, ff.proj_out):
            lin.weight.copy_(_rand(gen, *lin.weight.shape, scale=lin.fan_in() ** -0.5))
            lin.bias.copy_(_rand(gen, *lin.bias.shape, scale=0.1))
    x = _rand(gen, 32, 1024, c, dtype=torch.bfloat16)
    with switches():
        ff.impl = "xla"
        with torch.no_grad():
            want = ff(x)
    tol = _tol(want.float(), torch.bfloat16)
    runs = {}
    reset_launch_counts()
    for label, impl, env in (("impl_fused", "fused", None), ("env_unset", None, None),
                             ("env_fused", None, {"EMOX_FF_IMPL": "fused"}), ("env_xla", None, FF_XLA)):
        ff.impl = impl
        before = launch_counts()
        with switches(env), torch.no_grad():
            got = ff(x)
        torch.cuda.synchronize()
        runs[label] = {"launches": launch_counts()["geglu_ff"] - before["geglu_ff"],
                       "ff_sm90": launch_counts()["ff_sm90"] - before["ff_sm90"],
                       "max_abs_err": (got.float() - want.float()).abs().max().item()}
    # backward: the autograd function's recompute against geglu_ff_xla's autograd
    w = (ff.proj_in.weight, ff.proj_in.bias, ff.proj_out.weight, ff.proj_out.bias)
    dy = _rand(gen, *x.shape, dtype=torch.bfloat16)
    grads = {}
    for label, fn in (("fused", fused_geglu_ff), ("xla", geglu_ff_xla)):
        inputs = [t.detach().requires_grad_() for t in (x, *w)]
        grads[label] = torch.autograd.grad(fn(*inputs), inputs, dy)
    bwd = {}
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads["fused"], grads["xla"]):
        bwd[name] = {"max_abs_err": (g.float() - r.float()).abs().max().item(), "tol": _tol(r.float(), torch.bfloat16)}
    # float32: ff_f32_sm90
    ff32, x32 = ff.float(), x.float()
    with switches(), torch.no_grad():
        ff32.impl = "xla"
        want32 = ff32(x32)
        ff32.impl = "fused"
        got32 = ff32(x32)
    torch.cuda.synchronize()
    counts = launch_counts()
    f32 = {"max_abs_err": (got32 - want32).abs().max().item(), "tol": _tol(want32, torch.float32)}
    res = {"phase": "geglu_ff", "config": "GEGLUFeedForward(320) on [32, 1024, 320] bf16 (flagship level 0 under CFG),"
           " then in float32", "tol": tol, "runs": runs, "backward": bwd, "float32": f32, "launches": counts}
    emit(res)
    on = ("impl_fused", "env_unset", "env_fused")
    if (any(runs[k]["launches"] != 1 or runs[k]["ff_sm90"] != 1 or not runs[k]["max_abs_err"] <= tol for k in on)
            or runs["env_xla"]["launches"] or runs["env_xla"]["ff_sm90"]):
        raise AssertionError(f"geglu_ff: K6 must launch (on ff_sm90) under impl fused, EMOX_FF_IMPL unset and "
                             f"=fused (within {tol} of xla) and not under xla: {runs}")
    if not all(v["max_abs_err"] <= v["tol"] for v in bwd.values()):
        raise AssertionError(f"geglu_ff: gradients disagree with geglu_ff_xla's: {bwd}")
    if not f32["max_abs_err"] <= f32["tol"]:
        raise AssertionError(f"geglu_ff: float32 disagrees with xla: {f32}")
    f32_ff = FF_SOURCES["float32"]
    if counts[f32_ff] != 1 or any(n for k, n in counts.items() if k not in ("geglu_ff", "ff_sm90", f32_ff)):
        raise AssertionError(f"geglu_ff: one float32 launch on {f32_ff} and no other kernel expected: {counts}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="directory for long reports (ptxas output)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card only", file=sys.stderr)
        return 2
    try:
        import emox_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository ({e})", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = smi_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    t_start = time.perf_counter()
    phase_build(args.out)
    with switches():  # the default paths: every switch unset
        kern = phase_kernels()
        step = phase_step()[0]["launches"]
        launches = phase_serve(args.out)["launches"]
        # the attention switch: a kernel at every site (and against the plain
        # step), then the serving request with plain attention at every site
        step_pallas = phase_step_attn_pallas()["launches"]
        serve_attn_xla = phase_serve(args.out, requests=2, env=ATTN_XLA)["launches"]
        # clips longer than one context window, generate_long, invert, and the
        # two-call CFG program, interpolation and AdaIN
        step_long = phase_step_long()["launches"]
        long = phase_long(args.out)
        with tempfile.TemporaryDirectory() as tmp:
            train_step = phase_train_step(tmp)["launches"]
            train2 = phase_train(tmp, stage=2, batch=2, frames=8, warmup=2, steps=5, out_dir=args.out)
            train1 = phase_train(tmp, stage=1, batch=4, frames=1, warmup=1, steps=2, out_dir=args.out)
            train3 = phase_train(tmp, stage=3, batch=2, frames=8, warmup=1, steps=2, out_dir=args.out)
        # the SD-1.5 head layout: its level-0 sites run the strided kernels (K5)
        phase_step("flagship-sd15")
        serve_sd15 = phase_serve(args.out, name="flagship-sd15", prompt=PROMPT)["launches"]
        with tempfile.TemporaryDirectory() as tmp:
            train_sd15 = phase_train(tmp, stage=2, batch=2, frames=8, warmup=2, steps=5, out_dir=args.out,
                                     name="flagship-sd15")
    # the flagship under the reference's fused-norm switches: GroupNorm K8a (or
    # K8b) and the fused LN + q/k/v (K7); each phase sets its switches itself
    step_norms = phase_step(runs=(("_norms", NORMS), ("_norms", NORMS_FAST)))[0]["launches"]
    serve_norms = phase_serve(args.out, env=NORMS)["launches"]
    serve_fast = phase_serve(args.out, requests=1, env=NORMS_FAST, profile=False)["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_step(tmp, env=NORMS)
        train_norms = phase_train(tmp, stage=2, batch=2, frames=8, warmup=2, steps=5, out_dir=args.out, env=NORMS)
    # the reference's FF switch: K6's entry points, and the serving request with
    # the plain FF (the end-to-end A/B of K2/K3)
    geglu = phase_geglu_ff()["launches"]
    serve_ff_xla = phase_serve(args.out, requests=2, env=FF_XLA)["launches"]
    # 512^2, the reference's train resolution: the float32 VAE (flash_fwd_d512_f32,
    # head dim 512, in its mid-attention), then serving (the bf16 VAE's d 512 on
    # flash_fwd_sm90) and stage-2 training at full width and depth
    with switches():
        vae512 = phase_vae512()["launches"]
        serve_512 = phase_serve(args.out, size=512)["launches"]
        with tempfile.TemporaryDirectory() as tmp:
            train_512 = phase_train(tmp, stage=2, batch=2, frames=8, warmup=1, steps=2, out_dir=args.out, size=512)
        # training stages 5 (the VAE, through K4's head-dim-512 backward) and 0
        # (the face nets, from the shipped weights)
        with tempfile.TemporaryDirectory() as tmp:
            train_step_vae = phase_train_step_vae(tmp)["launches"]
            # the same float32 step with the small preset's VAE (head dim 256)
            # at 128^2, its preset's size, and with a VAE of last width 640
            # (the wide kernels) at 256^2, as the flagship's (at 128^2 its
            # gradients differ from the CPU by 2.9e-4 with plain attention
            # too: its convolutions)
            train_step_vae_small = phase_train_step_vae(tmp, size=128, vae="small")["launches"]
            train_step_vae_640 = phase_train_step_vae(tmp, vae="640")["launches"]
            train_vae512 = phase_train(tmp, stage=5, batch=4, frames=1, warmup=1, steps=3, out_dir=args.out,
                                       size=512, phase="train_vae512")
            # the same steps with every GroupNorm of the VAE on K8a
            train_vae512_norms = phase_train(tmp, stage=5, batch=4, frames=1, warmup=1, steps=3, out_dir=args.out,
                                             size=512, phase="train_vae512_norms", env=GN_PALLAS)
            face, face_tree = phase_face_nets()
            from emox_torch.train.face_nets import load_face_nets_into

            train0 = phase_train(tmp, stage=0, batch=8, frames=1, warmup=1, steps=5, out_dir=args.out,
                                 dtype="float32", phase="train_stage0",
                                 prepare=lambda m: load_face_nets_into(m.modules, face_tree))
    by_path = {"step": step, "serve": launches, "step_long": step_long, **long["launches_by_path"], "step_attn_pallas": step_pallas, "serve_attn_xla": serve_attn_xla,
               "train_step": train_step,
               "train_stage2_per_step": train2["launches_per_step"],
               "train_stage1_per_step": train1["launches_per_step"],
               "train_stage3_per_step": train3["launches_per_step"],
               "serve_sd15": serve_sd15, "train_sd15_stage2_per_step": train_sd15["launches_per_step"],
               "serve_norms": serve_norms, "serve_norms_fast": serve_fast,
               "train_norms_stage2_per_step": train_norms["launches_per_step"],
               "geglu_ff": geglu, "serve_ff_xla": serve_ff_xla,
               "vae512": vae512, "serve_512": serve_512,
               "train_512_stage2_per_step": train_512["launches_per_step"],
               "step_norms": step_norms,
               "train_step_vae": train_step_vae, "train_step_vae_small": train_step_vae_small,
               "train_step_vae_640": train_step_vae_640, "train_vae512_per_step": train_vae512["launches_per_step"],
               "train_vae512_norms_per_step": train_vae512_norms["launches_per_step"],
               "face_nets": face["launches"], "train_stage0_per_step": train0["launches_per_step"]}
    # launches on each kernel's main path: serving for the forward kernels
    # (flash_fwd_sm90 and ff_sm90 on the flagship's 256^2 request,
    # flash_fwd_d512_f32 in the float32 512^2 VAE, flash_fwd_f32_sm90 and
    # ff_f32_sm90 on the float32 step), the timed stage-2 training steps for the
    # backward (flash_bwd_sm90; flash_bwd_f32_sm90 on the float32 train step;
    # at head dim 512 the stage-5 steps; flash_bwd_d256_sm90 and the wide
    # kernels on the float32 stage-5 steps of the small and the width-640
    # VAEs); the switch kernels' on the serving path under their switches
    # (float32 K7 on the float32 step under them); K6 through its entry
    # points (geglu_ff)
    launches = dict(launches, flash_bwd_sm90=train2["launches"]["flash_bwd_sm90"],
                    flash_fwd_d512_f32=vae512["flash_fwd_d512_f32"], flash_fwd_f32_sm90=step["flash_fwd_f32_sm90"],
                    flash_bwd_f32_sm90=train_step["flash_bwd_f32_sm90"], ff_f32_sm90=step["ff_f32_sm90"],
                    flash_bwd_d256_sm90=train_step_vae_small["flash_bwd_d256_sm90"],
                    flash_fwd_wide=train_step_vae_640["flash_fwd_wide"],
                    flash_bwd_wide=train_step_vae_640["flash_bwd_wide"],
                    group_norm=serve_norms["group_norm"], ln_qkv=serve_norms["ln_qkv"],
                    ln_qkv_sm90=serve_norms["ln_qkv_sm90"], ln_qkv_f32_sm90=step_norms["ln_qkv_f32_sm90"],
                    group_norm_stats=serve_fast["group_norm_stats"], geglu_ff=geglu["geglu_ff"],
                    flash_bwd_d512_sm90=train_vae512["launches"]["flash_bwd_d512_sm90"],
                    flash_bwd_d512_f32=train_step_vae["flash_bwd_d512_f32"])
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K7's, K8's and the head-dim-512 kernels' times without the host's cost of
    # issuing the calls (device_ms); the latter's bound of the work they issue
    device_fields = ("device_ms", "library_device_ms", "issued_bound_ms", "unfused_device_ms")
    shape = lambda k: {x: k[x] for x in ("function", "layout", "dtype", "n", "lq", "lk", "l", "c", "heads", "head_dim",
                                         "m", "f", "row_tile", "col_tile", "col_tiles_per_block", "grid_blocks",
                                         "smem_bytes", "blocks_per_sm", "gemm1_blocks", "gemm2_blocks", "splits",
                                         "sms", "regime", "cluster", "stages", "chunks", "slices", "slice_cols",
                                         "key_parts", "stream_parts", "bwd_plan", "dkv_cluster",
                                         "library_backend", "dkv_grid_blocks", "dkv_smem_bytes",
                                         "plain_rows_per_call", "unfused_ms", "tflops", "device_tflops",
                                         "gb_per_s") if x in k}

    def entry(source, replaces, main, others):
        """One row per CUDA kernel: its numbers at `main` (the shape of the
        TPU kernel named first), and every timed shape in by_shape; its
        launches from its launcher's counter on the kernel's main path and
        on every path."""
        counter = main["kernel"]
        return {"name": counter, "route": "cuda", "source": source, "replaces": replaces[0],
                "also_replaces": replaces[1:],
                "launches": launches[counter],
                "launches_by_path": {p: c[counter] for p, c in by_path.items()},
                **{f: main[f] for f in (*fields, *device_fields) if f in main}, "shape": shape(main),
                "by_shape": [{**shape(k), **{f: k[f] for f in (*fields, *device_fields) if f in k}}
                             for k in (main, *others)]}

    emit({"kernels": [
        # one kernel for both layouts' bf16 forward: the packed sites are
        # _flash_nlc_kernel's, the strided (head-split) ones _flash_kernel's
        entry("emox_torch/csrc/flash_fwd_sm90.cu", ["emox/ops/attention.py:409", "emox/ops/attention.py:69"],
              kern["flash_n32"], [kern["flash_n16"], kern["flash_n128"], kern["flash_512_l0"], kern["flash_512_l1"],
                                  kern["flash_strided_n32"], kern["flash_strided_n16"], kern["flash_d512"],
                                  kern["flash_strided_n32_d64"]]),
        entry("emox_torch/csrc/flash_fwd_d512_f32.cu", ["emox/ops/attention.py:409"], kern["flash_d512_f32"],
              [kern["flash_d512_f32_n16"]]),
        # float32 on the same source's kernels, on a two-part bf16 split; its
        # main row at the float32 step's packed site, whose launches it counts
        entry("emox_torch/csrc/flash_fwd_sm90.cu", ["emox/ops/attention.py:409", "emox/ops/attention.py:69"],
              kern["flash_f32_packed"], [kern["flash_f32_n32"], kern["flash_f32_n32_d64"]]),
        # head dims above 512, both types, forward and backward; the main rows
        # in float32 at the width-640 VAE's stage-5 step, whose launches they
        # count, the bf16 timing at 4096 tokens in by_shape
        entry("emox_torch/csrc/flash_fwd_wide.cu", ["emox/ops/attention.py:409", "emox/ops/attention.py:69"],
              kern["flash_wide_f32"], [kern["flash_wide"]]),
        # the backward's cluster kernels (flash_bwd_cluster.cuh's, CLUSTER 0);
        # flash_attn_wide.cu's slice kernels past their reach, checked at d 2304
        entry("emox_torch/csrc/flash_bwd_wide_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                     "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_wide_f32"], [kern["flash_bwd_wide"]]),
        # one launch entry for the three TPU FF kernels in bf16: level 0 is
        # _ln_ff_kernel's shape, level 1 _ln_ff_wide_kernel's, geglu_ff the
        # FF alone (_ff_kernel's)
        entry("emox_torch/csrc/ff_sm90.cu", ["emox/ops/ff.py:102", "emox/ops/ff.py:120", "emox/ops/ff.py:455"],
              kern["ff_l0"], [kern["ff_l1"], kern["ff_l2"], kern["ff_mid"], kern["ff_512_l0"], kern["ff_512_l1"],
                              kern["ff_512_l2"], kern["ff_512_mid"], kern["geglu_ff_l0"], kern["geglu_ff_l1"],
                              kern["geglu_ff_l2"]]),
        # float32 on the same source's kernels, on a two-part bf16 split: with
        # LN (K2/K3) at the float32 step's level 0, whose launches it counts,
        # and without (K6) in by_shape
        entry("emox_torch/csrc/ff_sm90.cu", ["emox/ops/ff.py:102", "emox/ops/ff.py:120", "emox/ops/ff.py:455"],
              kern["ff_f32"], [kern["geglu_ff_f32"]]),
        # one kernel pair for both layouts' bf16 backward (head dim <= 128):
        # the packed sites are K4's, the strided (head-split) one K5's
        entry("emox_torch/csrc/flash_bwd_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                    "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_n16"], [kern["flash_bwd_n4"], kern["flash_bwd_512_l0"], kern["flash_bwd_512_l1"],
                                      kern["flash_strided_bwd_n16"]]),
        # float32 at head dim <= 128 on the same source's pair, on a two-part split
        entry("emox_torch/csrc/flash_bwd_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                    "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_f32"], []),
        # head dims 129-256, both types: flash_bwd_d512_sm90.cu's pair at half
        # width; the main row in float32 at the small VAE's stage-5 step, whose
        # launches it counts, the bf16 timings in by_shape
        entry("emox_torch/csrc/flash_bwd_d512_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                         "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_d256_f32"], [kern["flash_bwd_d160"], kern["flash_bwd_d256"]]),
        # K4's pair at head dim 512 (the VAE's mid-attention, stage 5): bf16 on
        # the timed stage-5 steps at 512^2, float32 in train_step_vae
        entry("emox_torch/csrc/flash_bwd_d512_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508"],
              kern["flash_bwd_d512"], [kern["flash_bwd_d512_2304"]]),
        # float32 on the same source's kernels, on the split, a cluster of four a tile
        entry("emox_torch/csrc/flash_bwd_d512_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508"],
              kern["flash_bwd_d512_f32"], [kern["flash_bwd_d512_f32_2304"]]),
        # K8a and K8b: one cluster launch per call at the UNet's slabs, two at the VAE's
        entry("emox_torch/csrc/group_norm.cu", ["emox/ops/groupnorm.py:184"],
              kern["gn_l0"], [kern[k] for k in ("gn_l1", "gn_l2", "gn_vae", "gn_512_l0", "gn_512_l1", "gn_512_l2",
                                                "gn_vae512")]),
        entry("emox_torch/csrc/group_norm.cu", ["emox/ops/groupnorm.py:74"],
              kern["gn_l0_stats"], [kern[f"{k}_stats"] for k in ("gn_l1", "gn_l2", "gn_vae", "gn_512_l0", "gn_512_l1",
                                                                 "gn_512_l2", "gn_vae512")]),
        # K7: bf16 on the wgmma + TMA kernel (serve_norms), float32 on the same
        # source's LN + split pass and GEMM on the split (step_norms)
        entry("emox_torch/csrc/ln_qkv_sm90.cu", ["emox/ops/ff.py:353"], kern["ln_qkv_l0"],
              [kern[k] for k in ("ln_qkv_l1", "ln_qkv_l2", "ln_qkv_mid", "ln_qkv_512_l0", "ln_qkv_512_l1",
                                 "ln_qkv_512_l2", "ln_qkv_512_mid")]),
        entry("emox_torch/csrc/ln_qkv_sm90.cu", ["emox/ops/ff.py:353"], kern["ln_qkv_f32"], [kern["ln_qkv_f32_l2"]]),
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
