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
     the CPU (plain versions), TF32 off for matmuls and convolutions. The
     CPU models' weights are drawn on the card and copied over (cpu_model).
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
     export: the flagship's denoise step at one layer per block (bf16,
     256^2, 16 frames, batch 1; EXPORT_LAYERS_PER_BLOCK) exported with
     torch.export, every kernel a registered op
     (emox_torch.ops.registry): export, save and load seconds, the
     artifact's bytes, the loaded call's eps within 1e-3 of the eager
     step's and its launches by kernel equal to the eager call's, the ms of
     each; the ops' host cost a call against the direct route at a small
     shape, and the 256^2 request with every kernel call through its op
     against the direct route; the float32 small preset exported under
     EMOX_LN_QKV=1 EMOX_GROUPNORM_IMPL=pallas, within 3e-4 of the CPU's
     eager step, K7 and K8a launched.
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
     After serve_sd15, import_weights: `python -m emox_torch import-weights`
     on diffusers-named SD-1.5 weights drawn from seeds (tests/torch_ref.py's
     TMiniVAE as a float16 .safetensors, TMiniUNet as a .pt), read, map and
     write seconds and bytes, no unused key; the imported VAE's decode and
     UNet's spatial path in float32 within 3e-4 of the torch models; the
     import merged into serve_sd15's model and one CFG step, finite.
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
 13. cli: the port's command line (emox_torch.cli.main, in-process) on
     the flagship at 256^2 in bf16: the port's fixtures (2 clips x 24
     frames), `precompute` (the trained face nets on the card) and
     `pack-records`; `train` from a stage-2 config written by save_config
     (batch 2 x 8 frames, 7 steps, checkpoint at step 7, steps 3-5 traced) on the records,
     the kernels' launches per step as phase 7 asserts them; `infer` from
     that checkpoint (16 frames, 10 DDIM steps, CFG 7.5, --face-mask auto,
     --speeds), its video bit for bit against a direct EMOPipeline call on
     the restored weights and its launches those of one request; then
     `train-face` (20 steps at 128^2). Each command's seconds, the first and
     steady train steps, the checkpoint's save and restore.
 14. cli_control, step_control, control, train_control_512: the side
     models (model_config "flagship-control": the ControlNet, and the CLIP
     ViT-L/14 vision encoder at full width feeding the identity
     embedding). Through the command line on the cli phase's records (with
     their landmark-skeleton control renders): `train --stage 4` (batch 2 x
     8 frames, 3 steps; the ControlNet's masters changed and nothing else,
     the backward launches per step from the code, stage4_bwd_per_step)
     and `infer --identity` from its checkpoint, bit for bit a direct
     EMOPipeline(..., use_identity=True) call. Float32 on the small preset
     with CLIP cut to 2 layers at 128^2, card against CPU: a CFG step with
     control renders and the identity embedding (eps within 3e-4), the
     loss and gradients of a stage-4 step (1e-5, 2e-4). Serving in bf16 at
     256^2 and 512^2 on one model: a warm-up, a request with per-frame
     control renders of a fixture clip and use_identity=True, the same
     request without (different frames), each with its launches from the
     code (attn_launches_per_request and ff_launches_per_request with the
     ControlNet's term: 7 FF sub-layers a call, and at 512^2 its two level-0
     sites on K1), s/request, phase timings and peak memory. Trainer stage 4
     at 512^2, batch 1 x 8 frames (1 warm-up, 2 timed steps, one profiled):
     8 flash_bwd_sm90 launches a step (the reader's 6 up-path sites at
     levels 0 and 1, the ControlNet's 2 at level 0), the ControlNet alone
     changed, peak memory.
 15. step_sparse_causal, serve_sparse_causal, train_sparse_causal,
     serve_separable, step_separable, train_adafactor_512, and in cli and
     cli_control the trace capture and eval: the rest of the model and
     training options. "flagship-sc" (model.use_sparse_causal): the float32
     step against the CPU, two requests and a profiled one, stage 2 (batch
     2 x 8 frames), each with K1's launches at two a level-0 reader site (Lk
     3072 with the reference, 2048 without) and K4's at BWD_PER_STEP;
     "flagship-sep" (model.separable_convs): two requests and a profiled
     one; step_separable: step_control's float32 step and stage-4 step with
     every ResBlock of the writer, the denoiser and the ControlNet
     separable; train_adafactor_512: stage 1 at 512^2 with
     train.optimizer="adafactor" and train.frozen_dtype="param", its state
     bytes against AdamW's, peak memory and a checkpoint round trip. The
     kernels phase holds K1 and K4 at the sparse-causal Lk 3072 too;
     step_sparse_causal runs after step and step_norms: on the card a model
     built from "flagship-sc" with the step phase's weights, on the CPU the
     step phase's model with the flag set on the same modules.
 16. distributed: the distributed runtime on the one card. The kernels
     phase holds K1 and K4 at the ring's block (Lq = Lk = 4: 8 frames over
     context 2) at the temporal sites of levels 0 and 1 in both types, K6
     at a tensor-parallel shard (F / 2), float32 K1 and K4 at a
     sparse-causal rank's level-0 sites (N 4, Lk 3072 and 2048) and the
     float32 d-512 forward at a stage-5 rank's N 1 x 1024. Then, after
     one-process runs of the same work, two ranks (this script with --rank,
     a gloo world, pinned-host transport: gloo moves no CUDA tensor) run the
     float32 stage-2 step (flagship, batch 1 x 8 frames) at context 2 (the
     ring: K1 / K4 launches per rank from its rotations and sites), on the
     same placed model with sparse-causal attention (the first and previous
     frames exchanged between the ranks) and stage 1 (batch 2 x 1: its frame
     whole on both ranks, no ring launch), at model 2 (K6 on each rank's FF
     shard) with one adafactor update held to one process's at 1e-4, at data
     2 stage 5 (the flagship's VAE, batch 2, d 512 on the float32 kernels)
     and stage 0 (the face nets, batch 8), each metric within 1e-4 of one
     process; each step within |dloss| 1e-4 and grad-norm relative 1e-3 of
     one process; and the 48-frame request with its windows over context 2:
     bf16 against the same windows grouped as the ranks group them in one
     process, float32 against the default request, within 2e-3 x the latent
     scale; s/request and peak memory per rank. A failed rank or a world
     past DIST_DEADLINE_S fails the phase.
 17. the `kernels` line: every ported kernel with the TPU kernel it
     replaces and its numbers.
The line before the last repeats the card's name and power limit; the
last line is {"ok": true, "device": {...}}. Weights are random, from seeds.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import glob
import json
import math
import os
import struct
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
                "flagship-sd15": ("flash_attn_fwd", "flash_attn_bwd"),
                "flagship-control": ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd"),
                "flagship-sc": ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd"),
                "flagship-sep": ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd")}
NAME_TAGS = {"flagship": "", "flagship-sd15": "_sd15", "flagship-control": "_control",  # in phase and file names
             "flagship-sc": "_sparse_causal", "flagship-sep": "_separable"}
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
# (sparse-causal attention: two attentions at each level-0 site, with the
# reference's tokens and without, as the loss's reference dropout asks)
BWD_PER_STEP = {("flagship", 256): 4, ("flagship", 512): 9, ("flagship-sd15", 256): 4, ("flagship-sc", 256): 8,
                ("flagship-sep", 256): 4}
# the export phase's UNets: the flagship's widths at one layer per block (two
# in the flagship); the graph's trace, save and load are host time that scales
# with its depth (84-90 s at full depth on the card machine's hosts)
EXPORT_LAYERS_PER_BLOCK = 1
ATTN_XLA = {"EMOX_ATTENTION_IMPL": "xla"}
ATTN_PALLAS = {"EMOX_ATTENTION_IMPL": "pallas"}
NORMS = {"EMOX_GROUPNORM_IMPL": "pallas", "EMOX_LN_QKV": "1"}
NORMS_FAST = {"EMOX_GROUPNORM_IMPL": "fast", "EMOX_LN_QKV": "1", "EMOX_FUSED_QKV": "1"}
GN_PALLAS = {"EMOX_GROUPNORM_IMPL": "pallas"}
FF_XLA = {"EMOX_FF_IMPL": "xla"}


def model_config(name: str, image_size: int, num_frames: int):
    """The flagship preset; with name "flagship-sd15" the flagship with the
    SD-1.5 head layout and nothing else changed: 8 heads (head dim 40, 80,
    160), ResNet time embedding added, text cross-attention fed by the
    CLIP-L text encoder; with name "flagship-control" the flagship with the
    side models: the ControlNet on 3-channel control renders, and the CLIP
    ViT-L/14 vision encoder (24 layers, 1024 wide, 257 tokens) feeding the
    identity embedding; "flagship-sc" the flagship with sparse-causal
    self-attention (model.use_sparse_causal), "flagship-sep" with separable
    ResBlock convs (model.separable_convs)."""
    import dataclasses

    from emox_torch.core.presets import flagship_config

    cfg = flagship_config(image_size=image_size, num_frames=num_frames)
    if name == "flagship":
        return cfg
    if name in ("flagship-sc", "flagship-sep"):
        flag = "use_sparse_causal" if name == "flagship-sc" else "separable_convs"
        return cfg.replace(model=dataclasses.replace(cfg.model, **{flag: True}))
    if name == "flagship-control":
        return cfg.replace(model=dataclasses.replace(cfg.model, use_controlnet=True, use_identity_embed=True),
                           clip=dataclasses.replace(cfg.clip, vision_enabled=True))
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
    other = [k for n, ks in ATTN_KERNELS.items() if n != name for k in ks if k not in ATTN_KERNELS[name]]
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


def control_sites(cfg) -> list:
    """(level, sites) of the ControlNet's spatial transformers: lpb per
    attention level of its down path, and its mid block at the deepest
    level. They attend to their own tokens only (no reference concat)."""
    m = cfg.model
    return [(level, m.layers_per_block) for level in m.attention_levels] + [(len(m.block_channels) - 1, 1)]


def attn_launches_per_request(cfg, calls: int, control: bool = False) -> dict:
    """Exact launches of the attention forward kernels in one serving
    request whose reader makes `calls` predict_noise calls (the steps for a
    clip of one window, reader_calls for a longer one), from the code. A
    site takes a kernel where its K/V length reaches KERNEL_MIN_KV: the
    packed one (K1) for a head dim % 64 == 0, the strided one (K5)
    otherwise. The sites: every spatial transformer (2 * lpb + 1 per
    attention level, and the mid block at the deepest level) in the writer
    (one batched pass for all steps, Lk = the level's tokens) and in each
    reader call (CFG-batched, the reference tokens appended: Lk = 2 x
    tokens); with `control` (a request with control renders to a model
    with model.use_controlnet) the ControlNet's (control_sites) once per
    reader call, Lk = the level's tokens; the VAE's single-head
    mid-attention, head dim its last width, at the encode of the reference
    image and at the decode (decode_chunk 0), Lk = the latent's tokens.
    Text (the ControlNet's null context included), audio and temporal
    attention stay far below the cutoff; the CLIP vision encoder's
    attention is plain. With model.use_sparse_causal the reader's sites
    (clips of several frames) attend to the first and previous frames'
    tokens: two attentions each, Lk = 3 x tokens with the reference and 2 x
    tokens without it (the CFG-batched call drops the reference per row);
    the writer, one frame, gathers nothing."""
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
        reader = ((3 * tokens, calls), (2 * tokens, calls)) if m.use_sparse_causal else ((2 * tokens, calls),)
        for lk, passes in (*reader, (tokens, 1)):  # reader, writer
            if lk >= KERNEL_MIN_KV:
                want[kernel(head_dim(m.block_channels[level]))] += count * passes
    if control and m.use_controlnet:
        for level, count in control_sites(cfg):
            if (lat >> level) ** 2 >= KERNEL_MIN_KV:
                want[kernel(head_dim(m.block_channels[level]))] += count * calls
    if lat * lat >= KERNEL_MIN_KV:
        want[kernel(v.base_channels * v.channel_multipliers[-1])] += 2
    return want


def fwd_sources_per_request(cfg, calls: int, control: bool = False) -> dict:
    """The same launches by kernel in a bf16 request: every site, the VAE's
    head-dim-512 mid-attention included, on flash_fwd_sm90."""
    return {"flash_fwd_sm90": sum(attn_launches_per_request(cfg, calls, control).values()), "flash_fwd_f32_sm90": 0,
            "flash_fwd_d512_f32": 0, "flash_fwd_wide": 0}


def ff_launches_per_request(cfg, calls: int, control: bool = False) -> int:
    """Exact FF sub-layers (fused_ln_geglu_ff calls) in one serving request
    whose reader makes `calls` predict_noise calls, from the code: one per
    TransformerBlock, so as many as K7's sites (norm_launches_per_request):
    every spatial transformer of the writer (one batched pass) and, per
    reader call, of the reader and its temporal ones, and with `control`
    of the ControlNet (control_sites; one call per reader call)."""
    m = cfg.model
    sites = len(m.attention_levels) * (2 * m.layers_per_block + 1) + 1
    extra = sum(n for _, n in control_sites(cfg)) if control and m.use_controlnet else 0
    return sites * (1 + calls * (2 if m.use_temporal else 1)) + extra * calls


def train_step_sublayers(cfg, stage: int = 2) -> int:
    """Exact TransformerBlock calls in one loss-and-gradient step with
    remat, each one FF sub-layer (and, under EMOX_LN_QKV, one K7 call),
    from the code: the forward's writer pass and one reader call
    (ff_launches_per_request; at stage 4 with the ControlNet's), then
    remat's recompute in the backward of every reader block whose output
    carries a gradient. Stage 2: the temporal ones (stage 2 trains them)
    and every spatial one but the first, which no trained parameter
    precedes. Stage 4: the up path's spatial and temporal ones, whose
    inputs take the ControlNet's residuals; the down path and the mid
    block precede every residual, and the ControlNet runs without remat.
    The writer is frozen."""
    m = cfg.model
    sites = len(m.attention_levels) * (2 * m.layers_per_block + 1) + 1
    if stage == 4:
        up = len(m.attention_levels) * (m.layers_per_block + 1)
        return ff_launches_per_request(cfg, 1, control=True) + up * (2 if m.use_temporal else 1)
    return ff_launches_per_request(cfg, 1) + sites + (sites - 1)


def stage4_bwd_per_step(cfg) -> int:
    """Exact attention backward launches in one stage-4 loss-and-gradient
    step, from the code: a kernel site (Lk >= KERNEL_MIN_KV) whose output
    carries a gradient. In the frozen denoiser those are the up path's
    sites (lpb + 1 per attention level, Lk = 2 x the level's tokens with
    the reference concatenated): the ControlNet's residuals join the skips
    after the down path and the mid block's output after its attention. In
    the ControlNet every site (control_sites, Lk = the level's tokens),
    since all its weights train."""
    from emox_torch.ops.attention import KERNEL_MIN_KV

    m = cfg.model
    lat = cfg.data.height // cfg.vae.downscale
    tokens = lambda level: (lat >> level) ** 2
    up = sum(m.layers_per_block + 1 for level in m.attention_levels if 2 * tokens(level) >= KERNEL_MIN_KV)
    return up + sum(n for level, n in control_sites(cfg) if tokens(level) >= KERNEL_MIN_KV)


def step_sublayer_launches(cfg, sublayers: int, env=None) -> dict:
    """The float32 FF's and K7's launches expected in a float32 step of
    `sublayers` TransformerBlock calls: every FF sub-layer on the float32
    FF kernel and, with EMOX_LN_QKV on, every K7 call on the float32 K7
    kernel."""
    want = {"ln_geglu_ff": sublayers, FF_SOURCES["float32"]: sublayers}
    if "ln_qkv" in switch_kernels(env):
        want.update({"ln_qkv": sublayers, QKV_SOURCES["float32"]: sublayers})
    return want


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets `t_s`, the seconds since
    the script started, from which each phase's duration follows."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
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


def check_geglu_ff(gen, m, c, dtype=None, timing=True, repeat=False, f=None):
    """fused_geglu_ff (K6: ff_sm90 in bf16, ff_f32_sm90 in float32) against
    geglu_ff_plain (h rounded to x's type, fp32 products, the output rounded
    once) on x [m, c] with F = 4C (or f: a tensor-parallel shard's F / 2);
    repeat and timing as check_ff."""
    import torch
    from emox_torch.ops.ff import fused_geglu_ff, geglu_ff_plain, geglu_ff_xla

    dtype = dtype or torch.bfloat16
    f = f or 4 * c
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
    # CFG (N 32) and stage-2 training (N 16); and at the ControlNet's level-0
    # self-attention at 512^2 (Lq = Lk 4096, no reference concat): serving
    # under CFG (N 32) and stage 4 (N 8)
    results["flash_512_l0"] = check_flash(gen, 32, 4096, 8192, chunk=4)
    results["flash_512_l1"] = check_flash(gen, 32, 1024, 2048, c=640, heads=10, chunk=8)
    results["flash_512_control"] = check_flash(gen, 32, 4096, 4096, chunk=4)
    results["flash_bwd_512_l0"] = check_flash_bwd(gen, 16, 4096, 8192, chunk=2)
    results["flash_bwd_512_l1"] = check_flash_bwd(gen, 16, 1024, 2048, c=640, heads=10, chunk=4)
    results["flash_bwd_512_control"] = check_flash_bwd(gen, 8, 4096, 4096, chunk=2)
    # sparse-causal attention (model.use_sparse_causal) at 256^2 level 0: K/V
    # are the first and previous frames' tokens with the reference's appended
    # (Lk 3072); without the reference (the CFG uncond rows, training's
    # reference dropout) Lk 2048, flash_n32's and flash_bwd_n16's shapes
    results["flash_sc"] = check_flash(gen, 32, 1024, 3072)
    results["flash_bwd_sc"] = check_flash_bwd(gen, 16, 1024, 3072)
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
    # the ring's blocks (emox_torch.ops.ring, the distributed phase): K1 and K4
    # at the flagship's temporal sites with 8 frames over context 2 (Lq = Lk =
    # 4, one key tile of which 4 rows are real; lse and delta padded to the
    # backward's rows): level 0 at 256^2 (N 2 x 1024 positions, 5 heads of 64)
    # and level 1 (N 2 x 256, 10 heads of 64), both types, twice for the same
    # bits; K6 on a tensor-parallel shard (F / 2 over model 2) at the
    # TransformerBlock FF of levels 0 and 1 of the float32 train step (batch 1
    # x 8 frames, 4 a context rank)
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        for level, (n, c, heads) in enumerate(((2048, 320, 5), (512, 640, 10))):
            results[f"ring_l{level}{tag}"] = check_flash(gen, n, 4, 4, c=c, heads=heads, dtype=dtype, repeat=True)
            results[f"ring_bwd_l{level}{tag}"] = check_flash_bwd(gen, n, 4, 4, c=c, heads=heads, dtype=dtype,
                                                                 repeat=True)
        results[f"geglu_ff_tp{tag}"] = check_geglu_ff(gen, 8192, 320, f=640, dtype=dtype, repeat=True)
        check_geglu_ff(gen, 2048, 640, f=1280, dtype=dtype, timing=False, repeat=True)
    # the distributed phase's other rank shapes: the sparse-causal step over
    # context 2 (float32, batch 1 x 8 frames), each rank's 4 frames at the
    # level-0 sites with the reference's tokens (Lk 3072) and without (2048);
    # stage 5 at data 2, each rank's one image at the VAE's mid-attention
    # (N 1 x 1024 tokens, head dim 512)
    for lk in (3072, 2048):
        results[f"flash_sc_cp_f32_{lk}"] = check_flash(gen, 4, 1024, lk, dtype=torch.float32, repeat=True)
        results[f"flash_bwd_sc_cp_f32_{lk}"] = check_flash_bwd(gen, 4, 1024, lk, dtype=torch.float32, repeat=True)
    results["flash_d512_f32_1024"] = check_flash(gen, 1, 1024, 1024, c=512, heads=1, dtype=torch.float32,
                                                 repeat=True)
    return results


# ---- phase 3 ------------------------------------------------------------------
def _fill_zero_init(model, seed: int) -> None:
    """Small seeded values in the zero-initialised output projections, so
    that every conditioning branch reaches the output: with the side models
    also the identity projection, the ControlNet's conditioning embedding
    output and its zero convs."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(seed)
    den = model.modules.denoiser
    targets = [den.speed_embed.fc2, den.face_mask_encoder.zero_conv]
    for name, mod in den.named_modules():
        if name.endswith("_temporal"):
            targets.append(mod.proj_out)
        elif name.endswith("_audio"):
            targets.append(mod.attn.to_out)
    if getattr(den, "has_identity", False):
        targets.append(den.identity_embed_proj)
    cn = model.modules.controlnet
    if cn is not None:
        targets += [cn.cond_embed.conv_out] + [getattr(cn, f"zero_conv_{i}") for i in range(cn.num_zero_convs)]
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


def cpu_model(cfg, shared=None):
    """The float32 model on the CPU of a card-against-CPU phase: random from
    seed 7 with the zero-initialised branches filled from seed 8, drawn on
    the card and copied to the CPU (a flagship's init on the CPU takes
    ~20-28 s, on the card well under one), or, given `shared` (such a model
    of the same preset, built once in main), its modules under this phase's
    configuration, frozen and in eval mode."""
    import copy

    import torch
    from emox_torch.models.emo import EMOModel

    if shared is None:
        model = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=7)
        _fill_zero_init(model, seed=8)
        model.modules.to("cpu", memory_format=torch.contiguous_format)
        model.device = torch.device("cpu")
        torch.cuda.empty_cache()
        return model
    model = copy.copy(shared)
    model.config = cfg
    model.modules.eval().requires_grad_(False)
    return model


def set_sparse_causal(model, on: bool) -> set:
    """Sparse-causal self-attention on or off in a built CPU model's UNets,
    so that one CPU model serves both the plain and the sparse-causal step
    (the option adds no parameter). Returns the names of the modules it set;
    phase_step holds them to those that EMOModel sets for
    model.use_sparse_causal."""
    from emox_torch.nn.attention_blocks import SpatialTransformer

    names = set()
    for part in ("reference_net", "denoiser"):
        for sub, mod in getattr(model.modules, part).named_modules():
            if isinstance(mod, SpatialTransformer):
                mod.sparse_causal = on
                names.add(f"{part}.{sub}")
    return names


def sparse_causal_modules(model) -> set:
    """The names of the modules of a built model that run sparse-causal
    self-attention."""
    return {name for name, mod in model.modules.named_modules() if getattr(mod, "sparse_causal", False)}


def phase_step(name: str = "flagship", runs=(("", None),), shared=None):
    """runs: (phase suffix, switches[, "sparse_causal"]) tuples, each one
    step on the card and on the CPU with the same weights and inputs under
    those switches (and with sparse-causal self-attention, phase
    step_sparse_causal: the card model is built by EMOModel from
    model_config("flagship-sc") and given the CPU model's weights; the CPU
    model gets the flag by set_sparse_causal on exactly the modules that
    EMOModel set). The FF and attention kernels' launches are
    asserted at the counts the code gives (one reader call:
    attn_launches_per_request(cfg, 1), every site on the float32 forward
    kernel). shared: the CPU model to reuse (cpu_model)."""
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
    cpu = cpu_model(cfg, shared)
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
    for suffix, env, *option in runs:
        sparse = "sparse_causal" in option
        run_cfg = model_config("flagship-sc", size, frames) if sparse else cfg
        if gpu.config.model != run_cfg.model:
            del gpu
            torch.cuda.empty_cache()
            gpu = EMOModel(run_cfg, dtype=torch.float32, device="cuda", seed=0)
            gpu.modules.load_state_dict(cpu.modules.state_dict())
        flagged = set_sparse_causal(cpu, sparse)
        cpu.config = run_cfg
        if sparse and flagged != sparse_causal_modules(gpu):
            raise AssertionError("set_sparse_causal and EMOModel(model.use_sparse_causal) differ: "
                                 f"{sorted(flagged ^ sparse_causal_modules(gpu))}")
        if not sparse and sparse_causal_modules(gpu):
            raise AssertionError("the plain step's card model runs sparse-causal attention")
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
        attn = attn_launches_per_request(run_cfg, 1)
        want.update(attn, flash_fwd_f32_sm90=sum(attn.values()))
        res = {"phase": "step" + NAME_TAGS[name] + suffix,
               "config": f"{name} 256^2, 2 frames, CFG-batched{', prompt' if prompted else ''}"
                         f"{', sparse-causal self-attention' if sparse else ''}, float32",
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
    set_sparse_causal(cpu, False)  # the CPU model may be shared with later phases
    cpu.config = cfg
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
_STAGE_LR = {0: 1e-4, 1: 1e-4, 2: 1e-5, 3: 1e-5, 4: 1e-5, 5: 1e-4}


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
    (bench.py), with random audio in place of silence; stage 4's as the
    dataset gives it: control renders in [0, 1] and no audio."""
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
    elif stage == 4:
        out["frames"] = normal(batch, frames, size, size, 3)
        out["control"] = torch.rand((batch, frames, size, size, cfg.model.control_cond_channels), generator=gen,
                                    device=device)
    else:
        out["frames"] = normal(batch, frames, size, size, 3)
        out["wav"] = normal(batch, int(16000 * (frames + 2 * cfg.audio.context_frames) / 25.0))
    if stage == 3:
        out["speeds"] = torch.rand((batch, frames, cfg.model.speed_axes), generator=gen, device=device) * 2 - 1
        yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device), indexing="ij")
        disc = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2).float()
        out["masks"] = disc[None, :, :, None].expand(batch, size, size, 1).contiguous()
    return out


def phase_train_step(tmp: str, env=None, shared=None):
    """env: the switches of the step (none: phase train_step; with some:
    train_step_norms). shared: the CPU model to reuse (cpu_model; the
    trainer marks its trainable leaves, cpu_model clears them again)."""
    import torch
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer, sample_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _train_config(2, batch=1, frames=2, dtype="float32", checkpoint_dir=tmp)
    t0 = time.perf_counter()
    cpu = cpu_model(cfg, shared)
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
    tag = NAME_TAGS[name] + ("" if size == 256 else f"_{size}") + ("_norms" if env else "")
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
    remat = ", remat" if stage in (1, 2, 3, 4) else ""  # of the UNets' attention stacks, which stages 0 and 5 leave out
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
           "bwd_sm90_per_step_expected": (BWD_PER_STEP.get((name, size)) if stage == 2 else
                                          stage4_bwd_per_step(cfg) if stage == 4 else None)}
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
        raise AssertionError(f"{name} {size}^2 stage {stage}: backward kernels per step "
                             f"{res['bwd_sources_per_step']}, expected {want} on flash_bwd_sm90")
    del tr, model, data
    return res


def phase_train_adafactor(tmp: str, size: int = 512, batch: int = 2, warmup: int = 1, steps: int = 2) -> dict:
    """Trainer stage 1 at 512^2 in bf16 with train.optimizer="adafactor" and
    train.frozen_dtype="param", the model drawn by the trainer (the fp32
    init cast to bf16, the frozen leaves' fp32 copies kept): batch 2 x 1
    frame, ms/step, peak memory, the losses finite, trainable masters moved
    and no frozen leaf; the optimizer's state bytes against AdamW's for the
    same trainable set (torch.optim.AdamW's two fp32 moments a parameter).
    Then a checkpoint round trip: the file read back (memory-mapped) holds
    the frozen leaves in fp32 with the bits of the trainer's copies, and the
    moments with the optimizer's bits (resume itself: the CPU tests). The
    kernels' launches as phase train asserts them."""
    import dataclasses

    import torch
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer

    torch.cuda.empty_cache()
    cfg = _train_config(1, batch=batch, frames=1, dtype="bfloat16", checkpoint_dir=tmp, size=size)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, optimizer="adafactor", frozen_dtype="param"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    data = _train_batch(gen, 1, batch, 1, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cpu = lambda t: t.detach().to("cpu", copy=True)
    start = {n: m.sum(dtype=torch.float64).item() for n, m in tr.state.masters.items()}
    frozen_start = {n: cpu(p) for n, p in tr.model.modules.named_parameters() if n in tr.frozen}
    losses = []
    for _ in range(warmup):
        losses.append(float(tr.train_step(data, gen)["loss"]))
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(float(tr.train_step(data, gen)["loss"]))
    secs = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(m.sum(dtype=torch.float64).item() != start[n] for n, m in tr.state.masters.items())
    frozen_changed = sum(not torch.equal(cpu(p), frozen_start[n]) for n, p in tr.model.modules.named_parameters()
                         if n in frozen_start)
    n_train = sum(m.numel() for m in tr.state.masters.values())
    state_bytes = tr.state.optimizer.state_bytes()

    # the checkpoint round trip
    t0 = time.perf_counter()
    tr.ckpt.save(tr.state.step, tr._payload())
    save_s = time.perf_counter() - t0
    path = tr.ckpt._path(tr.state.step)
    t0 = time.perf_counter()
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    frozen_dtypes = sorted({str(saved["params"][n].dtype) for n in tr.frozen})
    frozen_bits = all(torch.equal(saved["params"][n], cpu(f)) for n, f in tr.frozen.items())
    live = tr.state.optimizer.adafactor.state_dict()
    restored = all((a is None and b is None) or torch.equal(cpu(a), b) for key in ("v_row", "v_col", "v")
                   for a, b in zip(live[key], saved["opt_state"]["adafactor"][key]))
    read_s = time.perf_counter() - t0
    del saved, live
    factored = sum(d is not None for d in tr.state.optimizer.adafactor.dims)
    ms = 1e3 * secs / steps
    res = {"phase": "train_adafactor_512", "stage": 1,
           "config": f"flagship {size}^2 stage 1, batch {batch}, 1 frame, bf16 compute, fp32 masters, adafactor "
                     f"lr {_STAGE_LR[1]}, frozen_dtype=param, remat; {warmup} warm-up + {steps} timed steps",
           "params": sum(p.numel() for p in tr.model.modules.parameters()), "trainable_params": n_train,
           "trainable_leaves": len(tr.state.masters), "factored_leaves": factored, "frozen_leaves": len(tr.frozen),
           "frozen_params": sum(f.numel() for f in tr.frozen.values()),
           "frozen_copies_on": sorted({str(f.device) for f in tr.frozen.values()}),
           "setup_s": setup_s, "ms_per_step": ms, "frames_per_s": batch * 1e3 / ms, "peak_mem_gb": peak,
           "optimizer_state_bytes": state_bytes, "optimizer_state_bytes_per_param": state_bytes / n_train,
           "adamw_state_bytes": 8 * n_train, "losses": losses, "trainable_masters_moved": moved,
           "frozen_leaves_changed": frozen_changed, "checkpoint_bytes": os.path.getsize(path),
           "checkpoint_save_s": save_s, "checkpoint_read_s": read_s,
           "saved_frozen_dtypes": frozen_dtypes, "saved_frozen_bits_equal": frozen_bits, "saved_moments_equal": restored,
           "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()}}
    emit(res)
    tr.close()
    del tr, data
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses) or not moved or frozen_changed:
        raise AssertionError(f"train_adafactor_512: losses {losses}, {moved} masters moved, "
                             f"{frozen_changed} frozen leaves changed")
    if frozen_dtypes != ["torch.float32"] or not frozen_bits or not restored:
        raise AssertionError(f"train_adafactor_512: the checkpoint round trip failed: {res}")
    if not state_bytes < 4 * n_train:
        raise AssertionError(f"train_adafactor_512: {state_bytes} bytes of state for {n_train} parameters")
    check_path_launches("flagship", counts, train=True, what="flagship 512^2 stage 1 with adafactor")
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


# ---- the command line ----------------------------------------------------------------
def _cli(argv) -> tuple:
    """(seconds, stdout lines) of one `python -m emox_torch` command run
    in-process through emox_torch.cli.main, so that the launch counters see
    its kernels. A command that fails raises."""
    import io

    from emox_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"emox_torch {' '.join(argv)} exited {rc}: {buf.getvalue()[-2000:]}")
    return secs, buf.getvalue().splitlines()


def _write_wav(path: str, seconds: float, seed: int, rate: int = 16000) -> None:
    """A 16-bit mono .wav of seeded noise, written with the standard library."""
    import wave

    import numpy as np

    pcm = np.random.default_rng(seed).normal(0.0, 0.1, int(rate * seconds)).clip(-1, 1)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())


def phase_cli(tmp: str, steps: int = 10, frames: int = 16):
    """The port's command line on the flagship at 256^2 in bf16, through
    emox_torch.cli.main in this process: the port's fixtures (2 clips x 24
    frames), then `precompute` (the trained face nets on the card) and
    `pack-records`; `train` from a stage-2 config that save_config wrote
    (batch 2 x 8 frames, 7 steps, a checkpoint at step 7) on the records,
    with the kernels' launches per step as phase_train asserts them; `infer`
    from that checkpoint (16 frames, 10 DDIM steps, CFG 7.5, --face-mask
    auto, --speeds) against a direct EMOPipeline call on the restored
    weights with the same inputs (the same video, bit for bit) and the
    launches of one request; `train-face` (20 steps at 128^2), its loss
    falling and its file read back. The `train` runs 7 steps with
    EMOX_PROFILE_DIR set: the trace file holds steps 3-5 (fit's annotations
    train_step_3..5) and the card's kernel events in them, the attention
    forward and backward and the FF kernels among them. Then `eval` of the
    infer output against the first clip's cache (its frames, face masks,
    wav and fps) with the checkpoint (latent_frechet from the VAE on the
    card), each metric within 1e-4 of evaluate_clip on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from emox_torch.cli import _load_audio, _load_weights, _restore_params
    from emox_torch.core.config import save_config
    from emox_torch.data.face import geometric_prior_mask
    from emox_torch.data.fixtures import write_fixture_dataset
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.infer.video_io import frames_to_uint8
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train.face_nets import load_face_nets

    torch.cuda.empty_cache()
    secs = {}
    t0 = time.perf_counter()
    meta = write_fixture_dataset(f"{tmp}/clips", num_clips=2, num_frames=24, size=256)
    secs["fixtures"] = time.perf_counter() - t0
    reset_launch_counts()
    secs["precompute"], _ = _cli(["precompute", "--metadata", meta, "--videos", f"{tmp}/clips",
                                  "--cache", f"{tmp}/cache"])
    secs["pack_records"], _ = _cli(["pack-records", "--cache", f"{tmp}/cache", "--out", f"{tmp}/records"])
    prep_counts = launch_counts()

    batch, train_frames, train_steps = 2, 8, 7
    cfg = _train_config(2, batch=batch, frames=train_frames, dtype="bfloat16", checkpoint_dir=f"{tmp}/ckpt")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, cache_dir=f"{tmp}/records"),
                      train=dataclasses.replace(cfg.train, num_steps=train_steps, checkpoint_every=train_steps,
                                                log_every=1))
    save_config(cfg, f"{tmp}/stage2.yaml")
    reset_launch_counts()
    # with fit's trace capture: steps [3, 6) of the run
    saved_env = os.environ.get("EMOX_PROFILE_DIR")
    os.environ["EMOX_PROFILE_DIR"] = f"{tmp}/trace"
    try:
        secs["train"], train_out = _cli(["train", "--config", f"{tmp}/stage2.yaml"])
    finally:
        if saved_env is None:
            os.environ.pop("EMOX_PROFILE_DIR")
        else:
            os.environ["EMOX_PROFILE_DIR"] = saved_env
    train_counts = launch_counts()
    torch.cuda.empty_cache()
    with open(f"{tmp}/ckpt/stage2_metrics.jsonl") as f:
        log = [json.loads(line) for line in f]
    steps_log = [r for r in log if "loss" in r]
    secs["train_first_step"] = next(r["compile_s"] for r in log if "compile_s" in r)
    # steps 1-3, before the trace starts
    secs["train_steady_step"] = (steps_log[2]["time"] - steps_log[0]["time"]) / 2
    ckpt_path = f"{tmp}/ckpt/stage2/step_{train_steps}.pt"
    # the save follows the last step's metrics record: the file's time less the record's
    secs["checkpoint_save"] = os.path.getmtime(ckpt_path) - steps_log[-1]["time"]
    losses = [r["loss"] for r in steps_log]

    ref = np.random.default_rng(5).uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    np.save(f"{tmp}/ref.npy", ref)
    _write_wav(f"{tmp}/speech.wav", (frames + 4) / 25.0, seed=6)
    argv = ["infer", "--config", f"{tmp}/stage2.yaml", "--params", f"{tmp}/ckpt/stage2", "--ref-image",
            f"{tmp}/ref.npy", "--audio", f"{tmp}/speech.wav", "--frames", str(frames), "--steps", str(steps),
            "--guidance", "7.5", "--face-mask", "auto", "--speeds", "0.1,0,0", "--out", f"{tmp}/out.npz"]
    reset_launch_counts()
    secs["infer"], infer_out = _cli(argv)
    infer_counts = launch_counts()
    with np.load(f"{tmp}/out.npz") as z:
        cli_video = z["frames"]

    # the same request, called directly on the restored weights
    t0 = time.perf_counter()
    params = _restore_params(f"{tmp}/ckpt/stage2")
    secs["checkpoint_restore"] = time.perf_counter() - t0
    model = EMOModel(cfg, dtype=torch.bfloat16, device="cuda")
    _load_weights(model, params)
    del params
    wav, _ = _load_audio(f"{tmp}/speech.wav", cfg.audio.sample_rate)
    img = torch.from_numpy(ref[None]).cuda()
    with torch.no_grad():
        mask = (torch.sigmoid(model.locate_face(img).float()) > 0.5).float()
    prior = float(mask.mean()) < 0.01
    if prior:
        mask = torch.from_numpy(geometric_prior_mask(256, 256)[None]).cuda()
    speeds = torch.tensor([0.1, 0.0, 0.0]).expand(1, frames, 3).contiguous().cuda()
    t0 = time.perf_counter()
    video = EMOPipeline(model)(img, torch.from_numpy(wav[None]).cuda(), video_length=frames,
                               num_inference_steps=steps, guidance_scale=7.5, face_mask=mask, speeds=speeds)
    direct = frames_to_uint8(video[0].float().cpu().numpy())
    secs["request"] = time.perf_counter() - t0
    del model, video
    torch.cuda.empty_cache()

    secs["train_face"], face_out = _cli(["train-face", "--steps", "20", "--size", "128", "--out",
                                         f"{tmp}/face_nets.npz"])
    face_losses = [float(line.split("loss ")[1].split()[0]) for line in face_out if line.startswith("step ")]
    face_tree = load_face_nets(f"{tmp}/face_nets.npz")

    traces = glob.glob(f"{tmp}/trace/*.pt.trace.json")
    events = []
    if len(traces) == 1:
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    steps_traced = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                          and e.get("name", "").startswith("train_step_"))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    first = min((e["ts"] for e in events if e.get("name") == "train_step_3"), default=float("inf"))
    trace = {"files": len(traces), "bytes": os.path.getsize(traces[0]) if traces else 0, "steps": steps_traced,
             "kernel_events": len(kernels), "kernel_events_before_step_3": sum(e["ts"] < first for e in kernels),
             **{f"{k}_events": sum(k in e["name"] for e in kernels)
                for k in ("fwd_kernel", "dq_kernel", "dkv_kernel", "geglu_gemm_kernel")}}
    del events, kernels

    # eval: the infer output against the first clip's cache, with the checkpoint
    from emox_torch.eval import evaluate_clip

    cache = sorted(glob.glob(f"{tmp}/cache/*.npz"))[0]
    secs["eval"], eval_out = _cli(["eval", "--gen", f"{tmp}/out.npz", "--gt", cache, "--params", f"{tmp}/ckpt/stage2",
                                   "--config", f"{tmp}/stage2.yaml", "--out", f"{tmp}/metrics.json"])
    metrics = json.loads(eval_out[-1])
    with np.load(cache) as z:
        gt = z["frames"][:frames]
        gt = gt.astype(np.float32) / 127.5 - 1.0 if gt.dtype == np.uint8 else gt.astype(np.float32)
        want = evaluate_clip(cli_video.astype(np.float32) / 127.5 - 1.0, gt=gt, masks=z["face_masks"][:frames],
                             wav=z["wav"], fps=float(z["fps"]) if "fps" in z.files else 25.0, device="cpu")
    # the command prints 6 decimals: half a unit of the last one besides 1e-4 relative
    eval_gap = {k: abs(metrics[k] - v) - (1e-4 * abs(v) + 5e-7) for k, v in want.items()}

    want_train = {k: train_steps * v for k, v in {**dict.fromkeys(BWD_SOURCES, 0),
                                                   "flash_bwd_sm90": BWD_PER_STEP[("flagship", 256)]}.items()}
    want_infer = {**attn_launches_per_request(cfg, steps), **fwd_sources_per_request(cfg, steps),
                  **{k: ff_launches_per_request(cfg, steps) for k in ("ln_geglu_ff", FF_SOURCES["bfloat16"])}}
    launches = {k: train_counts[k] + infer_counts[k] + prep_counts[k] for k in train_counts}
    res = {"phase": "cli", "config": f"flagship 256^2 bf16 through emox_torch.cli.main: fixtures 2 x 24 frames; "
           f"train stage 2 batch {batch} x {train_frames} frames, {train_steps} steps; infer {frames} frames, "
           f"{steps} DDIM steps, CFG 7.5, --face-mask auto; train-face 20 steps at 128^2",
           "seconds": secs, "s_per_request": secs["request"], "losses": losses,
           "checkpoint_bytes": os.path.getsize(ckpt_path), "face_prior_mask": prior,
           "video_shape": list(cli_video.shape), "video_equal": bool(np.array_equal(cli_video, direct)),
           "video_max_abs_diff": int(np.abs(cli_video.astype(np.int16) - direct.astype(np.int16)).max()),
           "face_losses": face_losses, "face_leaves": sorted(face_tree) if face_tree else None,
           "launches": launches, "launches_train": train_counts, "launches_infer": infer_counts,
           "launches_precompute": prep_counts,
           "train_launches_expected": want_train, "infer_launches_expected": want_infer,
           "trace": trace, "eval": metrics, "eval_cpu": want, "eval_gap_over_limit": eval_gap,
           "stdout_tail": {"train": train_out[-2:], "infer": infer_out[-2:], "train_face": face_out[-2:]}}
    emit(res)
    if not (losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"cli train: a loss is not finite: {losses}")
    if any(prep_counts.values()):
        raise AssertionError(f"cli precompute launched kernels of the port: {prep_counts}")
    check_path_launches("flagship", train_counts, train=True, what="cli train stage 2")
    if {k: train_counts[k] for k in want_train} != want_train:
        raise AssertionError(f"cli train: backward kernels {train_counts}, expected {want_train}")
    check_path_launches("flagship", infer_counts, train=False, what="cli infer")
    if {k: infer_counts[k] for k in want_infer} != want_infer:
        raise AssertionError(f"cli infer: launched {infer_counts}, expected {want_infer}")
    if cli_video.shape != (frames, 256, 256, 3) or not res["video_equal"]:
        raise AssertionError(f"cli infer: the video {cli_video.shape} differs from the direct pipeline call "
                             f"(max |diff| {res['video_max_abs_diff']})")
    if not (len(face_losses) >= 2 and face_losses[-1] < face_losses[0]):
        raise AssertionError(f"cli train-face: the loss did not fall: {face_losses}")
    if face_tree is None or set(face_tree) != {"face_locator", "landmarker"}:
        raise AssertionError("cli train-face: load_face_nets does not read the file back")
    if not (trace["files"] == 1 and trace["steps"] == ["train_step_3", "train_step_4", "train_step_5"]
            and trace["kernel_events"] > 0 and not trace["kernel_events_before_step_3"]
            and min(trace[f"{k}_events"] for k in ("fwd_kernel", "dkv_kernel", "geglu_gemm_kernel")) > 0):
        raise AssertionError(f"cli train with EMOX_PROFILE_DIR: the trace does not hold steps 3-5's kernels: {trace}")
    if set(metrics) != set(want) | {"latent_frechet"} or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli eval: metrics {metrics}, expected those of {want} and latent_frechet")
    if max(eval_gap.values()) > 0:
        raise AssertionError(f"cli eval: the card's metrics differ from the CPU's by more than 1e-4: {eval_gap}")
    return res


# ---- the side models: ControlNet, CLIP vision and the identity embedding -----------------------
def control_request(size: int, frames: int, seed: int):
    """A request's reference image and per-frame control renders from the
    port's fixture clip (seeded): its first frame [size, size, 3] in [-1, 1]
    and render_landmark_skeleton of its landmark series [frames, size,
    size, 3] in [0, 1], as `precompute` writes them."""
    from emox_torch.data.face import render_landmark_skeleton
    from emox_torch.data.fixtures import make_synthetic_clip

    clip = make_synthetic_clip(seed=seed, num_frames=frames, height=size, width=size)
    return clip["frames"][0], render_landmark_skeleton(clip["landmarks"], size, size)


def phase_control(steps: int = 10, frames: int = 16) -> dict:
    """The flagship with the side models (model_config "flagship-control":
    the ControlNet, and CLIP ViT-L/14 at its full width feeding the
    identity embedding) in bf16, its zero-initialised projections filled
    with small seeded values so that every branch is live. At 256^2 and at
    512^2, on one model: a warm-up request, then one request with the
    control renders of a fixture clip and use_identity=True, and the same
    request without either; 16 frames, 10 DDIM steps, CFG 7.5 batched,
    3-axis speeds, face mask. The frames are finite and differ between the
    two; each request's launches are those the code gives
    (attn_launches_per_request and ff_launches_per_request with and
    without the ControlNet's term: at 512^2 the ControlNet's two level-0
    sites, 4096 tokens, take K1)."""
    import torch
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    name = "flagship-control"
    t0 = time.perf_counter()
    model = EMOModel(model_config(name, 256, frames), dtype=torch.bfloat16, device="cuda", seed=0)
    _fill_zero_init(model, seed=4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = {k: sum(p.numel() for p in m.parameters()) for k, m in model.modules.named_children()}
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"phase": "control", "config": f"{name}: flagship + ControlNet + CLIP ViT-L/14 identity embedding, "
           f"bf16, {frames} frames, CFG 7.5 batched, {steps} DDIM steps", "params": params, "setup_s": setup_s}
    for size in (256, 512):
        cfg = model_config(name, size, frames)
        pipe = EMOPipeline(model, cfg)
        img_np, ctrl_np = control_request(size, frames, seed=size)
        img = torch.from_numpy(img_np[None]).to("cuda", torch.bfloat16)
        ctrl = torch.from_numpy(ctrl_np[None]).to("cuda", torch.bfloat16)
        _, wav, speeds, mask = _request_inputs(gen, "cuda", size, frames, torch.bfloat16)

        def request(side: bool, timings=None):
            extra = dict(use_identity=True, control_cond=ctrl) if side else {}
            video = pipe(img, wav, video_length=frames, num_inference_steps=steps, guidance_scale=7.5, speeds=speeds,
                         face_mask=mask, generator=torch.Generator(device="cuda").manual_seed(7), timings=timings,
                         **extra)
            torch.cuda.synchronize()
            return video

        request(True)  # warm-up: this size's shapes
        runs = {}
        for side in (True, False):
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            timings = {}
            t0 = time.perf_counter()
            video = request(side, timings)
            secs = time.perf_counter() - t0
            counts = launch_counts()
            want = {**attn_launches_per_request(cfg, steps, side), **fwd_sources_per_request(cfg, steps, side),
                    **{k: ff_launches_per_request(cfg, steps, side) for k in ("ln_geglu_ff", FF_SOURCES["bfloat16"])}}
            runs["side" if side else "plain"] = {
                "s_per_request": secs, "ms_per_step": 1e3 * timings["denoise_s"] / steps, "phases_s": timings,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
                "launches_expected": want, "finite": bool(torch.isfinite(video.float()).all().item()),
                "shape": list(video.shape), "video": video}
        side, plain = runs["side"].pop("video"), runs["plain"].pop("video")
        rel = (torch.linalg.vector_norm((side - plain).float()) / torch.linalg.vector_norm(plain.float())).item()
        out[f"{size}"] = {**runs, "side_vs_plain_rel_l2": rel}
        del side, plain, pipe
        torch.cuda.empty_cache()
        for key, run in runs.items():
            what = f"{name} {size}^2 {key} request"
            if not run["finite"] or run["shape"] != [1, frames, size, size, 3]:
                emit(out)
                raise AssertionError(f"{what}: output finite={run['finite']} shape={run['shape']}")
            check_path_launches(name, run["launches"], train=False, what=what)
            if {k: run["launches"][k] for k in run["launches_expected"]} != run["launches_expected"]:
                emit(out)
                raise AssertionError(f"{what}: launched {run['launches']}, expected {run['launches_expected']}")
        if not rel > 0:
            emit(out)
            raise AssertionError(f"{name} {size}^2: control and identity did not change the frames")
    emit(out)
    del model
    torch.cuda.empty_cache()
    return out


def _small_control_config(frames: int):
    """The small preset with the side models and CLIP cut to 2 layers (its
    widths, 224-pixel input and projection as CLIP ViT-L/14's): the float32
    card-against-CPU checks' reduced depth."""
    import dataclasses

    from emox_torch.core.presets import small_config

    cfg = small_config(image_size=128, num_frames=frames)
    return cfg.replace(model=dataclasses.replace(cfg.model, use_controlnet=True, use_identity_embed=True),
                       clip=dataclasses.replace(cfg.clip, vision_enabled=True, vision_layers=2))


def phase_step_control(tmp: str, separable: bool = False) -> dict:
    """Float32, the card against the CPU with the same weights and inputs,
    TF32 off, on the small preset with the side models (CLIP cut to 2
    layers; with `separable`, phase step_separable, every ResBlock of the
    writer, the denoiser and the ControlNet on separable convs) at 128^2, 2
    frames: one CFG-batched denoise step with per-frame
    control renders and the identity embedding (eps within 3e-4 relative
    L2, phase step's bar), then the loss and gradients of one stage-4 step
    (the ControlNet's, through the frozen denoiser; the loss within 1e-5,
    the gradients within 2e-4, phase train_step's bars). No attention site
    of this size reaches KERNEL_MIN_KV: every FF sub-layer takes
    ff_f32_sm90, at the counts the code gives, and nothing else launches."""
    import dataclasses

    import torch
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer, sample_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, frames = 128, 2
    cfg = _small_control_config(frames)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, separable_convs=separable),
                      train=dataclasses.replace(cfg.train, stage=4, learning_rate=_STAGE_LR[4],
                                                compute_dtype="float32", checkpoint_dir=tmp, resume=False))
    phase = "step_separable" if separable else "step_control"
    t0 = time.perf_counter()
    cpu = EMOModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    _fill_zero_init(cpu, seed=8)
    gpu = EMOModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    setup_s = time.perf_counter() - t0

    gen = torch.Generator(device="cpu").manual_seed(19)
    img, wav, _, mask = _request_inputs(gen, "cpu", size, frames, torch.float32)
    speeds = torch.rand((1, frames), generator=gen) * 2 - 1  # the small preset's scalar speeds
    lat = size // cfg.vae.downscale
    noisy = torch.randn((1, frames, lat, lat, 4), generator=gen)
    ctrl = torch.from_numpy(control_request(size, frames, seed=3)[1][None])
    t = torch.tensor([500])

    def step(model, dev):
        mv = lambda x: x.to(dev)
        ref = model.encode_images(mv(img))
        audio = model.encode_audio(mv(wav), frames)
        face = model.encode_face_mask(mv(mask), lat)
        ide = EMOPipeline(model).encode_identity(mv(img))
        cat = lambda x: torch.cat([x, x])
        eps = model.predict_noise(cat(mv(noisy)), cat(mv(t)), cat(ref), audio_windows=torch.cat(
            [torch.zeros_like(audio), audio]), speeds=cat(mv(speeds)), face_feat=cat(face), control_cond=cat(mv(ctrl)),
            identity_embed=torch.cat([torch.zeros_like(ide), ide]), ref_dropout=mv(torch.tensor([True, False])))
        return {"identity": ide, "eps": eps}

    rel_l2 = lambda a, b: (torch.linalg.vector_norm(a.cpu().double() - b.double())
                           / torch.linalg.vector_norm(b.double()).clamp_min(1e-30)).item()
    t0 = time.perf_counter()
    on_cpu = step(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    on_gpu = step(gpu, "cuda")
    torch.cuda.synchronize()
    step_counts = launch_counts()
    step_rel = {k: rel_l2(on_gpu[k], v) for k, v in on_cpu.items()}

    tr_cpu, tr_gpu = Trainer(cfg, model=cpu), Trainer(cfg, model=gpu)
    batch = _train_batch(gen, 4, 1, frames, cfg, "cpu")
    batch["control"] = ctrl.clone()
    draws = sample_draws(cfg, tr_cpu.sched, 4, batch, gen)
    t0 = time.perf_counter()
    m_cpu, g_cpu = tr_cpu.loss_and_grads(batch, draws)
    cpu_s += time.perf_counter() - t0
    reset_launch_counts()
    m_gpu, g_gpu = tr_gpu.loss_and_grads({k: v.cuda() for k, v in batch.items()},
                                         {k: v.cuda() for k, v in draws.items()})
    torch.cuda.synchronize()
    train_counts = launch_counts()
    tr_cpu.close()
    tr_gpu.close()
    loss_rel = abs(m_gpu["loss"].double().item() - m_cpu["loss"].double().item()) / abs(m_cpu["loss"].item())
    diff = sum(float(torch.linalg.vector_norm(a.cpu().double() - b.double()) ** 2) for a, b in zip(g_gpu, g_cpu))
    grads_rel = math.sqrt(diff / sum(float(torch.linalg.vector_norm(b.double()) ** 2) for b in g_cpu))
    limits = {"eps_rel_l2": 3e-4, "loss_rel": 1e-5, "grads_rel_l2": 2e-4}
    want_step = step_sublayer_launches(cfg, ff_launches_per_request(cfg, 1, control=True))
    want_train = step_sublayer_launches(cfg, train_step_sublayers(cfg, stage=4))
    res = {"phase": phase, "config": f"small {size}^2 + ControlNet + CLIP vision (2 layers of ViT-L/14 "
           f"width) + identity embedding{', separable ResBlock convs' if separable else ''}, {frames} frames, "
           "float32: a CFG-batched step, then a stage-4 step",
           "rel_l2": step_rel, "loss_cpu": m_cpu["loss"].item(), "loss_gpu": m_gpu["loss"].item(),
           "loss_rel": loss_rel, "grads_rel_l2": grads_rel, "limits": limits, "trainable_leaves": len(g_cpu),
           "trainable_params": sum(g.numel() for g in g_cpu), "launches_step": step_counts,
           "launches_step_expected": want_step, "launches_train": train_counts,
           "launches_train_expected": want_train, "setup_s": setup_s, "cpu_s": cpu_s}
    emit(res)
    del cpu, gpu, tr_cpu, tr_gpu
    torch.backends.cudnn.allow_tf32 = True
    if not (step_rel["eps"] <= limits["eps_rel_l2"] and step_rel["identity"] <= limits["eps_rel_l2"]):
        raise AssertionError(f"{phase}: card and CPU disagree: {step_rel}")
    if not (loss_rel <= limits["loss_rel"] and grads_rel <= limits["grads_rel_l2"]):
        raise AssertionError(f"{phase}: stage-4 loss {loss_rel} or gradients {grads_rel} disagree")
    for counts, want, what in ((step_counts, want_step, "step"), (train_counts, want_train, "stage-4 step")):
        if counts != {**dict.fromkeys(counts, 0), **want}:
            raise AssertionError(f"{phase} {what}: launched {counts}, expected only {want}")
    return res


def phase_cli_control(tmp: str, steps: int = 10, frames: int = 16) -> dict:
    """The side models through emox_torch.cli.main on the cli phase's
    records (whose `precompute` wrote the landmark-skeleton control renders)
    and request files, flagship-control at 256^2 in bf16: `train --stage 4`
    from a config that save_config wrote (batch 2 x 8 frames, no motion
    frames, 3 steps, a checkpoint at step 3) from the trainer's seeded
    init, the backward launches per step at stage4_bwd_per_step; the
    checkpoint against that init (the ControlNet's masters changed, every
    other leaf the same bits); then `infer --identity` from the checkpoint
    (16 frames, 10 DDIM steps, CFG 7.5, --speeds), bit for bit the frames of
    a direct EMOPipeline(..., use_identity=True) call on the restored
    weights, with the launches of one request without control; then `eval
    --ref-image` of that video with the checkpoint: identity_similarity from
    its CLIP vision encoder (float32, on the card), finite, in [-1, 1]."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from emox_torch.cli import _load_audio, _load_weights, _restore_params
    from emox_torch.core.config import save_config
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.infer.video_io import frames_to_uint8
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    name = "flagship-control"
    shutil.rmtree(f"{tmp}/ckpt", ignore_errors=True)  # the cli phase's checkpoints: disk for this one's
    torch.cuda.empty_cache()
    secs = {}
    batch, train_frames, train_steps = 2, 8, 3
    cfg = _train_config(4, batch=batch, frames=train_frames, dtype="bfloat16", checkpoint_dir=f"{tmp}/ckpt_control",
                        name=name)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, cache_dir=f"{tmp}/records", num_motion_frames=0),
                      train=dataclasses.replace(cfg.train, num_steps=train_steps, checkpoint_every=train_steps,
                                                log_every=1))
    save_config(cfg, f"{tmp}/stage4.yaml")
    reset_launch_counts()
    secs["train"], train_out = _cli(["train", "--config", f"{tmp}/stage4.yaml"])
    train_counts = launch_counts()
    torch.cuda.empty_cache()
    with open(f"{tmp}/ckpt_control/stage4_metrics.jsonl") as f:
        log = [json.loads(line) for line in f]
    steps_log = [r for r in log if "loss" in r]
    secs["train_first_step"] = next(r["compile_s"] for r in log if "compile_s" in r)
    secs["train_steady_step"] = (steps_log[-1]["time"] - steps_log[0]["time"]) / (len(steps_log) - 1)
    losses = [r["loss"] for r in steps_log]

    t0 = time.perf_counter()
    params = _restore_params(f"{tmp}/ckpt_control/stage4")
    secs["checkpoint_restore"] = time.perf_counter() - t0
    model = EMOModel(cfg, dtype=torch.bfloat16, device="cuda", seed=cfg.train.seed)  # the trainer's init
    changed, frozen_changed = 0, []
    for n, p in model.modules.named_parameters():
        same = torch.equal(params[n].to("cuda").float(), p.float())
        if n.startswith("controlnet."):
            changed += not same
        elif not same:
            frozen_changed.append(n)
    controlnet_leaves = sum(1 for n in params if n.startswith("controlnet."))
    _load_weights(model, params)
    del params

    argv = ["infer", "--config", f"{tmp}/stage4.yaml", "--params", f"{tmp}/ckpt_control/stage4", "--ref-image",
            f"{tmp}/ref.npy", "--audio", f"{tmp}/speech.wav", "--frames", str(frames), "--steps", str(steps),
            "--guidance", "7.5", "--speeds", "0.1,0,0", "--identity", "--out", f"{tmp}/identity.npz"]
    reset_launch_counts()
    secs["infer"], infer_out = _cli(argv)
    infer_counts = launch_counts()
    with np.load(f"{tmp}/identity.npz") as z:
        cli_video = z["frames"]
    wav, _ = _load_audio(f"{tmp}/speech.wav", cfg.audio.sample_rate)
    img = torch.from_numpy(np.load(f"{tmp}/ref.npy")[None]).cuda()
    speeds = torch.tensor([0.1, 0.0, 0.0]).expand(1, frames, 3).contiguous().cuda()
    t0 = time.perf_counter()
    video = EMOPipeline(model)(img, torch.from_numpy(wav[None]).cuda(), video_length=frames,
                               num_inference_steps=steps, guidance_scale=7.5, speeds=speeds, use_identity=True)
    direct = frames_to_uint8(video[0].float().cpu().numpy())
    secs["request"] = time.perf_counter() - t0
    del model, video
    torch.cuda.empty_cache()
    secs["eval"], eval_out = _cli(["eval", "--gen", f"{tmp}/identity.npz", "--ref-image", f"{tmp}/ref.npy",
                                   "--params", f"{tmp}/ckpt_control/stage4", "--config", f"{tmp}/stage4.yaml"])
    metrics = json.loads(eval_out[-1])
    torch.cuda.empty_cache()

    want_train = {k: train_steps * v for k, v in {**dict.fromkeys(BWD_SOURCES, 0),
                                                   "flash_bwd_sm90": stage4_bwd_per_step(cfg)}.items()}
    want_infer = {**attn_launches_per_request(cfg, steps), **fwd_sources_per_request(cfg, steps),
                  **{k: ff_launches_per_request(cfg, steps) for k in ("ln_geglu_ff", FF_SOURCES["bfloat16"])}}
    res = {"phase": "cli_control", "config": f"{name} 256^2 bf16 through emox_torch.cli.main on the cli phase's "
           f"records: train --stage 4 batch {batch} x {train_frames} frames, {train_steps} steps; infer --identity "
           f"{frames} frames, {steps} DDIM steps, CFG 7.5", "seconds": secs, "s_per_request": secs["request"],
           "losses": losses, "checkpoint_bytes": os.path.getsize(f"{tmp}/ckpt_control/stage4/step_{train_steps}.pt"),
           "controlnet_leaves": controlnet_leaves, "controlnet_leaves_changed": changed,
           "frozen_leaves_changed": frozen_changed[:8], "video_shape": list(cli_video.shape),
           "video_equal": bool(np.array_equal(cli_video, direct)),
           "video_max_abs_diff": int(np.abs(cli_video.astype(np.int16) - direct.astype(np.int16)).max()),
           "launches_train": train_counts, "launches_infer": infer_counts, "train_launches_expected": want_train,
           "infer_launches_expected": want_infer, "eval": metrics,
           "stdout_tail": {"train": train_out[-2:], "infer": infer_out[-2:]}}
    emit(res)
    if not (losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"cli train --stage 4: a loss is not finite: {losses}")
    if not changed or frozen_changed:
        raise AssertionError(f"cli train --stage 4: {changed} ControlNet leaves changed, frozen ones changed: "
                             f"{frozen_changed[:8]}")
    check_path_launches(name, train_counts, train=True, what="cli train stage 4")
    if {k: train_counts[k] for k in want_train} != want_train:
        raise AssertionError(f"cli train --stage 4: backward kernels {train_counts}, expected {want_train}")
    check_path_launches(name, infer_counts, train=False, what="cli infer --identity")
    if {k: infer_counts[k] for k in want_infer} != want_infer:
        raise AssertionError(f"cli infer --identity: launched {infer_counts}, expected {want_infer}")
    if cli_video.shape != (frames, 256, 256, 3) or not res["video_equal"]:
        raise AssertionError(f"cli infer --identity: the video {cli_video.shape} differs from the direct pipeline "
                             f"call (max |diff| {res['video_max_abs_diff']})")
    sim = metrics.get("identity_similarity", float("nan"))
    if set(metrics) != {"identity_similarity"} or not -1.0 <= sim <= 1.0:
        raise AssertionError(f"cli eval --ref-image: {metrics}")
    return res


# ---- phase 4 ------------------------------------------------------------------
def phase_serve(out_dir: str, requests: int = 3, steps: int = 10, name: str = "flagship", prompt=None, env=None,
                profile: bool = True, size: int = 256, keep: dict = None):
    """env: the switches of the run (none: phase serve / serve_sd15 /
    serve_512; with norm switches: serve_norms, whose launches of the switch
    kernels are asserted at the count norm_launches_per_request derives;
    EMOX_FF_IMPL=xla: serve_ff_xla). The attention kernels' launches are
    asserted at the count attn_launches_per_request derives. keep: a dict
    that receives the served model ("model") for a later phase."""
    import torch
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.empty_cache()
    frames = 16
    cfg = model_config(name, size, frames)
    tag = NAME_TAGS[name] + ("" if size == 256 else f"_{size}")
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
    if keep is not None:
        keep["model"] = model
    return res


# ---- the exported step, the ops' dispatch cost, and weights from diffusers --------------
def _rel_l2(got, want) -> float:
    import torch

    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-30)).item()


def _host_us(fn, calls: int = 200) -> float:
    """Microseconds a call of fn takes at a shape small enough that the host
    sets the pace: `calls` calls, the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def op_dispatch_cost() -> dict:
    """Per kernel entry of the serving path and the switches, the host's cost
    of one call through the registered op (emox_torch.ops.registry,
    through_ops()) against the direct route the eager program takes, at a
    small shape (level 0 of the flagship at 64 tokens, bf16): microseconds a
    call, each route's least of three turns (direct, op, direct, op, ...)."""
    import torch
    from emox_torch.ops import fused_group_norm, fused_ln_geglu_ff, fused_ln_qkv, group_norm_stats, registry
    from emox_torch.ops.attention import flash_attention_nlc

    gen = torch.Generator(device="cuda").manual_seed(31)
    r = lambda *s: _rand(gen, *s, dtype=torch.bfloat16)
    x, ln = r(64, 320), (1 + 0.1 * r(320), 0.1 * r(320))
    ff = (r(2560, 320) * 0.05, r(2560) * 0.1, r(320, 1280) * 0.03, r(320) * 0.1)
    q, kv = r(2, 64, 320), r(2, 128, 320)
    w = r(320, 320) * 0.05
    xg = r(2, 64, 320)
    calls = {"ln_geglu_ff": lambda: fused_ln_geglu_ff(x, *ln, *ff),
             "flash_attn_nlc_fwd": lambda: flash_attention_nlc(q, kv, kv, 5),
             "ln_qkv": lambda: fused_ln_qkv(x, *ln, w, w, w),
             "group_norm": lambda: fused_group_norm(xg, *ln, 32, silu=True),
             "group_norm_stats": lambda: group_norm_stats(xg)}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            turns = {True: [], False: []}
            for direct in (True, False) * 3:
                with contextlib.nullcontext() if direct else registry.through_ops():
                    fn()
                    turns[direct].append(_host_us(fn))
            out[name] = {"direct_us": min(turns[True]), "op_us": min(turns[False]),
                         "op_minus_direct_us": min(turns[False]) - min(turns[True])}
    return out


def phase_export(steps: int = 10, frames: int = 16, size: int = 256, requests: int = 2) -> dict:
    """The flagship's denoise step at a cut depth (EXPORT_LAYERS_PER_BLOCK
    layers a block in the UNets; the flagship's widths, heads and attention
    levels) exported with
    torch.export (emox_torch.infer.export) on the card (its parameters are an
    input of the program, so nothing is copied), in bf16 at 256^2, 16
    frames, batch 1, default switches: export, save and
    load seconds, the artifact's bytes, the graph's kernel ops against the
    eager call's launches, the loaded call's eps against the eager step's
    (within 1e-3 rel L2; whether the bits agree) and its launches by kernel
    (equal to the eager call's: K1 on flash_fwd_sm90 and the FF on ff_sm90,
    nothing else), and the ms of one call each. Then the ops' dispatch cost
    (op_dispatch_cost) and the 256^2 request with every kernel call through
    its op against the direct route (direct, op, op, direct; `requests`
    each). Then the float32 small preset (128^2, 2 frames) exported under
    EMOX_LN_QKV=1 EMOX_GROUPNORM_IMPL=pallas on the card and run as exported
    (not saved: save and load take ~40 s of host time a graph), against the
    CPU's eager step (within 3e-4), K7 and K8a launched."""
    import torch
    from emox_torch.core.presets import small_config
    from emox_torch.infer.export import (export_denoise_step, export_switches, kernel_nodes, load_exported,
                                         save_exported, step_inputs)
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, registry, reset_launch_counts

    import dataclasses

    cfg = model_config("flagship", size, frames)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, layers_per_block=EXPORT_LAYERS_PER_BLOCK))
    model = EMOModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    res = {"phase": "export", "config": f"flagship {size}^2 at {EXPORT_LAYERS_PER_BLOCK} layer(s) per block, {frames} frames, "
                                        "batch 1, bf16, default switches"}
    t0 = time.perf_counter()
    exported = export_denoise_step(model, num_frames=frames, image_size=size, dtype=torch.bfloat16)
    res["export_s"] = time.perf_counter() - t0
    res["switches"] = export_switches()
    res["kernel_ops"] = kernel_nodes(exported)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step.pt2")
        t0 = time.perf_counter()
        save_exported(exported, path)
        res["save_s"] = time.perf_counter() - t0
        res["bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_exported(path)
        res["load_s"] = time.perf_counter() - t0
    del exported
    params = dict(model.modules.named_parameters())
    args = step_inputs(model, frames, size, 1, torch.bfloat16, torch.Generator(device="cuda").manual_seed(21))
    eager = lambda: model.predict_noise(args[0], args[1], args[2], audio_windows=args[3], speeds=args[4],
                                        face_mask=args[5])
    call = lambda: loaded(params, *args)
    with torch.no_grad():
        eager(), call()
        counts, eps = {}, {}
        for name, fn in (("eager", eager), ("loaded", call)):
            reset_launch_counts()
            eps[name] = fn()
            torch.cuda.synchronize()
            counts[name] = {k: v for k, v in launch_counts().items() if v}
            res[f"{name}_eps_finite"] = bool(torch.isfinite(eps[name].float()).all())
        loaded_counts = launch_counts()
        res["eps_rel_l2"] = _rel_l2(eps["loaded"], eps["eager"])
        res["same_bits"] = bool(torch.equal(eps["loaded"], eps["eager"]))
        res["eager_ms"] = time_ms(eager, iters=3, warmup=1)
        res["loaded_ms"] = time_ms(call, iters=3, warmup=1)
    del eps
    res["launches"] = counts
    res["tol"] = 1e-3
    want_kernels = {"flash_attn_nlc_fwd", "flash_fwd_sm90", "ln_geglu_ff", "ff_sm90"}
    sites = {k: counts["eager"].get(k, 0) for k in ("flash_attn_nlc_fwd", "ln_geglu_ff")}
    res["op_dispatch_us"] = op_dispatch_cost()

    # the 256^2 request: every kernel call through its op, against the direct route
    pipe = EMOPipeline(model)
    gen = torch.Generator(device="cuda").manual_seed(41)
    img, wav, speeds, mask = _request_inputs(gen, "cuda", size, frames, torch.bfloat16)
    turns = {True: [], False: []}
    for direct in (True, False, False, True) * (requests // 2):
        with contextlib.nullcontext() if direct else registry.through_ops():
            t0 = time.perf_counter()
            video = pipe(img, wav, video_length=frames, num_inference_steps=steps, guidance_scale=7.5, speeds=speeds,
                         face_mask=mask, generator=torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            turns[direct].append(time.perf_counter() - t0)
        if not bool(torch.isfinite(video.float()).all()):
            raise AssertionError("export: a request through the ops gave non-finite frames")
    res["serve_s_direct"], res["serve_s_op"] = turns[True], turns[False]
    del pipe, video

    # the float32 small preset under the fused-norm switches, card against CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = small_config(image_size=128, num_frames=2)
    cpu = EMOModel(small, dtype=torch.float32, device="cpu", seed=5)
    _fill_zero_init(cpu, seed=6)
    gpu = EMOModel(small, dtype=torch.float32, device="cuda", seed=0)
    gpu.modules.load_state_dict(cpu.modules.state_dict())
    sargs = step_inputs(cpu, 2, 128, 1, torch.float32, torch.Generator().manual_seed(22))
    with switches(NORMS), torch.no_grad():
        t0 = time.perf_counter()
        exported = export_denoise_step(gpu, num_frames=2, image_size=128, dtype=torch.float32)
        f32 = {"export_s": time.perf_counter() - t0, "switches": export_switches(),
               "kernel_ops": kernel_nodes(exported)}
        fn = exported.module()  # the flagship's export above went through save and load
        want = cpu.predict_noise(sargs[0], sargs[1], sargs[2], audio_windows=sargs[3], speeds=sargs[4],
                                 face_mask=sargs[5])
        reset_launch_counts()
        got = fn(dict(gpu.modules.named_parameters()), *(a.to("cuda") for a in sargs))
        torch.cuda.synchronize()
        f32["launches"] = {k: v for k, v in launch_counts().items() if v}
    torch.backends.cudnn.allow_tf32 = True
    f32["eps_rel_l2"], f32["tol"] = _rel_l2(got, want), 3e-4
    res["small_f32_norms"] = f32
    emit(res)
    if not (res["eager_eps_finite"] and res["loaded_eps_finite"] and res["eps_rel_l2"] <= res["tol"]):
        raise AssertionError(f"export: the loaded step's eps is {res['eps_rel_l2']} from the eager step's")
    if counts["loaded"] != counts["eager"] or set(counts["eager"]) != want_kernels:
        raise AssertionError(f"export: launches {counts}, expected the eager call's on {sorted(want_kernels)}")
    if {k: res["kernel_ops"].get(k, 0) for k in sites} != sites or set(res["kernel_ops"]) != set(sites):
        raise AssertionError(f"export: graph ops {res['kernel_ops']} against the eager call's sites {sites}")
    l = f32["launches"]
    if not (f32["eps_rel_l2"] <= f32["tol"] and l.get("ln_qkv", 0) > 0 and l.get("ln_qkv_f32_sm90", 0) > 0
            and l.get("group_norm", 0) > 0 and {"ln_qkv", "group_norm"} <= set(f32["kernel_ops"])):
        raise AssertionError(f"export: the float32 small step under {NORMS}: {f32}")
    del cpu, gpu, fn, loaded, model
    torch.cuda.empty_cache()
    return dict(res, launches_loaded=loaded_counts)


def _write_safetensors(path: str, tensors: dict) -> None:
    """A float16 .safetensors file: header length (u64 LE), JSON header,
    the tensors' bytes (a writer here: the port reads the format with no
    package, and writes none)."""
    import torch

    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = t.detach().to("cpu", torch.float16).contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": "F16", "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for b in blobs:
            f.write(b)


def _torch_ref():
    """tests/torch_ref.py of this checkout (diffusers' naming and compute in
    plain torch), loaded by path: a machine may have another `tests`
    package installed."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_ref.py")
    spec = importlib.util.spec_from_file_location("emox_torch_ref", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_import_weights(tmp: str, model, size: int = 256) -> dict:
    """`python -m emox_torch import-weights` for flagship-sd15 on
    diffusers-named state dicts at SD-1.5 widths, drawn on the card from
    seeds by tests/torch_ref.py's TMiniVAE (the SD VAE's layout, written as
    a float16 .safetensors) and TMiniUNet (320/640/1280/1280, 2 layers, 32
    groups, 8 heads, cross 768, attention at levels 0-2; a .pt of float16
    tensors); both hold their float16-rounded weights. Then, in float32 on
    the card (TF32 off): the imported port VAE's decode against
    TMiniVAE.decode and the imported port UNet's spatial path (the 2-D
    configuration, as the reference's ReferenceNet) against TMiniUNet, each
    within 3e-4 rel L2; then the import merged into `model` (serve_sd15's
    bf16 model: writer, reader and VAE) and one CFG-batched denoise step,
    finite. Unused source keys 0; every parameter left at init
    video-only."""
    import dataclasses

    import torch
    from emox_torch.core.config import save_config
    from emox_torch.data.tokenizer import CLIPTokenizer
    from emox_torch.interop.torch_import import merge_imported
    from emox_torch.models.unet import UNet
    from emox_torch.models.vae import AutoencoderKL

    torch_ref = _torch_ref()
    TMiniUNet, TMiniVAE = torch_ref.TMiniUNet, torch_ref.TMiniVAE
    cfg = model_config("flagship-sd15", size, 16)
    m, v = cfg.model, cfg.vae
    res = {"phase": "import_weights", "config": "flagship-sd15: SD-1.5's UNet and VAE layouts, float16 sources"}
    t0 = time.perf_counter()
    torch.manual_seed(51)
    with torch.device("cuda"):
        tvae = TMiniVAE(chans=tuple(v.base_channels * c for c in v.channel_multipliers), num_res=v.num_res_blocks,
                        groups=v.norm_groups, latent=4).eval()
        tunet = TMiniUNet(chans=tuple(m.block_channels), layers=m.layers_per_block, groups=m.norm_groups,
                          heads=m.attention_heads, cross_dim=m.cross_attention_dim,
                          attn_levels=m.attention_levels).eval()
    with torch.no_grad():
        for p in (*tvae.parameters(), *tunet.parameters()):
            p.copy_(p.half().float())
    vae_path, unet_path = os.path.join(tmp, "vae.safetensors"), os.path.join(tmp, "unet.pt")
    _write_safetensors(vae_path, tvae.state_dict())
    torch.save({k: t.to("cpu", torch.float16) for k, t in tunet.state_dict().items()}, unet_path)
    cfg_path = os.path.join(tmp, "sd15.yaml")
    save_config(cfg, cfg_path)
    res["sources_s"] = time.perf_counter() - t0
    res["source_keys"] = {"vae": len(tvae.state_dict()), "unet": len(tunet.state_dict())}
    secs, lines = _cli(["import-weights", "--config", cfg_path, "--vae", vae_path, "--unet", unet_path,
                        "--out", os.path.join(tmp, "imported")])
    res["cli_s"] = secs
    res["components"] = {}
    for line in lines:
        if line.startswith("{"):
            info = json.loads(line)
            res["components"][info.pop("component")] = info
    imported = {k: torch.load(os.path.join(tmp, "imported", f"{k}.pt"), weights_only=True) for k in ("vae", "unet")}

    # float32 on the card against the torch reference models, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(52)
    lat = size // v.downscale
    z = torch.randn((1, lat, lat, 4), generator=gen, device="cuda")
    x = torch.randn((1, lat, lat, 4), generator=gen, device="cuda")
    ctx = torch.randn((1, 77, m.cross_attention_dim), generator=gen, device="cuda")
    t = torch.tensor([500], device="cuda")
    with torch.device("cuda"):
        pvae = AutoencoderKL(v)
        punet = UNet(dataclasses.replace(m, use_temporal=False, use_audio=False, use_speed=False, use_face_mask=False,
                                         use_reference=False))
    merge_imported(pvae, imported["vae"]).eval()
    merge_imported(punet, imported["unet"]).eval()
    # torch_ref's timestep embedding makes its frequencies on the default device
    with torch.no_grad(), torch.device("cuda"):
        res["vae_decode_rel_l2"] = _rel_l2(pvae.decode(z), tvae.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        res["unet_rel_l2"] = _rel_l2(punet(x, t, context=ctx).sample,
                                     tunet(x.permute(0, 3, 1, 2), t, ctx).permute(0, 2, 3, 1))
    torch.backends.cudnn.allow_tf32 = True
    res["tol"] = 3e-4
    del pvae, punet, tvae, tunet
    torch.cuda.empty_cache()

    # into serve_sd15's model: the writer and the reader take the UNet, the VAE its own
    t0 = time.perf_counter()
    for part, key in (("vae", "vae"), ("reference_net", "unet"), ("denoiser", "unet")):
        merge_imported(getattr(model.modules, part), imported[key])
    video_only = ("_temporal", "_audio", "speed_embed", "face_mask_encoder", "null_context")
    kept = sorted(set(model.modules.denoiser.state_dict()) - set(imported["unet"]))
    res["kept_at_init"] = len(kept)
    res["kept_not_video_only"] = [k for k in kept if not any(s in k for s in video_only)]
    res["merge_s"] = time.perf_counter() - t0
    ids = torch.from_numpy(CLIPTokenizer().encode([PROMPT, ""], max_length=cfg.clip.max_positions)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(53)
    img, wav, speeds, mask = _request_inputs(gen, "cuda", size, 2, torch.bfloat16)
    with torch.no_grad():
        ref = model.encode_images(img)
        audio = model.encode_audio(wav, 2)
        face = model.encode_face_mask(mask, lat)
        context = model.encode_text(ids).flip(0)
        noisy = torch.randn((1, 2, lat, lat, 4), generator=gen, device="cuda").to(torch.bfloat16)
        cat = lambda a: torch.cat([a, a])
        eps = model.predict_noise(cat(noisy), torch.tensor([500, 500], device="cuda"), cat(ref),
                                  audio_windows=torch.cat([torch.zeros_like(audio), audio]), speeds=cat(speeds),
                                  face_feat=cat(face), context=context,
                                  ref_dropout=torch.tensor([True, False], device="cuda"))
    res["step_finite"] = bool(torch.isfinite(eps.float()).all())
    res["step_eps_abs_mean"] = eps.float().abs().mean().item()
    emit(res)
    unused = {k: c["unused_source_keys"] for k, c in res["components"].items() if c["unused_source_keys"]}
    missing = {k: c["missing_in_source"] for k, c in res["components"].items() if c["missing_in_source"]}
    if set(res["components"]) != {"vae", "unet"} or unused or missing or res["kept_not_video_only"]:
        raise AssertionError(f"import_weights: unused {unused}, missing {missing}, "
                             f"kept at init and not video-only {res['kept_not_video_only'][:8]}")
    if not (res["vae_decode_rel_l2"] <= res["tol"] and res["unet_rel_l2"] <= res["tol"] and res["step_finite"]):
        raise AssertionError(f"import_weights: VAE {res['vae_decode_rel_l2']}, UNet {res['unet_rel_l2']}, "
                             f"step finite {res['step_finite']}")
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


def phase_step_long(shared=None):
    """One windowed CFG-batched denoise step of the flagship at 256^2 (T 6,
    context 4, overlap 1: 2 windows, wrapping around the clip, folded into
    one call), float32, on the card (kernels) against the same weights on
    the CPU (plain versions), TF32 off: the per-frame average of the
    windows' eps at t 500. shared: the CPU model to reuse (cpu_model)."""
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
    cpu = cpu_model(cfg, shared)
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


def _profile_summary(events, labels) -> dict:
    """Device time by kernel group and name, the device's busy share of the
    span, and the device time under each CPU range named in `labels`, from
    the profiler's raw (kineto) events: start_ns, end_ns, name, device_type,
    is_user_annotation and correlation_id (a device kernel shares it with the
    runtime call that launched it). Reading these takes
    a second for the ~300 k events of a request; building torch.profiler's
    FunctionEvent tree from them takes ~25 s."""
    from torch.autograd import DeviceType

    events = [e for e in events if not e.is_hidden_event()]
    # device events, without the ranges that user annotations (such as the
    # optimizer's step) open on the device timeline over real kernels
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if not kernels:
        return {}
    span = max(e.end_ns() for e in events) - min(e.start_ns() for e in events)
    busy, last_end = 0, None
    for e in sorted(kernels, key=lambda e: e.start_ns()):
        start, end = e.start_ns(), e.end_ns()
        if last_end is None or start >= last_end:
            busy += end - start
            last_end = end
        elif end > last_end:
            busy += end - last_end
            last_end = end
    groups, by_name, by_corr = {}, {}, {}
    for e in kernels:
        ns, name = e.end_ns() - e.start_ns(), e.name()
        low = name.lower()
        group = next((g for g, keys in _GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0) + ns
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + ns)
        by_corr[e.correlation_id()] = by_corr.get(e.correlation_id(), 0) + ns
    # a range's device time: the kernels launched by the runtime calls that
    # start inside it (one thread launches every kernel of the run)
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    launches = [e for e in cpu if e.correlation_id() in by_corr]
    ranges_ns = dict.fromkeys(labels, 0)
    for label in labels:
        spans = sorted((e.start_ns(), e.end_ns()) for e in cpu if e.name() == label)
        starts = [a for a, _ in spans]
        for e in launches:
            i = bisect.bisect_right(starts, e.start_ns()) - 1
            if i >= 0 and e.start_ns() < spans[i][1]:
                ranges_ns[label] += by_corr[e.correlation_id()]
    return {"span_ms": span / 1e6, "kernel_ms": sum(groups.values()) / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / span, "kernel_launches": len(kernels),
            "groups_ms": {g: t / 1e6 for g, t in sorted(groups.items(), key=lambda kv: -kv[1])},
            "norm_ranges_ms": {k.split(".")[-1]: v / 1e6 for k, v in ranges_ns.items()},
            "by_name": sorted(((n, c, t / 1e6) for n, (c, t) in by_name.items()), key=lambda r: -r[2])}


def phase_profile(run, label: str, out_dir: str, filename: str) -> dict:
    """One more run (a request, a train step) under torch.profiler: device
    time per kernel group, the device's busy share of the run's span, the
    device time of the norm calls (the ranges of _NORM_RANGES), and the top
    kernels (all of them in out_dir/filename)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with _norm_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    summary = _profile_summary(prof.profiler.kineto_results.events(), [r[-1] for r in _NORM_RANGES])
    if not summary:
        res = {"phase": "profile", "device_time": "not measured (the profiler recorded no device events)"}
        emit(res)
        return res
    top = summary.pop("by_name")
    res = {"phase": "profile", "config": f"{label}, under torch.profiler", **summary,
           "top_kernels": [{"name": n[:120], "count": c, "ms": t} for n, c, t in top[:12]]}
    emit(res)
    if out_dir:
        with open(os.path.join(out_dir, filename), "w") as f:
            json.dump({n: {"count": c, "ms": t} for n, c, t in top}, f, indent=1)
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


# ---- the distributed runtime: two ranks on the one card ------------------------------------
DIST_RANKS = 2
DIST_DEADLINE_S = 600  # the two ranks' whole run; past it they are killed and the phase fails
DIST_TIMEOUT_S = 300  # a collective that waits longer fails its rank
DIST_FRAMES, DIST_LONG_FRAMES, DIST_STEPS = 8, 48, 10


@contextlib.contextmanager
def _float32_math():
    """TF32 off for matmuls and convolutions (a float32 comparison at
    float32 precision), the previous settings restored after."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _card(device: str):
    """(synchronize, reset the peak, read the peak in GB) on `device`: the
    card's, or no-ops where the phase is rehearsed on the CPU."""
    import torch

    if device != "cuda":
        return (lambda: None), (lambda: None), (lambda: 0.0)
    return (torch.cuda.synchronize, torch.cuda.reset_peak_memory_stats,
            lambda: torch.cuda.max_memory_allocated() / 1e9)


def _leaf_stats(tr, grads):
    """Per trainable leaf, the norm and the sum of its whole gradient (the
    sharded leaves' parts summed over `model`): what two steps' gradients
    are compared by without moving them between processes."""
    import torch
    from emox_torch.comm.runtime import all_reduce_

    norms = tr.state.optimizer.norms(grads).double().cpu()
    sums = torch.stack([g.double().sum() for g in grads])
    if tr.tp is not None:
        mask = torch.tensor([tr.tp.is_sharded(n) for n in tr.trainable_names()], device=sums.device)
        sums = torch.where(mask, all_reduce_(torch.where(mask, sums, torch.zeros_like(sums)), tr.tp.shard.group),
                           sums)
    return norms, sums.cpu()


def _dist_model(spec, cfg, mesh=None):
    """The phase's float32 model of `cfg` (seed 0, the zero-initialised
    branches filled) on the card, placed on `mesh` where one is given (rank
    0's weights broadcast, the tensor-parallel leaves sliced, the ring and
    the sparse-causal exchange over context), and the seconds the placement
    took. Every leg of a mesh trains on its one placed model."""
    import torch
    from emox_torch.models.emo import EMOModel

    sync, _, _ = _card(spec["device"])
    model = EMOModel(cfg, dtype=torch.float32, device=spec["device"], seed=0)
    _fill_zero_init(model, seed=8)
    t0 = time.perf_counter()
    model.distribute(mesh)
    sync()
    return model, time.perf_counter() - t0


def _update_gap(tr, deltas, path: str) -> float:
    """The relative L2 gap of this rank's optimizer update to the
    one-process update saved at `path`, over every trainable leaf, each
    compared on this rank's slice (its squares summed over `model` where
    the leaf is sharded, a replicated leaf counted once)."""
    import torch

    single = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    want = [tr._local(n, s).to(d.device) for n, s, d in zip(tr.trainable_names(), single, deltas)]
    norms = tr.state.optimizer.norms
    gap = torch.linalg.vector_norm(norms([d - w for d, w in zip(deltas, want)]))
    return float(gap / torch.linalg.vector_norm(norms(want)))


def _dist_step(spec, model, cfg, batch, draws, mesh=None, env=None, update=None):
    """One float32 step of cfg's stage on `model` (placed on `mesh`; None:
    one process) through a Trainer, under the switches `env`: its loss,
    metrics, gradient norm, per-leaf statistics, the kernels' launches
    during the step, its seconds and peak memory. update: a path; the
    optimizer's update is then applied after the step, and one process
    saves it there, a rank holds its own to it (update_gap)."""
    import torch
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train import Trainer

    dev = spec["device"]
    sync, reset_peak, peak_gb = _card(dev)
    tr = Trainer(cfg, model=model, mesh=mesh)
    on_card = lambda d: {k: v.to(dev) for k, v in d.items()}
    batch, draws = on_card(batch), on_card(draws)
    with switches(env):
        sync()
        reset_peak()
        reset_launch_counts()
        t0 = time.perf_counter()
        with _float32_math():
            metrics, grads = tr.loss_and_grads(batch, draws)
            sync()
        secs = time.perf_counter() - t0
        counts = launch_counts()
    norms, sums = _leaf_stats(tr, grads)
    out = {"loss": metrics["loss"].double().item(), "grad_norm": metrics["grad_norm"].double().item(),
           "metrics": {k: v.double().item() for k, v in metrics.items()}, "norms": norms, "sums": sums,
           "launches": counts, "step_s": secs, "peak_gb": peak_gb(), "leaves": len(grads)}
    if update is not None:
        masters = list(tr.state.masters.values())
        before = [m.clone() for m in masters]
        out["applied"] = tr.state.optimizer.step(grads)
        deltas = [m - b for m, b in zip(masters, before)]
        del before
        out["update_norm"] = float(torch.linalg.vector_norm(tr.state.optimizer.norms(deltas)))
        if mesh is None:
            torch.save([d.cpu() for d in deltas], update)
        else:
            out["update_gap"] = _update_gap(tr, deltas, update)
        del deltas
    tr.close()
    del tr, grads, metrics
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _split_in_one_process(n: int):
    """windowed_model_out as n context ranks compute it, in one process: each
    rank's windows (rank::n, folded as that rank folds them) summed by
    windowed_sum, the n sums added in rank order, as the all-reduce adds
    them, then divided by the plan's counts."""
    from emox_torch.diffusion.sampler import windowed_sum

    def model_out(fn, latents, t, indices, weights, shard=(0, 1, None)):
        parts = [windowed_sum(fn, latents, t, indices, weights, r, n) for r in range(n)]
        total = parts[0][0]
        for noise_sum, _ in parts[1:]:
            total = total + noise_sum
        return total / parts[0][1].reshape(1, -1, *(1,) * (latents.dim() - 2))

    return model_out


def _dist_serve_model(spec, mesh=None):
    """The request's model in float32 (seed 0, the zero-initialised branches
    filled), its weights broadcast over `mesh`. The requests run widest type
    first and cast it down between them (_dist_serve_dtypes): its bf16 values
    are EMOModel(dtype=bfloat16)'s, whose init also draws float32 values and
    casts them."""
    import torch
    from emox_torch.core.mesh import shard_params_replicated
    from emox_torch.models.emo import EMOModel

    model = EMOModel(spec["serve_cfg"], dtype=torch.float32, device=spec["device"], seed=0)
    _fill_zero_init(model, seed=8)
    shard_params_replicated(list(model.modules.parameters()), mesh)
    return model


def _dist_serve_dtypes(spec):
    """The requests' (tag, type), widest type first."""
    return sorted(spec["serve_dtypes"].items(), key=lambda kv: kv[1].itemsize, reverse=True)


def _dist_request(spec, model, dtype, mesh=None, split: int = 1):
    """The 48-frame 256^2 request of the distributed phase through the
    windowed sampler on `model` (_dist_serve_model; cast to `dtype` where it
    is wider): its windows split over the mesh's context ranks, or (no mesh)
    in one process, with split > 1 grouped as that many ranks group them
    (_split_in_one_process). The latents, seconds and peak memory."""
    import torch
    from emox_torch.infer import pipeline

    cfg, dev = spec["serve_cfg"], spec["device"]
    sync, reset_peak, peak_gb = _card(dev)
    if model.dtype != dtype:
        model.modules.to(dtype=dtype)
        model.dtype = dtype
    pipe = pipeline.EMOPipeline(model, mesh=mesh)
    img, wav, speeds, mask = (t.to(dev, dtype) for t in spec["request"])
    combine = pipeline.windowed_model_out
    if split > 1:
        pipeline.windowed_model_out = _split_in_one_process(split)
    try:
        math_ = _float32_math() if dtype == torch.float32 else contextlib.nullcontext()
        sync()
        reset_peak()
        t0 = time.perf_counter()
        with math_:
            lat = pipe.generate_latents(img, wav, video_length=cfg.inference.video_length,
                                        num_inference_steps=DIST_STEPS, guidance_scale=7.5, speeds=speeds,
                                        face_mask=mask, generator=torch.Generator(device=dev).manual_seed(31))
            sync()
    finally:
        pipeline.windowed_model_out = combine
    out = {"latents": lat.float().cpu(), "s": time.perf_counter() - t0, "peak_gb": peak_gb()}
    del pipe, lat
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def dist_rank(rank: int, directory: str) -> int:
    """One rank of the distributed phase (chip_smoke.py --rank R --dist-dir
    DIR): a gloo world of DIST_RANKS ranks on the one card, the legs in turn,
    each mesh's on one placed model; the results go to DIR/rank<R>.pt."""
    import torch
    import torch.distributed as dist
    from emox_torch.comm.runtime import initialize_distributed, transport
    from emox_torch.core.config import MeshConfig
    from emox_torch.core.mesh import create_mesh

    spec = torch.load(os.path.join(directory, "spec.pt"), weights_only=False)
    if spec["device"] == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
    initialize_distributed(f"file://{os.path.join(directory, 'store')}", DIST_RANKS, rank, backend="gloo",
                           timeout_s=DIST_TIMEOUT_S)
    out = {"backend": dist.get_backend(), "transport": transport(torch.zeros(1, device=spec["device"]))}
    mesh = lambda d, c, m: create_mesh(MeshConfig(data=d, context=c, model=m))
    with switches():
        # (a) the stage-2 step, (d) the same with sparse-causal attention and
        # (e) stage 1, whose one frame stays whole on both ranks, all at context 2
        cp = mesh(1, DIST_RANKS, 1)
        model, place_s = _dist_model(spec, spec["train_cfg"], cp)
        out["cp"] = dict(_dist_step(spec, model, spec["train_cfg"], spec["batch"], spec["draws"], cp), place_s=place_s)
        set_sparse_causal(model, True)
        out["sc"] = _dist_step(spec, model, spec["sc_cfg"], spec["batch"], spec["draws"], cp)
        set_sparse_causal(model, False)
        out["stage1"] = _dist_step(spec, model, spec["stage1_cfg"], spec["stage1_batch"], spec["stage1_draws"], cp)
        del model
        # (b, g) the stage-2 step at model 2, then its adafactor update
        tp = mesh(1, 1, DIST_RANKS)
        model, place_s = _dist_model(spec, spec["ada_cfg"], tp)
        out["tp"] = dict(_dist_step(spec, model, spec["ada_cfg"], spec["batch"], spec["draws"], tp,
                                    update=spec["update_path"]), place_s=place_s)
        del model
        # (f) stages 5 and 0 at data 2: the flagship's VAE, and the face nets
        dp = mesh(DIST_RANKS, 1, 1)
        model, place_s = _dist_model(spec, spec["stage5_cfg"], dp)
        out["stage5"] = dict(_dist_step(spec, model, spec["stage5_cfg"], spec["stage5_batch"], spec["stage5_draws"],
                                        dp, env=ATTN_PALLAS), place_s=place_s)
        out["stage0"] = _dist_step(spec, model, spec["stage0_cfg"], spec["stage0_batch"], {}, dp)
        del model
        if spec["device"] == "cuda":
            torch.cuda.empty_cache()
        # (c) the request with its windows over context
        model = _dist_serve_model(spec, cp)
        for tag, dtype in _dist_serve_dtypes(spec):
            out[f"windowed{tag}"] = _dist_request(spec, model, dtype, cp)
        del model
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _temporal_sites(cfg) -> int:
    """The denoiser's temporal attentions (each a ring site on a context mesh)."""
    levels = len(cfg.model.attention_levels)
    return levels * cfg.model.layers_per_block + 1 + levels * (cfg.model.layers_per_block + 1)


def _dist_spec(tmp: str) -> dict:
    """The distributed phase's inputs, drawn on the CPU from fixed seeds: the
    float32 stage-2 step's config, batch and draws (flagship 256^2, batch 1
    x 8 frames; with sparse-causal attention, and with adafactor), stage 1's
    (batch 2 x 1), stage 5's (the flagship's VAE, batch 2) and stage 0's
    (the face nets, batch 8, a landmarks_valid mask that differs between
    the data ranks' rows), and the bf16 48-frame request's config and
    inputs. Stages 5 and 0 neither run nor train the UNets and the audio
    encoder: their model has them at the tiny preset's widths, so that
    placing it moves the VAE and the face nets only."""
    import dataclasses

    import torch
    from emox_torch.core.presets import tiny_config
    from emox_torch.diffusion.schedule import make_schedule
    from emox_torch.train import sample_draws

    gen = torch.Generator(device="cpu").manual_seed(41)
    train_cfg = _train_config(2, batch=1, frames=DIST_FRAMES, dtype="float32", checkpoint_dir=tmp)
    batch = _train_batch(gen, 2, 1, DIST_FRAMES, train_cfg, "cpu")
    draws = sample_draws(train_cfg, make_schedule(train_cfg.diffusion), 2, batch, gen)
    request = _request_inputs(torch.Generator(device="cpu").manual_seed(42), "cpu", 256, DIST_LONG_FRAMES,
                              torch.bfloat16)
    stage1_cfg = _train_config(1, batch=2, frames=1, dtype="float32", checkpoint_dir=tmp)
    stage1_batch = _train_batch(gen, 1, 2, 1, stage1_cfg, "cpu")
    tiny = tiny_config(256, 1)
    vae_cfg = lambda stage, b: _train_config(stage, batch=b, frames=1, dtype="float32", checkpoint_dir=tmp).replace(
        model=tiny.model, audio=tiny.audio)
    stage5_cfg, stage0_cfg = vae_cfg(5, 2), vae_cfg(0, 8)
    stage5_batch = _train_batch(gen, 5, 2, 1, stage5_cfg, "cpu")
    stage0_batch = dict(_train_batch(gen, 0, 8, 1, stage0_cfg, "cpu"),
                        landmarks_valid=torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0]))
    return {"train_cfg": train_cfg, "batch": batch, "draws": draws, "request": request,
            "sc_cfg": _train_config(2, batch=1, frames=DIST_FRAMES, dtype="float32", checkpoint_dir=tmp,
                                    name="flagship-sc"),
            "ada_cfg": train_cfg.replace(train=dataclasses.replace(train_cfg.train, optimizer="adafactor")),
            "update_path": os.path.join(tmp, "update_single.pt"),
            "stage1_cfg": stage1_cfg, "stage1_batch": stage1_batch,
            "stage1_draws": sample_draws(stage1_cfg, make_schedule(stage1_cfg.diffusion), 1, stage1_batch, gen),
            "stage5_cfg": stage5_cfg, "stage5_batch": stage5_batch,
            "stage5_draws": sample_draws(stage5_cfg, make_schedule(stage5_cfg.diffusion), 5, stage5_batch, gen),
            "stage0_cfg": stage0_cfg, "stage0_batch": stage0_batch,
            "serve_cfg": model_config("flagship", 256, DIST_LONG_FRAMES),
            "serve_dtypes": {"": torch.bfloat16, "_f32": torch.float32},
            "device": "cuda"}


def phase_distributed(out_dir: str, make_spec=_dist_spec):
    """The distributed runtime on the one card: first the single-process legs
    here (float32 steps at flagship widths: stage 2, batch 1 x 8 frames,
    with and without sparse-causal attention, and its adafactor update;
    stage 1, batch 2 x 1; the flagship's VAE in stage 5, batch 2, and the
    face nets in stage 0, batch 8; the bf16 48-frame request through the
    windowed sampler), their memory freed, then one spawn of two ranks in a
    gloo world (pinned-host transport: gloo moves no CUDA tensor) that run
      (a) the stage-2 step at data 1 x context 2 x model 1 (the ring: K1 and
          K4 at each rotation of each temporal site, counted per rank),
      (d) on the same placed model, the step with sparse-causal attention
          (each rank's first and previous frames from the other; K1 at each
          level-0 site with the reference's tokens and without, and the
          ring's),
      (e) on it, stage 1: its one frame whole on both ranks, no ring launch,
      (b) the stage-2 step at data 1 x context 1 x model 2 (tensor
          parallelism: K6 on each rank's FF shard), and (g) its adafactor
          update, each rank's slices held to the one-process update,
      (f) at data 2, stage 5 (flash_fwd_d512_f32 and flash_bwd_d512_f32 at
          the VAE's mid-attention, under EMOX_ATTENTION_IMPL=pallas) and
          stage 0, each metric held to one process,
      (c) the same request with its windows over context 2,
    each held to the reference's bars (|dloss| < 1e-4, grad-norm relative
    error < 1e-3; each metric of (f) and the update of (g) within 1e-4
    relative; |dlat|max < 2e-3 x the latent scale; in bf16 against the
    windows grouped as the ranks group them, and within twice bf16's own
    error of the default request). A rank that fails or a world that
    outlives DIST_DEADLINE_S fails the phase."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spec = make_spec(tmp)
        train_cfg = spec["train_cfg"]
        with switches():
            t0 = time.perf_counter()
            # one model for the flagship's legs; the adafactor update, which
            # moves its weights, comes last
            model, _ = _dist_model(spec, train_cfg)
            set_sparse_causal(model, True)
            single = {"sc": _dist_step(spec, model, spec["sc_cfg"], spec["batch"], spec["draws"])}
            set_sparse_causal(model, False)
            single["stage1"] = _dist_step(spec, model, spec["stage1_cfg"], spec["stage1_batch"], spec["stage1_draws"])
            single["step"] = _dist_step(spec, model, spec["ada_cfg"], spec["batch"], spec["draws"],
                                        update=spec["update_path"])
            del model
            model, _ = _dist_model(spec, spec["stage5_cfg"])
            single["stage5"] = _dist_step(spec, model, spec["stage5_cfg"], spec["stage5_batch"], spec["stage5_draws"],
                                          env=ATTN_PALLAS)
            single["stage0"] = _dist_step(spec, model, spec["stage0_cfg"], spec["stage0_batch"], {})
            del model
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            model = _dist_serve_model(spec)
            for tag, dtype in _dist_serve_dtypes(spec):
                single[f"windowed{tag}"] = _dist_request(spec, model, dtype)
            # bf16 rounds each window's output by what shares its call: the
            # ranks' grouping in one process is what they must reproduce
            single["windowed_split"] = _dist_request(spec, model, spec["serve_dtypes"][""],
                                                     split=DIST_RANKS)
            del model
            single_s = time.perf_counter() - t0
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        procs = []
        for rank in range(DIST_RANKS):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(rank),
                                            "--dist-dir", tmp], stdout=log, stderr=subprocess.STDOUT), log))
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, DIST_DEADLINE_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                break
        hung = [p for p, _ in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for _, log in procs:
            log.close()
        world_s = time.perf_counter() - t0
        logs = {r: open(os.path.join(tmp, f"rank{r}.log")).read() for r in range(DIST_RANKS)}
        if out_dir:
            for r, text in logs.items():
                with open(os.path.join(out_dir, f"distributed_rank{r}.log"), "w") as f:
                    f.write(text)
        if hung or any(p.returncode != 0 for p, _ in procs):
            tails = "\n".join(f"--- rank {r} ---\n{text[-4000:]}" for r, text in logs.items())
            raise AssertionError(f"the distributed phase's world failed ({len(hung)} rank(s) killed after "
                                 f"{DIST_DEADLINE_S} s):\n{tails}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DIST_RANKS)]
    sites = _temporal_sites(train_cfg)
    results = {}
    legs = (("cp", "step", "flagship 256^2 stage 2, batch 1 x {f} frames, data 1 x context 2 x model 1", True),
            ("sc", "sc", "flagship-sc 256^2 stage 2 (sparse-causal self-attention), batch 1 x {f} frames, "
             "data 1 x context 2 x model 1 (the first and previous frames exchanged)", True),
            ("stage1", "stage1", "flagship 256^2 stage 1, batch 2 x 1 frame, data 1 x context 2 x model 1 (the "
             "frame whole on both ranks)", False),
            ("tp", "step", "flagship 256^2 stage 2, batch 1 x {f} frames, data 1 x context 1 x model 2, adafactor",
             False))
    for leg, one, what, ring in legs:
        want = single[one]
        base = want["launches"]
        per_rank = []
        for r, res in enumerate(ranks):
            got = res[leg]
            k1 = got["launches"]["flash_attn_nlc_fwd"] - base["flash_attn_nlc_fwd"]
            k4 = got["launches"]["flash_attn_nlc_bwd"] - base["flash_attn_nlc_bwd"]
            pr = {"rank": r, "dloss": abs(got["loss"] - want["loss"]),
                  "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
                  "worst_leaf_norm_rel": float(((got["norms"] - want["norms"]).abs()
                                                / want["norms"].clamp_min(1e-30)).max()),
                  "leaf_sums_rel_l2": float((got["sums"] - want["sums"]).norm() / want["sums"].norm()),
                  "ring_k1_launches": k1, "ring_k4_launches": k4, "k6_launches": got["launches"]["geglu_ff"],
                  "launches": got["launches"], "step_s": got["step_s"], "peak_gb": got["peak_gb"]}
            if "place_s" in got:
                pr["place_s"] = got["place_s"]
            if "update_gap" in got:
                pr.update(update_applied=got["applied"], update_rel_l2=got["update_gap"],
                          update_norm=got["update_norm"])
            per_rank.append(pr)
        # the ring's launches: a forward at each rotation of each temporal site,
        # again when remat recomputes it, a backward at each rotation
        rotations = DIST_RANKS if ring else 0
        expect = {"ring_k1_launches": sites * rotations * (2 if train_cfg.model.remat else 1),
                  "ring_k4_launches": sites * rotations}
        limits = {"dloss": 1e-4, "grad_norm_rel": 1e-3}
        if leg == "tp":
            limits["update_rel_l2"] = 1e-4
        res = {"phase": f"distributed_{leg}_step", "config": what.format(f=train_cfg.data.num_frames) + ", float32",
               "backend": ranks[0]["backend"], "transport": ranks[0]["transport"], "ranks_on_one_card": DIST_RANKS,
               "limits": limits, "ring_sites": sites, "expected": expect, "loss_single": want["loss"],
               "grad_norm_single": want["grad_norm"], "single_step_s": want["step_s"],
               "single_peak_gb": want["peak_gb"], "single_launches": base, "trainable_leaves": want["leaves"],
               "per_rank": per_rank, "nvidia_smi": smi_line()}
        if leg == "sc":
            res["bwd_per_step_expected"] = BWD_PER_STEP[("flagship-sc", 256)]
        if leg == "tp":
            res["update_single"] = {"applied": want["applied"], "norm": want["update_norm"]}
        emit(res)
        for pr in per_rank:
            if not (pr["dloss"] < limits["dloss"] and pr["grad_norm_rel"] < limits["grad_norm_rel"]):
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} off the single-process step: {pr}")
            if {k: pr[k] for k in expect} != expect:
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} ring launches {pr}, expected {expect}")
            if leg == "tp" and pr["k6_launches"] <= 0:
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} launched no K6: {pr['launches']}")
            if leg == "tp" and not (pr["update_applied"] and want["applied"]
                                    and pr["update_rel_l2"] < limits["update_rel_l2"]):
                raise AssertionError(f"{res['phase']}: rank {pr['rank']}'s adafactor update off one process's: {pr}")
        # the sparse-causal step's own sites: two forwards (with the reference's
        # tokens and without) at each level-0 site, their backwards
        if leg == "sc" and base["flash_attn_nlc_bwd"] != BWD_PER_STEP[("flagship-sc", 256)]:
            raise AssertionError(f"{res['phase']}: one process launched {base['flash_attn_nlc_bwd']} K4, expected "
                                 f"{BWD_PER_STEP[('flagship-sc', 256)]}")
        results[leg] = res
    # (f) stages 5 and 0 at data 2: each metric against one process
    for leg, what in (("stage5", "the flagship's VAE 256^2 stage 5, batch 2, EMOX_ATTENTION_IMPL=pallas"),
                      ("stage0", "the face nets 256^2 stage 0, batch 8, landmarks_valid differing between ranks")):
        want = single[leg]
        per_rank = []
        for r, res in enumerate(ranks):
            got = res[leg]
            rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in want["metrics"].items()}
            per_rank.append({"rank": r, "metrics_rel": rel, "worst_metric_rel": max(rel.values()),
                             "grad_norm_rel": rel["grad_norm"], "metrics": got["metrics"],
                             "leaf_sums_rel_l2": float((got["sums"] - want["sums"]).norm() / want["sums"].norm()),
                             "launches": got["launches"], "step_s": got["step_s"], "peak_gb": got["peak_gb"],
                             **({"place_s": got["place_s"]} if "place_s" in got else {})})
        limits = {"metric_rel": 1e-4, "grad_norm_rel": 1e-3}
        res = {"phase": f"distributed_{leg}_step", "config": f"{what}, float32, data 2 x context 1 x model 1 (the "
               "UNets and audio encoder, which the stage never runs, at tiny widths)",
               "backend": ranks[0]["backend"], "transport": ranks[0]["transport"], "limits": limits,
               "metrics_single": want["metrics"], "single_step_s": want["step_s"], "single_peak_gb": want["peak_gb"],
               "single_launches": want["launches"], "trainable_leaves": want["leaves"], "per_rank": per_rank,
               "nvidia_smi": smi_line()}
        emit(res)
        stage = 5 if leg == "stage5" else 0
        check_stage05_launches(stage, want["launches"], 1, res["phase"] + " (one process)", dtype="float32")
        for pr in per_rank:
            check_stage05_launches(stage, pr["launches"], 1, f"{res['phase']} rank {pr['rank']}", dtype="float32")
            off = {k: v for k, v in pr["metrics_rel"].items() if v >= (limits["grad_norm_rel"] if k == "grad_norm"
                                                                       else limits["metric_rel"])}
            if off:
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} off the single-process step: {off}")
        results[leg] = res
    # (c) the request: in bf16 against the ranks' grouping in one process (the
    # reference's bar), and against the default request within twice bf16's
    # own error (the bf16 default's gap to the float32 one, this run): a
    # larger gap would put one of the two bf16 results further from float32
    # than bf16 itself is. bf16 rounds a window's cuDNN convolutions and K2/K3
    # by what shares its call (chip_probe_windows.py). Float32 against the
    # default request at the reference's bar.
    f32 = single["windowed_f32"]["latents"]
    bf16_floor = float((single["windowed"]["latents"] - f32).abs().max())
    for tag, dtype in spec["serve_dtypes"].items():
        want = single["windowed_split" if tag == "" else f"windowed{tag}"]["latents"]
        default = single[f"windowed{tag}"]["latents"]
        scale = float(want.abs().max())
        per_rank = [{"rank": r, "dlat_max": float((res[f"windowed{tag}"]["latents"] - want).abs().max()),
                     "dlat_max_to_default": float((res[f"windowed{tag}"]["latents"] - default).abs().max()),
                     "dlat_max_to_f32": float((res[f"windowed{tag}"]["latents"] - f32).abs().max()),
                     "s_per_request": res[f"windowed{tag}"]["s"], "peak_gb": res[f"windowed{tag}"]["peak_gb"],
                     "finite": bool(torch.isfinite(res[f"windowed{tag}"]["latents"]).all())}
                    for r, res in enumerate(ranks)]
        res = {"phase": f"distributed_windowed{tag}",
               "config": f"flagship 256^2 {str(dtype).split('.')[-1]}, {spec['serve_cfg'].inference.video_length} "
                         f"frames, {DIST_STEPS} DDIM steps, CFG 7.5, windows over context {DIST_RANKS}",
               "held_against": ("one process, the windows grouped as the ranks group them" if tag == ""
                                else "one process, the default request"),
               "backend": ranks[0]["backend"], "transport": ranks[0]["transport"], "latent_scale": scale,
               "limit": 2e-3 * scale, "single_s_per_request": single[f"windowed{tag}"]["s"],
               "single_peak_gb": single[f"windowed{tag}"]["peak_gb"], "per_rank": per_rank,
               "single_legs_s": single_s, "world_s": world_s, "nvidia_smi": smi_line()}
        if tag == "":
            res["split_in_one_process_to_default"] = float((want - default).abs().max())
            res["split_in_one_process_s"] = single["windowed_split"]["s"]
            res["bf16_to_f32"] = bf16_floor
            res["limit_to_default"] = 2 * bf16_floor
        emit(res)
        for pr in per_rank:
            if not (pr["finite"] and pr["dlat_max"] < 2e-3 * scale):
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} off the single-process request: {pr}")
            if tag == "" and not pr["dlat_max_to_default"] <= 2 * bf16_floor:
                raise AssertionError(f"{res['phase']}: rank {pr['rank']} further from the default bf16 request than "
                                     f"twice bf16's own error {bf16_floor}: {pr}")
        results[f"windowed{tag}"] = res
    results["launches"] = {f"distributed_{leg}_rank{pr['rank']}": pr["launches"]
                           for leg in ("cp", "sc", "stage1", "tp", "stage5", "stage0")
                           for pr in results[leg]["per_rank"]}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="directory for long reports (ptxas output)")
    # one rank of the distributed phase's world, which phase_distributed spawns
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.rank is not None:  # on the device its parent's spec names
        return dist_rank(args.rank, args.dist_dir)
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
        # the float32 step on one pair of models: plain, under the fused-norm
        # switches (each run sets its own), and with sparse-causal attention
        # the flagship's float32 CPU model, shared by every flagship
        # card-against-CPU phase (the step, the windowed step, the train steps)
        flagship_cpu = cpu_model(model_config("flagship", 256, 2))
        steps = phase_step(runs=(("", None), ("_norms", NORMS), ("_norms", NORMS_FAST),
                                 ("_sparse_causal", None, "sparse_causal")), shared=flagship_cpu)
        step, step_norms, step_sc = (steps[i]["launches"] for i in (0, 1, 3))
        launches = phase_serve(args.out)["launches"]
        # the flagship's denoise step at a cut depth through torch.export, the
        # ops' dispatch cost and the request through the ops; the float32
        # small preset's export under the fused-norm switches
        export = phase_export()
        # the attention switch: a kernel at every site (and against the plain
        # step), then the serving request with plain attention at every site
        step_pallas = phase_step_attn_pallas()["launches"]
        serve_attn_xla = phase_serve(args.out, requests=2, env=ATTN_XLA)["launches"]
        # clips longer than one context window, generate_long, invert, and the
        # two-call CFG program, interpolation and AdaIN
        step_long = phase_step_long(shared=flagship_cpu)["launches"]
        long = phase_long(args.out)
        with tempfile.TemporaryDirectory() as tmp:
            train_step = phase_train_step(tmp, shared=flagship_cpu)["launches"]
            train2 = phase_train(tmp, stage=2, batch=2, frames=8, warmup=2, steps=5, out_dir=args.out)
            train1 = phase_train(tmp, stage=1, batch=4, frames=1, warmup=1, steps=2, out_dir=args.out)
            train3 = phase_train(tmp, stage=3, batch=2, frames=8, warmup=1, steps=2, out_dir=args.out)
        # the SD-1.5 head layout: its level-0 sites run the strided kernels (K5)
        phase_step("flagship-sd15")
        served = {}
        serve_sd15 = phase_serve(args.out, name="flagship-sd15", prompt=PROMPT, keep=served)["launches"]
        # diffusers-named SD-1.5 weights through import-weights, into that model
        with tempfile.TemporaryDirectory() as tmp:
            phase_import_weights(tmp, served.pop("model"))
        with tempfile.TemporaryDirectory() as tmp:
            train_sd15 = phase_train(tmp, stage=2, batch=2, frames=8, warmup=2, steps=5, out_dir=args.out,
                                     name="flagship-sd15")
        # sparse-causal self-attention: two K1 launches at each level-0 site of
        # the reader (Lk 3072 with the reference, 2048 without), K4 likewise
        serve_sc = phase_serve(args.out, requests=2, name="flagship-sc")["launches"]
        with tempfile.TemporaryDirectory() as tmp:
            train_sc = phase_train(tmp, stage=2, batch=2, frames=8, warmup=1, steps=3, out_dir=args.out,
                                   name="flagship-sc")
        # separable ResBlock convs (the ControlNet's in step_separable, below)
        serve_sep = phase_serve(args.out, requests=2, name="flagship-sep")["launches"]
    # the flagship under the reference's fused-norm switches: GroupNorm K8a (or
    # K8b) and the fused LN + q/k/v (K7); each phase sets its switches itself
    serve_norms = phase_serve(args.out, env=NORMS)["launches"]
    serve_fast = phase_serve(args.out, requests=1, env=NORMS_FAST, profile=False)["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_step(tmp, env=NORMS, shared=flagship_cpu)
        del flagship_cpu
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
        # adafactor with fp32 frozen leaves, stage 1 at 512^2, and its checkpoint
        with tempfile.TemporaryDirectory() as tmp:
            train_adafactor = phase_train_adafactor(tmp)
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
        # the command line: precompute, pack-records, train, infer, train-face;
        # then train --stage 4 and infer --identity on the same records
        with tempfile.TemporaryDirectory() as tmp:
            cli = phase_cli(tmp)
            cli_control = phase_cli_control(tmp)
        # the side models: the float32 step and stage-4 step against the CPU,
        # serving with control renders and the identity embedding at 256^2 and
        # 512^2 (the ControlNet's level-0 sites on K1), stage 4 at 512^2
        with tempfile.TemporaryDirectory() as tmp:
            step_control = phase_step_control(tmp)
            step_sep = phase_step_control(tmp, separable=True)
            control = phase_control()
            train_control = phase_train(tmp, stage=4, batch=1, frames=8, warmup=1, steps=2, out_dir=args.out,
                                        name="flagship-control", size=512, phase="train_control_512")
        # the distributed runtime: two ranks on the card (gloo), the ring (K1 and
        # K4 at the ring's block shape), sparse-causal attention and stage 1
        # over context, tensor parallelism (K6 on F / 2) with an adafactor
        # update, stages 5 and 0 over data, and the windowed sampler over
        # context, each against one process
        distributed = phase_distributed(args.out)
    by_path = {"step": step, "serve": launches, "export": export["launches_loaded"], "step_long": step_long,
               **long["launches_by_path"], "step_attn_pallas": step_pallas, "serve_attn_xla": serve_attn_xla,
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
               "face_nets": face["launches"], "train_stage0_per_step": train0["launches_per_step"],
               "cli": cli["launches"], "cli_control_train": cli_control["launches_train"],
               "cli_control_infer": cli_control["launches_infer"], "step_control": step_control["launches_step"],
               "step_control_train": step_control["launches_train"],
               **{f"control_{size}{'' if key == 'side' else '_plain'}": control[str(size)][key]["launches"]
                  for size in (256, 512) for key in ("side", "plain")},
               "train_control_512_per_step": train_control["launches_per_step"],
               "step_sparse_causal": step_sc, "serve_sparse_causal": serve_sc,
               "train_sparse_causal_stage2_per_step": train_sc["launches_per_step"], "serve_separable": serve_sep,
               "step_separable": step_sep["launches_step"], "step_separable_train": step_sep["launches_train"],
               "train_adafactor_512_per_step": train_adafactor["launches_per_step"], **distributed["launches"]}
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
                                  kern["flash_512_control"], kern["flash_sc"],
                                  kern["flash_strided_n32"], kern["flash_strided_n16"], kern["flash_d512"],
                                  kern["flash_strided_n32_d64"], kern["ring_l0"], kern["ring_l1"]]),
        entry("emox_torch/csrc/flash_fwd_d512_f32.cu", ["emox/ops/attention.py:409"], kern["flash_d512_f32"],
              [kern["flash_d512_f32_n16"], kern["flash_d512_f32_1024"]]),
        # float32 on the same source's kernels, on a two-part bf16 split; its
        # main row at the float32 step's packed site, whose launches it counts
        entry("emox_torch/csrc/flash_fwd_sm90.cu", ["emox/ops/attention.py:409", "emox/ops/attention.py:69"],
              kern["flash_f32_packed"], [kern["flash_f32_n32"], kern["flash_f32_n32_d64"], kern["ring_l0_f32"],
                                         kern["ring_l1_f32"], kern["flash_sc_cp_f32_3072"],
                                         kern["flash_sc_cp_f32_2048"]]),
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
                              kern["geglu_ff_l2"], kern["geglu_ff_tp"]]),
        # float32 on the same source's kernels, on a two-part bf16 split: with
        # LN (K2/K3) at the float32 step's level 0, whose launches it counts,
        # and without (K6) in by_shape
        entry("emox_torch/csrc/ff_sm90.cu", ["emox/ops/ff.py:102", "emox/ops/ff.py:120", "emox/ops/ff.py:455"],
              kern["ff_f32"], [kern["geglu_ff_f32"], kern["geglu_ff_tp_f32"]]),
        # one kernel pair for both layouts' bf16 backward (head dim <= 128):
        # the packed sites are K4's, the strided (head-split) one K5's
        entry("emox_torch/csrc/flash_bwd_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                    "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_n16"], [kern["flash_bwd_n4"], kern["flash_bwd_512_l0"], kern["flash_bwd_512_l1"],
                                      kern["flash_bwd_512_control"], kern["flash_bwd_sc"],
                                      kern["flash_strided_bwd_n16"], kern["ring_bwd_l0"], kern["ring_bwd_l1"]]),
        # float32 at head dim <= 128 on the same source's pair, on a two-part split
        entry("emox_torch/csrc/flash_bwd_sm90.cu", ["emox/ops/attention.py:465", "emox/ops/attention.py:508",
                                                    "emox/ops/attention.py:118", "emox/ops/attention.py:160"],
              kern["flash_bwd_f32"], [kern["ring_bwd_l0_f32"], kern["ring_bwd_l1_f32"], kern["flash_bwd_sc_cp_f32_3072"],
                                      kern["flash_bwd_sc_cp_f32_2048"]]),
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
