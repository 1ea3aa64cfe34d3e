"""Command-line entry points of the port (counterpart of emox/cli.py):

  python -m emox_torch precompute --metadata data/overfit.json --videos data/videos --cache data/cache
  python -m emox_torch pack-records --cache data/cache --out data/records
  python -m emox_torch train --stage 2 --config configs/stage2.yaml
  python -m emox_torch train --stage 3 --from-stage 2
  python -m emox_torch train --stage 4 --config configs/controlnet.yaml
  python -m emox_torch infer --config configs/inference.yaml --params checkpoints/stage2 \\
      --ref-image face.npy --audio speech.wav --out out.mp4
  python -m emox_torch train-face --out face_nets.npz
  python -m emox_torch eval --gen out.npz --gt data/cache/clip0.npz --params checkpoints/stage2
  python -m emox_torch import-weights --vae vae.safetensors --unet unet.bin --wav2vec2 w2v.bin --out imported
  python -m emox_torch export --params checkpoints/stage2 --frames 16 --size 256 --out emox_step.pt2

Every command that builds a model or computes (precompute, train, infer,
train-face, eval, export) runs on the CUDA card and stops when there is none; `--device cpu` asks
for the CPU (the plain PyTorch versions of the kernels) instead.
Checkpoints are the port's own (`torch.save` files `step_<n>.pt`, written
by `train`); a flax param tree from the reference reaches the port through
emox_torch.interop.from_flax. YAML is read and written by
emox_torch.core.yamlio, so PyYAML is not needed.

`import-weights` writes one torch.save state dict per component in the
port's names (emox_torch.interop.torch_import; .safetensors read without
the package); `export` writes a torch.export artifact of the denoise step
whose kernels are the port's registered ops (emox_torch.infer.export).
Every command first calls emox_torch.core.compile_cache.enable_persistent_cache.

`train --coordinator host:port --num-processes N --process-id r` runs rank
r of an N-process torch.distributed world (nccl on the ranks' cards,
cuda:<local rank> each; gloo with `--device cpu`) on the mesh of the
config's `mesh` section: every rank reads the same global batches from an
identically seeded loader and trains on its rows and frames of them
(emox_torch.train.Trainer); the master alone writes the checkpoints and
metrics.

Registered but not yet ported, exiting non-zero: `bench`, which comes with
the port's benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional

# what the port has not ported yet
_NOT_PORTED = {
    "bench": "bench comes with the port's benchmark, which a benchmark PR writes with BENCHMARK.json",
}


def _parse_overrides(pairs: List[str]) -> Dict[str, Dict[str, Any]]:
    """--set section.key=value (YAML-typed) -> nested override dict."""
    from emox_torch.core import yamlio

    out: Dict[str, Dict[str, Any]] = {}
    for p in pairs:
        if "=" not in p or "." not in p.split("=", 1)[0]:
            raise SystemExit(f"--set expects section.key=value, got {p!r}")
        k, v = p.split("=", 1)
        sec, key = k.split(".", 1)
        val = yamlio.loads(v)
        if isinstance(val, str):
            try:  # YAML 1.1 doesn't parse '1e-3' as a float; users expect it
                val = float(val)
            except ValueError:
                pass
        out.setdefault(sec, {})[key] = val
    return out


def _load_config(args):
    import dataclasses

    from emox_torch.core.config import load_config, stage_presets

    overrides = _parse_overrides(args.set or [])
    if getattr(args, "stage", None) is not None and args.config is None:
        # stage presets as the base when no YAML given
        base = stage_presets(args.stage) if args.stage in (1, 2, 3, 5) else {}
        for sec, vals in overrides.items():
            base.setdefault(sec, {}).update(vals)
        overrides = base
    cfg = load_config(args.config, overrides)
    if getattr(args, "stage", None) is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, stage=args.stage))
    return cfg


def _device(args):
    """The command's device: --device, else the CUDA card (none: exit)."""
    from emox_torch.core.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (pass --device cpu)") from None


def _restore_params(path: str, use_ema: bool = False):
    """Every parameter of the newest checkpoint under `path` (a directory of
    the port's step_<n>.pt files), the EMA shadow weights with use_ema."""
    from emox_torch.train.trainer import Checkpointer

    if not os.path.isdir(path):
        raise SystemExit(f"no checkpoint directory {path}")
    ckpt = Checkpointer(path)
    if ckpt.latest_step() is None:
        entries = os.listdir(path)
        if any(e.isdigit() for e in entries):
            raise SystemExit(
                f"{path} holds checkpoints in the reference's Orbax layout; the port reads its own torch.save "
                "checkpoints (step_<n>.pt): load a flax param tree with emox_torch.interop.from_flax")
        raise SystemExit(f"no checkpoint under {path}")
    return ckpt.restore_params(use_ema=use_ema)


def _load_weights(model, params) -> None:
    """Copy a checkpoint's parameters into the model (every one named)."""
    import torch

    own = dict(model.modules.named_parameters())
    missing = sorted(set(own) - set(params))
    if missing:
        raise SystemExit(f"the checkpoint lacks parameters {missing[:8]} of this configuration")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])


def cmd_precompute(args) -> int:
    from emox_torch.data.precompute import precompute_dataset

    dev = _device(args)
    face_helper = None
    if args.face_ckpt:
        # trained stage-0 FaceLocator + FaceLandmarkNet replace MediaPipe as
        # the mask/pose provider (reference Net.py:861-1156 FaceHelper)
        from emox_torch.core.config import Config, load_config
        from emox_torch.data.face import FaceHelper
        from emox_torch.models.emo import EMOModel

        cfg = load_config(args.config) if args.config else Config()
        params = _restore_params(args.face_ckpt)
        model = EMOModel(cfg, device=dev)
        _load_weights(model, params)
        face_helper = FaceHelper.from_model(model)
        print(f"face provider: trained stage-0 nets from {args.face_ckpt}")

    man = precompute_dataset(
        args.metadata, args.videos, args.cache, width=args.width, height=args.height, fps=args.fps,
        face_helper=face_helper, with_control=not args.skip_control, device=dev,
    )
    with open(man) as f:
        manifest = json.load(f)
    if args.debug_overlays:
        # head-pose axis overlays per clip, the reference's *_debug.jpg
        # dataset-prep artifact (reference Net.py:1077-1087 draw_axis)
        import numpy as np

        from emox_torch.data.face import pose_debug_overlay
        from emox_torch.infer.video_io import frames_to_uint8

        for cid, entry in manifest.items():
            with np.load(entry["path"]) as z:
                if "landmarks" not in z:
                    continue
                ov = pose_debug_overlay(z["frames"], z["landmarks"])
            if ov is None:
                continue
            dbg = os.path.join(args.cache, f"{cid}_debug.png")
            try:
                import imageio.v3 as iio

                iio.imwrite(dbg, frames_to_uint8(ov))
            except Exception:
                dbg = os.path.join(args.cache, f"{cid}_debug.npy")
                np.save(dbg, ov)
            print(f"pose debug overlay: {dbg}")
    print(f"precomputed {len(manifest)} clips -> {args.cache}")
    return 0


def cmd_pack_records(args) -> int:
    from emox_torch.data.records import write_shards

    idx = write_shards(args.cache, args.out, shard_bytes=args.shard_mb * 1024 * 1024)
    with open(idx) as f:
        meta = json.load(f)
    print(f"packed {len(meta['clips'])} clips into {len(meta['shards'])} shard(s) -> {args.out}")
    return 0


def build_train_data(cfg, stage: int, stage_name: str):
    """Dataset + loader exactly as DataConfig/AugmentConfig specify
    (augmentation, motion-frame priming, stage>=2 first-frame reference,
    multi-worker prefetch)."""
    from emox_torch.data.dataset import DataLoader, EMODataset

    ds = EMODataset(
        cfg.data.cache_dir, stage_name, num_frames=cfg.data.num_frames,
        audio_context_frames=cfg.audio.context_frames, sample_rate=cfg.audio.sample_rate,
        fps=cfg.audio.video_fps, speed_axes=cfg.model.speed_axes,
        augment=cfg.augment if cfg.augment.enabled else None,
        num_motion_frames=cfg.data.num_motion_frames if stage >= 1 else 0,
        # stage >= 2: clip frame 0 is the identity reference (the reference's
        # convention, reference train_stage_2_temporal_audio.py first frame)
        ref_mode="first" if stage >= 2 else "random",
    )
    dl = DataLoader(
        ds, batch_size=cfg.data.batch_size, seed=cfg.data.seed,
        num_workers=max(1, cfg.data.num_workers),
        prefetch=0 if cfg.data.num_workers == 0 else 2,
    )
    return ds, dl


def device_batches(batches: Iterable[Dict[str, Any]], device) -> Iterator[Dict[str, Any]]:
    """The loader's numpy batches as tensors on `device`, converted here, in
    the consumer's thread (the loader threads never touch the card): a pinned
    host copy, then a copy that does not block the host."""
    import numpy as np
    import torch

    cuda = torch.device(device).type == "cuda"
    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t.to(device)
        yield out


def cmd_train(args) -> int:
    from emox_torch.comm.runtime import initialize_distributed, is_master, local_device
    from emox_torch.core.config import save_config
    from emox_torch.train.stages import STAGE_DESCRIPTIONS
    from emox_torch.train.trainer import Trainer

    distributed = bool(args.coordinator or args.num_processes)
    if distributed:
        try:
            info = initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
            dev = local_device(args.device)
        except (ValueError, RuntimeError) as e:
            raise SystemExit(str(e)) from None
        print(f"process {info.process_index}/{info.process_count}, "
              f"{info.local_devices} local / {info.global_devices} global devices")
    cfg = _load_config(args)
    stage = cfg.train.stage
    if not distributed:
        dev = _device(args)
    stage_name = {0: "stage0-facelocator", 1: "stage1", 2: "stage2", 3: "stage3",
                  4: "stage4-control", 5: "stage1"}[stage]  # stage 5 (VAE) trains on stage-1 single frames
    print(f"stage {stage}: {STAGE_DESCRIPTIONS[stage]}")

    trainer = Trainer(cfg, device=dev)
    if args.from_stage is not None:
        if not trainer.load_params_from_stage(args.from_stage):
            raise SystemExit(f"no stage-{args.from_stage} checkpoint under {cfg.train.checkpoint_dir}")
        print(f"initialised from stage-{args.from_stage} checkpoint")
    resumed = trainer.resume()
    if resumed:
        print(f"resumed at step {resumed}")
    if is_master():
        os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
        save_config(cfg, os.path.join(cfg.train.checkpoint_dir, f"stage{stage}_config.yaml"))

    _, dl = build_train_data(cfg, stage, stage_name)
    metrics = trainer.fit(device_batches(dl, trainer.device))
    trainer.close()
    print(json.dumps({"final_step": int(trainer.state.step), **metrics}))
    if distributed:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


def cmd_infer(args) -> int:
    import numpy as np
    import torch

    from emox_torch.core.dtypes import dtype_by_name
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.infer.video_io import save_video, save_videos_grid
    from emox_torch.models.emo import EMOModel

    cfg = _load_config(args)
    dev = _device(args)
    # the model serves in the compute dtype it trained in
    model = EMOModel(cfg, dtype=dtype_by_name(cfg.train.compute_dtype), device=dev)
    if args.params:
        _load_weights(model, _restore_params(args.params, use_ema=args.ema))
    else:
        print("WARNING: no --params given; using random init (smoke test)")

    ref = _load_image(args.ref_image, cfg.inference.width, cfg.inference.height)
    wav, sr = _load_audio(args.audio, cfg.audio.sample_rate)
    fps = cfg.inference.fps
    total = args.frames or int(len(wav) / sr * fps) or cfg.inference.video_length

    face_mask = None
    if args.face_mask == "auto":
        # stage-0 FaceLocator on the reference image (the geometric prior
        # where the locator finds no face)
        with torch.no_grad():
            logits = model.locate_face(torch.from_numpy(ref[None]))
        face_mask = (torch.sigmoid(logits.float()) > 0.5).float()
        if float(face_mask.mean()) < 0.01:
            from emox_torch.data.face import geometric_prior_mask

            face_mask = torch.from_numpy(geometric_prior_mask(cfg.inference.height, cfg.inference.width)[None])
    elif args.face_mask:
        face_mask = torch.from_numpy(
            _load_image(args.face_mask, cfg.inference.width, cfg.inference.height)[None, ..., :1])

    speeds = _parse_speeds(args.speeds, total, cfg.model.speed_axes)
    tokenizer = None
    if args.prompt is not None:
        from emox_torch.data.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer(args.vocab)
        if tokenizer.is_fallback:
            print("NOTE: no CLIP vocab file (--vocab/EMOX_CLIP_VOCAB); using "
                  "byte-level fallback tokenization")

    n = max(1, args.grid)
    # N samples in one batched call: the initial latents carry the batch
    # axis, so each row draws its own noise — N distinct samples
    ref_b = torch.from_numpy(np.repeat(ref[None], n, axis=0)).to(dev)
    wav_b = torch.from_numpy(np.repeat(wav[None], n, axis=0)).to(dev)
    if face_mask is not None:
        face_mask = face_mask.to(dev).repeat_interleave(n, dim=0)
    if speeds is not None:
        speeds = speeds.to(dev).repeat_interleave(n, dim=0)

    pipe = EMOPipeline(model, cfg)
    t0 = time.perf_counter()
    if total > cfg.inference.context_frames and args.autoregressive:
        frames = pipe.generate_long(
            ref_b, wav_b, total_frames=total, segment_length=cfg.inference.context_frames,
            num_inference_steps=args.steps, guidance_scale=args.guidance, speeds=speeds, face_mask=face_mask,
            prompt=args.prompt, negative_prompt=args.negative_prompt, tokenizer=tokenizer,
            use_identity=args.identity,
        )
    else:
        frames = pipe(
            ref_b, wav_b, video_length=total, num_inference_steps=args.steps, guidance_scale=args.guidance,
            face_mask=face_mask, speeds=speeds, prompt=args.prompt, negative_prompt=args.negative_prompt,
            tokenizer=tokenizer, use_identity=args.identity,
        )
    frames = frames.float().cpu().numpy()  # waits for the card
    secs = time.perf_counter() - t0
    if n > 1:
        # tiled multi-sample grid (reference util.py:21-33 save_videos_grid)
        out = save_videos_grid(frames, args.out, fps=fps)
        print(f"wrote {out} ({n}-sample grid, {total} frames @ {fps} fps, {secs:.3f} s)")
    else:
        out = save_video(frames[0], args.out, fps=fps, wav=wav, sample_rate=sr)
        print(f"wrote {out} ({total} frames @ {fps} fps, {secs:.3f} s)")
    return 0


def cmd_import_weights(args) -> int:
    """diffusers / transformers checkpoints -> one file per component in the
    port's format (a torch.save of its state dict, the port's names), with
    the import's report."""
    import torch

    from emox_torch.interop.torch_import import (import_clip_text, import_clip_vision, import_unet2d, import_vae,
                                                 import_wav2vec2, load_torch_state_dict)

    cfg = _load_config(args)
    os.makedirs(args.out, exist_ok=True)
    for name, path, fn, sub_cfg in (
        ("vae", args.vae, import_vae, cfg.vae),
        ("unet", args.unet, import_unet2d, cfg.model),
        ("wav2vec2", args.wav2vec2, import_wav2vec2, cfg.audio),
        ("clip_text", args.clip_text, import_clip_text, cfg.clip),
        ("clip_vision", args.clip_vision, import_clip_vision, cfg.clip),
    ):
        if not path:
            continue
        t0 = time.perf_counter()
        sd = load_torch_state_dict(path)
        t1 = time.perf_counter()
        imported = fn(sd, sub_cfg)
        report = imported.pop("__report__")
        t2 = time.perf_counter()
        out = os.path.join(args.out, f"{name}.pt")
        torch.save(imported, out)
        t3 = time.perf_counter()
        print(f"{name}: {report.summary()}")
        print(json.dumps({"component": name, "source": path, "out": out, "read_s": t1 - t0, "map_s": t2 - t1,
                          "write_s": t3 - t2, "source_bytes": os.path.getsize(path), "bytes": os.path.getsize(out),
                          "loaded": len(report.loaded), "missing_in_source": report.missing_in_source,
                          "unused_source_keys": report.unused_source_keys}))
    return 0


def cmd_export(args) -> int:
    """Export the denoise step with torch.export (emox_torch.infer.export):
    the artifact holds the program, with the port's kernels as registered
    ops, and no weight."""
    from emox_torch.core.dtypes import dtype_by_name
    from emox_torch.infer.export import export_denoise_step, export_switches, kernel_nodes, save_exported
    from emox_torch.models.emo import EMOModel

    cfg = _load_config(args)
    dev = _device(args)
    dtype = dtype_by_name(cfg.train.compute_dtype)
    model = EMOModel(cfg, dtype=dtype, device=dev)
    if args.params:
        _load_weights(model, _restore_params(args.params, use_ema=args.ema))
    else:
        print("NOTE: no --params given; exporting with random init (the weights are an input of the program)")
    t0 = time.perf_counter()
    exported = export_denoise_step(model, num_frames=args.frames, image_size=args.size, dtype=dtype)
    t1 = time.perf_counter()
    save_exported(exported, args.out)
    print(json.dumps({"out": args.out, "frames": args.frames, "size": args.size, "dtype": str(dtype).split(".")[-1],
                      "device": str(dev), "export_s": t1 - t0, "save_s": time.perf_counter() - t1,
                      "bytes": os.path.getsize(args.out), "switches": export_switches(),
                      "kernel_ops": kernel_nodes(exported)}))
    print(f"exported denoise step ({args.frames}f {args.size}^2) -> {args.out}")
    return 0


def cmd_train_face(args) -> int:
    """Train the FaceLocator+FaceLandmarkNet provider nets on the synthetic
    face distribution and write them as the reference's asset format."""
    import numpy as np

    from emox_torch.train.face_nets import ASSET_PATH, save_face_nets, train_face_nets

    dev = _device(args)
    params, metrics = train_face_nets(
        steps=args.steps, batch_size=args.batch_size, image_size=args.size,
        learning_rate=args.lr, seed=args.seed, device=dev,
    )
    path = save_face_nets(params, args.out or ASSET_PATH, dtype=np.float32 if args.fp32 else np.float16)
    print(json.dumps({"asset": path, **{k: round(v, 6) for k, v in metrics.items()}}))
    return 0


def cmd_eval(args) -> int:
    """Quality metrics on a generated clip: PSNR, SSIM and flicker against a
    ground truth; audio sync from its face masks and audio; with --params,
    the CLIP identity similarity to --ref-image (a checkpoint with
    clip_vision) and the Fréchet distance of the two clips' VAE latents
    pooled to 4x4."""
    import numpy as np
    import torch

    from emox_torch.eval import evaluate_clip, frechet_distance, identity_similarity

    dev = _device(args)
    gen = _load_frames(args.gen)
    gt = masks = wav = None
    fps, sr = args.fps, 16000
    if args.gt:
        if args.gt.endswith(".npz"):
            # a precompute cache carries its masks, wav and fps with the frames
            with np.load(args.gt) as z:
                gt = np.asarray(z["frames"])
                if gt.dtype == np.uint8:
                    gt = gt.astype(np.float32) / 127.5 - 1.0
                masks = np.asarray(z["face_masks"]) if "face_masks" in z else None
                wav = np.asarray(z["wav"]) if "wav" in z else None
                if fps is None and "fps" in z:  # an explicit --fps wins
                    fps = float(z["fps"])
        else:
            gt = _load_frames(args.gt)
    fps = 25.0 if fps is None else fps
    if args.audio:
        wav, sr = _load_audio(args.audio, sr)
    if gt is not None:
        t = min(len(gen), len(gt))
        gen, gt = gen[:t], gt[:t]
        masks = masks[:t] if masks is not None else None
        if gen.shape[1:3] != gt.shape[1:3]:
            from emox_torch.data.native import resize_bilinear

            h, w = gt.shape[1:3]
            gen = np.stack([resize_bilinear(np.ascontiguousarray(f, np.float32), h, w) for f in gen])
    metrics = evaluate_clip(gen, gt=gt, masks=masks, wav=wav, fps=fps, sample_rate=sr, device=dev)

    if args.params:
        from emox_torch.models.emo import EMOModel

        cfg = _load_config(args)
        model = EMOModel(cfg, device=dev)  # float32, as the reference evaluates
        params = _restore_params(args.params, use_ema=args.ema)
        _load_weights(model, params)
        del params
        if args.ref_image:
            if model.modules.clip_vision is not None:
                from emox_torch.data.native import resize_bilinear
                from emox_torch.models.clip import clip_normalize

                s = cfg.clip.image_size
                ref = _load_image(args.ref_image, s, s)
                small = np.stack([resize_bilinear(np.ascontiguousarray(f, np.float32), s, s) for f in gen])
                with torch.inference_mode():
                    emb = model.encode_image_embedding(clip_normalize(torch.from_numpy((small + 1.0) / 2.0)))
                    ref_emb = model.encode_image_embedding(clip_normalize(torch.from_numpy((ref[None] + 1.0) / 2.0)))
                metrics["identity_similarity"] = float(identity_similarity(emb, ref_emb[0]))
            else:
                print("NOTE: config/checkpoint has no clip_vision; skipping identity metric")
        if gt is not None:
            from emox_torch.nn.layers import resize_bilinear as resize_latents

            def enc(frames):
                # pooled to a compact per-frame descriptor: a clip has only T
                # samples, so the Gaussian fit needs D << the latent's size
                with torch.inference_mode():
                    lat = model.encode_images(torch.from_numpy(np.ascontiguousarray(frames, np.float32)))
                    return resize_latents(lat, 4, 4).reshape(lat.shape[0], -1)

            if len(gen) >= 2 and len(gt) >= 2:
                metrics["latent_frechet"] = float(frechet_distance(enc(gen), enc(gt)))
            else:
                print("NOTE: latent_frechet needs >= 2 frames per set; skipping")

    line = json.dumps({k: round(v, 6) for k, v in metrics.items()})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def _load_frames(path: str):
    """.npz (its "frames"), .npy or a video file (cv2) -> [T, H, W, 3]
    float32 in [-1, 1]."""
    import numpy as np

    if path.endswith(".npz"):
        with np.load(path) as z:
            fr = np.asarray(z["frames"])
    elif path.endswith(".npy"):
        fr = np.load(path)
    else:
        from emox_torch.infer.video_io import VideoReader

        with VideoReader(path) as r:
            fr = np.stack(list(r))
    if fr.dtype == np.uint8:
        fr = fr.astype(np.float32) / 127.5 - 1.0
    return fr[..., :3].astype(np.float32)


def _not_ported(key: str):
    def cmd(args) -> int:
        raise SystemExit(_NOT_PORTED[key])

    return cmd


def _parse_speeds(spec, total_frames: int, speed_axes: int):
    """--speeds: .npy path ([T] or [T, A]) or comma-separated floats (one
    per axis, held constant over the clip) -> [1, T(, A)] float32 tensor.
    Reaches the trained stage-3 speed conditioning (reference
    EMOAnimationPipeline.py:577 head_rotation_speeds)."""
    if not spec:
        return None
    import numpy as np
    import torch

    if os.path.exists(spec):
        arr = np.load(spec).astype(np.float32)
        if arr.ndim == 1:
            arr = arr[:, None] if speed_axes > 1 else arr
        elif arr.ndim == 2 and speed_axes == 1 and arr.shape[1] == 1:
            arr = arr[:, 0]  # the documented [T, axes] form at axes=1
    else:
        vals = np.asarray([float(v) for v in spec.split(",")], np.float32)
        if len(vals) != speed_axes:
            raise SystemExit(
                f"--speeds got {len(vals)} comma-separated values but the model "
                f"has speed_axes={speed_axes}; pass exactly one value per axis"
            )
        arr = np.tile(vals[None], (total_frames, 1)) if speed_axes > 1 else np.full(
            (total_frames,), vals[0], np.float32)
    # pad/trim to the clip length
    if arr.shape[0] < total_frames:
        arr = np.concatenate([arr, np.repeat(arr[-1:], total_frames - arr.shape[0], axis=0)])
    arr = arr[:total_frames]
    expected_ndim = 2 if speed_axes > 1 else 1
    if arr.ndim != expected_ndim or (speed_axes > 1 and arr.shape[1] != speed_axes):
        raise SystemExit(f"--speeds needs {speed_axes} axis values per frame, got shape {arr.shape}")
    return torch.from_numpy(np.ascontiguousarray(arr[None]))


def _load_image(path: str, width: int, height: int):
    """.npy, or an image file through imageio or cv2 -> [H, W, 3] float32 in
    [-1, 1] at (height, width)."""
    import numpy as np

    from emox_torch.data.native import resize_bilinear, u8_to_unit

    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            import imageio.v3 as iio

            img = iio.imread(path)
        except Exception as e_iio:
            try:
                import cv2

                img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            except Exception as e_cv2:
                raise SystemExit(f"cannot read {path}: imageio ({e_iio}) and cv2 ({e_cv2}) both failed; "
                                 "a .npy image always works") from None
    if img.dtype == np.uint8:
        img = u8_to_unit(img)
    if img.shape[:2] != (height, width):
        img = resize_bilinear(np.ascontiguousarray(img, np.float32), height, width)
    return img[..., :3].astype(np.float32)


def _load_audio(path: str, sample_rate: int):
    """.npy (taken at sample_rate) or a 16-bit .wav (mixed to mono and
    resampled) -> (float32 waveform, sample_rate)."""
    import wave

    import numpy as np

    from emox_torch.data.native import resample_linear

    if path.endswith(".npy"):
        return np.load(path).astype(np.float32), sample_rate
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        raw = f.readframes(n)
        pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
        if f.getnchannels() > 1:
            pcm = pcm.reshape(-1, f.getnchannels()).mean(axis=1)
    if sr != sample_rate:
        pcm = resample_linear(pcm, float(sr), float(sample_rate))
    return pcm, sample_rate


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="emox_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("precompute", help="video/audio -> cached training arrays")
    pp.add_argument("--metadata", required=True)
    pp.add_argument("--videos", required=True)
    pp.add_argument("--cache", required=True)
    pp.add_argument("--width", type=int, default=256)
    pp.add_argument("--height", type=int, default=256)
    pp.add_argument("--fps", type=float, default=25.0)
    pp.add_argument("--face-ckpt", default=None,
                    help="stage-0 checkpoint dir (the port's, written by train --stage 0): trained "
                         "FaceLocator+landmarks as mask/pose provider")
    pp.add_argument("--config", default=None, help="YAML config for --face-ckpt model shape")
    pp.add_argument("--skip-control", action="store_true",
                    help="skip the stage-4 landmark-skeleton control renders (saves cache space when ControlNet training is not planned)")
    pp.add_argument("--debug-overlays", action="store_true",
                    help="write a head-pose axis overlay image per clip (the reference's *_debug.jpg prep artifact)")
    _add_device(pp)
    pp.set_defaults(fn=cmd_precompute)

    pk = sub.add_parser(
        "pack-records",
        help="per-clip .npz caches -> sharded mmap records (streaming loader for the 36k-clip corpus)",
    )
    pk.add_argument("--cache", required=True, help="dir of per-clip .npz caches (precompute output)")
    pk.add_argument("--out", required=True, help="output dir for shard-*.rec + index.json")
    pk.add_argument("--shard-mb", type=int, default=512)
    pk.set_defaults(fn=cmd_pack_records)

    pt = sub.add_parser("train", help="run a training stage")
    pt.add_argument("--stage", type=int, choices=(0, 1, 2, 3, 4, 5),
                    help="5 = VAE pretraining (bootstrap the autoencoder where the reference "
                         "loads SD's pretrained one); 4 is not ported yet")
    pt.add_argument("--config", default=None, help="YAML config path")
    pt.add_argument("--from-stage", type=int, default=None, help="init from this stage's checkpoint")
    pt.add_argument("--coordinator", default=None,
                    help="host:port (or an init URL) where the processes of a distributed run meet")
    pt.add_argument("--num-processes", type=int, default=None, help="ranks of the distributed run")
    pt.add_argument("--process-id", type=int, default=None, help="this process's rank")
    pt.add_argument("--set", nargs="*", action="extend", default=[], metavar="SEC.KEY=VAL", help="config overrides (repeatable)")
    _add_device(pt)
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("infer", help="reference image + audio -> talking-head video")
    pi.add_argument("--config", default=None)
    pi.add_argument("--params", default=None, help="checkpoint directory (the port's, e.g. checkpoints/stage2)")
    pi.add_argument("--ref-image", required=True, help=".npy [H, W, 3], or an image file (imageio or cv2)")
    pi.add_argument("--audio", required=True, help=".wav (16-bit) or .npy at audio.sample_rate")
    pi.add_argument("--out", default="out.mp4", help=".mp4, or .npz for the frames as arrays")
    pi.add_argument("--frames", type=int, default=None)
    pi.add_argument("--steps", type=int, default=None)
    pi.add_argument("--guidance", type=float, default=None)
    pi.add_argument("--autoregressive", action="store_true")
    pi.add_argument("--grid", type=int, default=1, metavar="N",
                    help="sample N videos in one batch and write a tiled grid mp4 "
                         "(reference save_videos_grid, util.py:21-33)")
    pi.add_argument("--face-mask", default=None, help="'auto' (FaceLocator) or mask image path")
    pi.add_argument("--speeds", default=None,
                    help="head-rotation speeds: .npy ([T] or [T,axes]) or comma floats per axis")
    pi.add_argument("--prompt", default=None, help="text prompt (requires clip.text_enabled)")
    pi.add_argument("--negative-prompt", default="")
    pi.add_argument("--vocab", default=None,
                    help="CLIP vocab: HF dir/vocab.json or openai bpe .txt(.gz); default EMOX_CLIP_VOCAB")
    pi.add_argument("--identity", action="store_true",
                    help="CLIP-encode the reference image as an identity embedding "
                         "(requires clip.vision_enabled + model.use_identity_embed)")
    pi.add_argument("--ema", action="store_true", help="serve EMA shadow weights when present")
    pi.add_argument("--set", nargs="*", action="extend", default=[], metavar="SEC.KEY=VAL")
    _add_device(pi)
    pi.set_defaults(fn=cmd_infer)

    pf = sub.add_parser("train-face", help="train + write the FaceLocator/FaceLandmarkNet asset")
    pf.add_argument("--steps", type=int, default=1500)
    pf.add_argument("--batch-size", type=int, default=32)
    pf.add_argument("--size", type=int, default=128)
    pf.add_argument("--lr", type=float, default=2e-3)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--out", default=None,
                    help="default: emox_torch/assets/face_nets.npz (stored float16; "
                         "pass --fp32 for full-precision storage)")
    pf.add_argument("--fp32", action="store_true",
                    help="store the asset in float32 instead of the default float16")
    _add_device(pf)
    pf.set_defaults(fn=cmd_train_face)

    pe = sub.add_parser("eval", help="quality metrics on a generated clip (PSNR/SSIM/flicker/sync/identity)")
    pe.add_argument("--gen", required=True, help="generated video (.npz/.npy, or a video file through cv2)")
    pe.add_argument("--gt", help="ground-truth clip (.npz cache with frames/face_masks/wav, or video)")
    pe.add_argument("--audio", help="driving audio (.wav/.npy); overrides the gt cache's wav")
    pe.add_argument("--ref-image", help="reference image for the CLIP identity metric")
    pe.add_argument("--params", help="checkpoint directory (the port's): the identity metric and latent_frechet")
    pe.add_argument("--config", help="config YAML (the checkpoint's model)")
    pe.add_argument("--ema", action="store_true", help="use the EMA shadow weights")
    pe.add_argument("--fps", type=float, default=None, help="frame rate (default: the gt cache's fps, else 25)")
    pe.add_argument("--out", help="also write the metrics JSON to this file")
    pe.add_argument("--set", nargs="*", action="extend", default=[], metavar="SEC.KEY=VAL")
    _add_device(pe)
    pe.set_defaults(fn=cmd_eval, stage=None)

    pw = sub.add_parser("import-weights", help="diffusers / transformers checkpoints -> the port's state dicts")
    pw.add_argument("--config", default=None)
    pw.add_argument("--vae", default=None, help="AutoencoderKL checkpoint (.safetensors, .pt, .pth, .bin)")
    pw.add_argument("--unet", default=None, help="UNet2DConditionModel checkpoint")
    pw.add_argument("--wav2vec2", default=None, help="Wav2Vec2Model checkpoint")
    pw.add_argument("--clip-text", default=None, help="CLIPTextModel checkpoint (SD-1.5 text_encoder)")
    pw.add_argument("--clip-vision", default=None, help="CLIPVisionModelWithProjection checkpoint")
    pw.add_argument("--out", required=True, help="directory for <component>.pt")
    pw.add_argument("--set", nargs="*", action="extend", default=[], metavar="SEC.KEY=VAL")
    pw.set_defaults(fn=cmd_import_weights)

    px = sub.add_parser("export", help="export the denoise step with torch.export for serving")
    px.add_argument("--config", default=None)
    px.add_argument("--params", default=None, help="checkpoint directory (the port's); default: random init")
    px.add_argument("--out", required=True, help="the artifact (.pt2)")
    px.add_argument("--frames", type=int, default=16)
    px.add_argument("--size", type=int, default=256)
    px.add_argument("--ema", action="store_true", help="export with the EMA shadow weights when present")
    px.add_argument("--set", nargs="*", action="extend", default=[], metavar="SEC.KEY=VAL")
    _add_device(px)
    px.set_defaults(fn=cmd_export)

    sub.add_parser("bench", help="denoise-step throughput benchmark (not ported yet)").set_defaults(
        fn=_not_ported("bench"), not_ported=True)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from emox_torch.core.compile_cache import enable_persistent_cache

    parser = build_parser()
    # an unported command takes the reference's arguments and exits naming its item
    args, extra = parser.parse_known_args(argv)
    if extra and not getattr(args, "not_ported", False):
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    # the kernel libraries' build directory for every command (None, and
    # nothing changed, without a card)
    enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
