"""Stage-keyed dataset + batching loader over precomputed clip caches (the
port's copy of emox/data/dataset.py: one seed gives the same batches).

Equivalent of the reference EMODataset's stage dispatch (reference
Net.py:1189-1445: stage0-facelocator / stage1 frames / stage2
temporal-audio / stage3 speed layers) but reading only precomputed arrays —
no CV/audio work at iteration time. Raw audio waveform slices (with
`context` frames of margin each side, zero-padded at clip edges) travel to
the device; wav2vec2 encoding runs there as part of the train step.
Batches are numpy: the loader threads never touch the card, and the
caller moves each batch to its device (`python -m emox_torch train` does
so in its main thread).
"""

from __future__ import annotations

import json
import os
import threading
import queue as queue_mod
from collections import OrderedDict
from typing import Dict, Iterator

import numpy as np

STAGES = ("stage0-facelocator", "stage1", "stage2", "stage3", "stage4-control")


class EMODataset:
    def __init__(
        self,
        cache_dir: str,
        stage: str = "stage1",
        num_frames: int = 8,
        audio_context_frames: int = 2,
        sample_rate: int = 16000,
        fps: float = 25.0,
        augment=None,  # Optional[AugmentConfig]
        num_motion_frames: int = 0,  # preceding frames for temporal priming
        # (reference Net.py:44-72 pre_extract_motion_features + EMODataset
        # stage1-vae motion_frames; 0 disables)
        ref_mode: str = "random",  # "random" | "first": reference frame pick
        # ("first" = the reference's stage-2 convention: clip frame 0 is the
        # identity reference, train_stage_2_temporal_audio.py)
        max_cached_clips: int = 32,  # LRU bound on decoded clips held in RAM
        # (the reference's corpus target is 36k clips / 40 GB,
        # reference README.md:113-117 — an unbounded dict cannot hold it)
        speed_axes: int = 1,  # 1: scalar ||d pose|| speeds; 3: signed
        # per-axis velocities (match ModelConfig.speed_axes)
    ):
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
        if ref_mode not in ("random", "first"):
            raise ValueError(f"ref_mode must be 'random' or 'first', got {ref_mode!r}")
        self.stage = stage
        self.augment = augment
        self.num_motion_frames = num_motion_frames
        self.ref_mode = ref_mode
        self.num_frames = num_frames
        self.ctx = audio_context_frames
        self.sample_rate = sample_rate
        self.fps = fps
        from emox_torch.data import records

        self._store = None
        if records.is_sharded(cache_dir):
            # sharded record store: mmap-backed partial reads — the
            # streaming path for the 36k-clip corpus (records.py)
            self._store = records.ShardedClipStore(cache_dir)
            self.clips = [(cid, cid) for cid in self._store.clip_ids]
        else:
            man_path = os.path.join(cache_dir, "manifest.json")
            if os.path.exists(man_path):
                with open(man_path) as f:
                    manifest = json.load(f)
                self.clips = [(cid, m["path"]) for cid, m in sorted(manifest.items())]
            else:
                self.clips = [
                    (fn[:-4], os.path.join(cache_dir, fn))
                    for fn in sorted(os.listdir(cache_dir))
                    if fn.endswith(".npz")
                ]
        if not self.clips:
            raise ValueError(f"no clips in {cache_dir}")
        self.max_cached_clips = max_cached_clips
        self.speed_axes = speed_axes
        self._cache: OrderedDict[str, Dict[str, np.ndarray]] = OrderedDict()
        self._cache_lock = threading.Lock()

    def _load(self, path: str) -> Dict[str, np.ndarray]:
        with self._cache_lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
        clip = dict(np.load(path))
        with self._cache_lock:
            self._cache[path] = clip
            self._cache.move_to_end(path)
            while len(self._cache) > max(1, self.max_cached_clips):
                self._cache.popitem(last=False)
        return clip

    # ---- storage accessors (npz-LRU or sharded-mmap behind one API) ------
    def _num_frames(self, cid: str, path: str) -> int:
        if self._store is not None:
            return self._store.num_frames(cid)
        return self._load(path)["frames"].shape[0]

    def _get(self, cid: str, path: str, key: str, idx=None) -> np.ndarray:
        """Array for (clip, key); with idx only those leading-axis rows —
        the sharded store reads just those pages from disk."""
        if self._store is not None:
            return self._store.get(cid, key, idx)
        a = self._load(path)[key]
        return a if idx is None else a[np.asarray(idx)]

    def _has(self, cid: str, path: str, key: str) -> bool:
        if self._store is not None:
            return self._store.has(cid, key)
        return key in self._load(path)

    def _augment(self, frames, masks, rng, points=None, extra_maps=None):
        if self.augment is None:
            out = [frames, masks]
            if points is not None:
                out.append(points)
            if extra_maps is not None:
                out.append(extra_maps)
            return tuple(out)
        from emox_torch.data.augment import augment_clip

        return augment_clip(frames, masks, self.augment, rng, points=points, extra_maps=extra_maps)

    def __len__(self) -> int:
        return len(self.clips)

    def _wav_slice(self, wav: np.ndarray, start_frame: int) -> np.ndarray:
        """Waveform for frames [start-ctx, start+T+ctx), zero-padded."""
        from emox_torch.data import native

        spf = self.sample_rate / self.fps
        s0 = int(round((start_frame - self.ctx) * spf))
        s1 = int(round((start_frame + self.num_frames + self.ctx) * spf))
        return native.wav_window(wav, s0, s1 - s0)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Index-first sampling: frame indices are drawn from the clip's
        metadata BEFORE any pixel data is touched, so only the selected
        frames are read (+augmented) — whole-clip reads never happen on the
        sharded store. One shared augmentation covers every fetched frame
        (temporal + frame/ref consistency, reference Net.py:1244-1252)."""
        cid, path = self.clips[rng.integers(len(self.clips))]
        t_total = self._num_frames(cid, path)
        if self.stage == "stage0-facelocator":
            f = int(rng.integers(t_total))
            frames = self._get(cid, path, "frames", [f])
            masks = self._get(cid, path, "face_masks", [f])
            # ALWAYS emit landmarks + a per-item validity flag: a batch that
            # mixes annotated and bare clips keeps landmark supervision for
            # the annotated items instead of silently dropping the key for
            # everyone (ADVICE r2; the loss masks by 'landmarks_valid')
            has_lm = self._has(cid, path, "landmarks")
            lms = (
                self._get(cid, path, "landmarks", [f])
                if has_lm else np.full((1, 6, 2), 0.5, np.float32)
            )
            # landmark targets go through the SAME crop/flip geometry as
            # the image they supervise (incl. left/right point swap)
            frames, masks, lms = self._augment(frames, masks, rng, points=lms)
            return {
                "images": frames[0], "masks": masks[0], "landmarks": lms[0],
                "landmarks_valid": np.float32(1.0 if has_lm else 0.0),
            }
        if self.stage == "stage1":
            f, r = (int(v) for v in rng.integers(t_total, size=2))
            frames, _ = self._augment(self._get(cid, path, "frames", [f, r]), None, rng)
            return {"images": frames[0], "ref_image": frames[1]}
        start = int(rng.integers(max(1, t_total - self.num_frames + 1)))
        idx = np.arange(start, start + self.num_frames)
        idx = np.clip(idx, 0, t_total - 1)
        ref = int(idx[0]) if self.ref_mode == "first" else int(rng.integers(t_total))
        fetch = list(idx)
        if self.num_motion_frames > 0:
            midx = np.clip(np.arange(start - self.num_motion_frames, start), 0, t_total - 1)
            fetch += [int(i) for i in midx]
        fetch.append(ref)
        t = self.num_frames
        # fetch masks only where they are actually consumed: stage 3 uses
        # the FIRST frame's mask, stage 4 uses masks only as the fallback
        # conditioning signal when no "control" renders are cached
        has_control = self.stage == "stage4-control" and self._has(cid, path, "control")
        if self.stage == "stage3":
            mask_rows = [fetch[0]]
        elif self.stage == "stage4-control" and not has_control:
            mask_rows = fetch[:t]
        else:
            mask_rows = None
        frames = self._get(cid, path, "frames", fetch)
        masks = self._get(cid, path, "face_masks", mask_rows) if mask_rows else None
        control = self._get(cid, path, "control", idx) if has_control else None
        if control is not None and control.dtype == np.uint8:
            # precompute stores renders uint8 (4x smaller); train in [0, 1]
            control = control.astype(np.float32) / 255.0
        if control is not None:
            # cached pose renders go through the SAME AugmentParams geometry
            # as the frames they condition — colour untouched, no threshold
            # (ADVICE r2: unaugmented control was misaligned under crops/flips)
            frames, masks, control = self._augment(frames, masks, rng, extra_maps=control)
        else:
            frames, masks = self._augment(frames, masks, rng)
        item = {"frames": frames[:t], "ref_image": frames[-1]}
        if self.num_motion_frames > 0:
            item["motion_frames"] = frames[t : t + self.num_motion_frames]
        if self.stage == "stage4-control":
            # dense per-frame conditioning renders; the cache may ship real
            # pose renders under "control" (precompute writes a landmark
            # skeleton render), else face masks act as the conditioning
            # signal (reference controlnet cond image role). The mask
            # fallback is tiled to the render's 3 channels so (a) batches
            # mixing annotated and bare clips stack, and (b) the ControlNet
            # cond-embedding conv (control_cond_channels=3) sees one shape
            # regardless of which source a cache provides.
            if control is None:
                control = np.repeat(masks, 3, axis=-1)
            item["control"] = control
            return item
        item["wav"] = self._wav_slice(self._get(cid, path, "wav"), start)
        if self.stage == "stage3":
            if self.speed_axes == 3:
                if not self._has(cid, path, "pose_vel3"):
                    raise ValueError(
                        f"clip {cid}: dataset configured with speed_axes=3 but the cache "
                        "has no 'pose_vel3' (per-axis signed velocities). Re-run "
                        "`precompute` with a landmark provider, or set speed_axes=1."
                    )
                item["speeds"] = self._get(cid, path, "pose_vel3", idx)  # [T, 3] signed
            else:
                item["speeds"] = self._get(cid, path, "pose_speeds", idx)
            item["masks"] = masks[0]  # conditioning mask from first frame
        return item


class DataLoader:
    """Batched iterator with deterministic shuffling + background prefetch.

    num_workers=1 (default): one prefetch thread, fully deterministic batch
    stream for a given seed. num_workers>1: a thread pool where worker w
    draws from its own seeded RNG stream (seed+w) — per-batch contents stay
    reproducible but arrival ORDER depends on thread scheduling; use for
    throughput on the full corpus where augmentation + record reads (zlib
    releases the GIL) dominate."""

    def __init__(
        self,
        dataset: EMODataset,
        batch_size: int,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)

    def _make_batch(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        items = [self.dataset.sample(rng) for _ in range(self.batch_size)]
        # keys present in EVERY item: optional per-clip keys (e.g. stage-0
        # "landmarks" on a cache mixing annotated and bare clips) drop for
        # the batch instead of raising KeyError in the worker thread
        keys = set(items[0])
        for it in items[1:]:
            keys &= set(it)
        return {k: np.stack([it[k] for it in items]) for k in keys}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            rng = np.random.default_rng(self.seed)
            while True:
                yield self._make_batch(rng)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(self.prefetch, self.num_workers))
        stop = threading.Event()

        def worker(wid: int):
            rng = np.random.default_rng(self.seed + wid)
            pending = None  # retry the SAME batch when the queue is full —
            # dropping it would make the consumed stream depend on consumer
            # timing (and waste the decode/augment work)
            while not stop.is_set():
                if pending is None:
                    pending = self._make_batch(rng)
                try:
                    q.put(pending, timeout=0.5)
                    pending = None
                except queue_mod.Full:
                    continue

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for th in threads:
            th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
