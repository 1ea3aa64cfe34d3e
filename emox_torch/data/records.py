"""Sharded clip records: bounded-memory storage for the full training corpus
(the port's copy of emox/data/records.py, in the same on-disk format:
shards written by either package read identically in the other).

The reference's target corpus is CelebV-HQ — 36,000 clips / 40 GB
(reference README.md:113-117) — which its EMODataset decoded per
`__getitem__` (reference Net.py:1254-1445) and our per-clip `.npz` caches
hold as whole-clip arrays (a 150-frame 512^2 clip is ~115 MB decoded; even
an LRU of 32 such clips is ~4 GB of host RAM, and sampling 8 frames pays a
whole-clip decompress).

This module packs the per-clip caches into large shard files of raw,
64-byte-aligned array bytes plus a JSON index, read back through
`np.memmap`:

  * random access to any (clip, key) without opening 36k files,
  * PARTIAL frame reads — sampling 8 frames of a 150-frame clip touches
    only those pages; the OS page cache is the only cache needed,
  * zero-copy until the training sampler actually slices.

Format (out_dir/):
  shard-00000.rec  raw little-endian array bytes, 64-byte aligned
  index.json       {"clips": {cid: {key: {"shard": i, "offset": o,
                    "shape": [...], "dtype": "float32"}}},
                    "shards": ["shard-00000.rec", ...]}
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_ALIGN = 64
INDEX_NAME = "index.json"


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def write_shards(
    cache_dir: str,
    out_dir: str,
    shard_bytes: int = 512 * 1024 * 1024,
    clip_ids: Optional[Sequence[str]] = None,
) -> str:
    """Pack per-clip `.npz` caches from `cache_dir` into shard files.

    Returns the path of the written index. Clips are packed in sorted-id
    order; a new shard starts whenever the current one would exceed
    `shard_bytes` (a clip never spans shards — simplifies mmap reads).
    """
    npz = {
        fn[:-4]: os.path.join(cache_dir, fn)
        for fn in os.listdir(cache_dir)
        if fn.endswith(".npz")
    }
    ids = sorted(npz) if clip_ids is None else list(clip_ids)
    if not ids:
        raise ValueError(f"no clip caches in {cache_dir}")
    os.makedirs(out_dir, exist_ok=True)
    index: Dict[str, Dict] = {"clips": {}, "shards": []}
    shard_f = None
    shard_i = -1
    pos = 0

    def open_shard():
        nonlocal shard_f, shard_i, pos
        if shard_f is not None:
            shard_f.close()
        shard_i += 1
        name = f"shard-{shard_i:05d}.rec"
        index["shards"].append(name)
        shard_f = open(os.path.join(out_dir, name), "wb")
        pos = 0

    open_shard()
    for cid in ids:
        arrays = dict(np.load(npz[cid]))
        clip_size = sum(_aligned(a.nbytes) for a in arrays.values())
        if pos > 0 and pos + clip_size > shard_bytes:
            open_shard()
        entry: Dict[str, Dict] = {}
        for key in sorted(arrays):
            a = np.ascontiguousarray(arrays[key])
            if a.dtype.byteorder == ">":  # store native little-endian
                a = a.astype(a.dtype.newbyteorder("="))
            pad = _aligned(pos) - pos
            if pad:
                shard_f.write(b"\0" * pad)
                pos += pad
            entry[key] = {
                "shard": shard_i,
                "offset": pos,
                "shape": list(a.shape),
                "dtype": a.dtype.name,
            }
            shard_f.write(a.tobytes())
            pos += a.nbytes
        index["clips"][cid] = entry
    shard_f.close()
    index_path = os.path.join(out_dir, INDEX_NAME)
    with open(index_path, "w") as f:
        json.dump(index, f)
    return index_path


def is_sharded(path: str) -> bool:
    return os.path.exists(os.path.join(path, INDEX_NAME))


class ShardedClipStore:
    """mmap-backed random access over shard files written by write_shards.

    `get(cid, key, idx=None)` returns a materialised np.ndarray; with idx
    (array of leading-axis indices) only the selected rows are copied out
    of the mapping — the whole-clip bytes are never read.
    """

    def __init__(self, root: str):
        with open(os.path.join(root, INDEX_NAME)) as f:
            self._index = json.load(f)
        self._root = root
        self._maps: List[Optional[np.memmap]] = [None] * len(self._index["shards"])
        self._map_lock = threading.Lock()  # lazy-open races (multi-worker loader)

    @property
    def clip_ids(self) -> List[str]:
        return sorted(self._index["clips"])

    def keys(self, cid: str) -> Iterable[str]:
        return self._index["clips"][cid].keys()

    def has(self, cid: str, key: str) -> bool:
        return key in self._index["clips"][cid]

    def shape(self, cid: str, key: str) -> tuple:
        return tuple(self._index["clips"][cid][key]["shape"])

    def num_frames(self, cid: str) -> int:
        return self.shape(cid, "frames")[0]

    def _mmap(self, i: int) -> np.memmap:
        if self._maps[i] is None:
            with self._map_lock:
                if self._maps[i] is None:
                    path = os.path.join(self._root, self._index["shards"][i])
                    self._maps[i] = np.memmap(path, dtype=np.uint8, mode="r")
        return self._maps[i]

    def _view(self, cid: str, key: str) -> np.ndarray:
        e = self._index["clips"][cid][key]
        dt = np.dtype(e["dtype"])
        shape = tuple(e["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        raw = self._mmap(e["shard"])[e["offset"] : e["offset"] + n]
        return raw.view(dt).reshape(shape)

    def get(self, cid: str, key: str, idx=None) -> np.ndarray:
        v = self._view(cid, key)
        if idx is None:
            return np.array(v)  # materialise (copy out of the mapping)
        return np.array(v[np.asarray(idx)])
