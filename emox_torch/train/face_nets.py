"""The face nets' weights on disk (counterpart of the save/load half of
emox/train/face_nets.py).

The reference ships trained FaceLocator and FaceLandmarkNet weights as an
npz file (emox/assets/face_nets.npz): one array per flax leaf under its
'/'-joined path ("face_locator/conv0/kernel", ...), stored float16 by
default. `load_face_nets` reads such a file into the flax-layout tree
{"face_locator": ..., "landmarker": ...} (float32), which
`emox_torch.interop.from_flax` turns into the port's weights
(`load_face_nets_into` does both); `save_face_nets` writes a flax-layout
tree back in the same layout. The path is always the caller's: this module
knows of no file of its own.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

FACE_NETS = ("face_locator", "landmarker")


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_face_nets(params: Dict, path: str, dtype=np.float16) -> str:
    """Write the face nets of a flax-layout tree (its "face_locator" and
    "landmarker" entries) to `path` as a compressed npz, every leaf cast to
    `dtype` (float16 by default, as the reference ships them; about 1e-3
    relative rounding). Returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten({k: params[k] for k in FACE_NETS})
    np.savez_compressed(path, **{k: np.asarray(v).astype(dtype) for k, v in flat.items()})
    return path


def load_face_nets(path: str) -> Optional[Dict]:
    """The flax-layout tree {"face_locator": ..., "landmarker": ...} stored
    at `path`, every leaf float32; None when there is no such file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        flat = {k: np.asarray(f[k], np.float32) for k in f.files}
    return _unflatten(flat)


def load_face_nets_into(modules, params: Dict) -> None:
    """Copy the face nets of a flax-layout tree into `modules` (an
    EMOModules), each leaf mapped and shape-checked as from_flax maps it."""
    from emox_torch.interop.from_flax import load_module

    for name in FACE_NETS:
        load_module(getattr(modules, name), params[name], name)
