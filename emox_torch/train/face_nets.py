"""Train the FaceLocator and FaceLandmarkNet and keep their weights on disk
(counterpart of emox/train/face_nets.py).

The reference ships trained face nets as an npz file
(emox/assets/face_nets.npz): one array per flax leaf under its '/'-joined
path ("face_locator/conv0/kernel", ...), stored float16 by default.
`load_face_nets` reads such a file into the flax-layout tree
{"face_locator": ..., "landmarker": ...} (float32), which
`emox_torch.interop.from_flax` turns into the port's weights
(`load_face_nets_into` does both); `save_face_nets` writes a flax-layout
tree back in the same layout.

`train_face_nets` trains the port's two nets jointly on the synthetic face
distribution (emox_torch.data.fixtures.synthetic_face_batch, which carries
mask and landmark ground truth) with the reference's loss and Adam, and
returns their weights as a flax-layout tree, so the file it writes is the
reference's format. `python -m emox_torch train-face` writes it to
ASSET_PATH (emox_torch/assets/face_nets.npz), which FaceHelper.from_asset
then prefers over the file the repository ships beside the reference
(SHIPPED_ASSET_PATH, read as data).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

FACE_NETS = ("face_locator", "landmarker")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSET_PATH = os.path.join(_ROOT, "emox_torch", "assets", "face_nets.npz")
SHIPPED_ASSET_PATH = os.path.join(_ROOT, "emox", "assets", "face_nets.npz")


def default_asset_path() -> str:
    """The port's own trained asset where one exists, else the shipped one."""
    return ASSET_PATH if os.path.exists(ASSET_PATH) else SHIPPED_ASSET_PATH


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


def flax_tree(module: torch.nn.Module) -> Dict:
    """A face net's weights as its flax param tree: each conv's `weight`
    OIHW -> `kernel` HWIO and its `bias` (float32 numpy), the reverse of
    from_flax's mapping for these modules."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        a = p.detach().float().cpu().numpy()
        if leaf == "weight":
            if a.ndim != 4:
                raise ValueError(f"{name}: only conv weights have a flax mapping here")
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf != "bias":
            raise ValueError(f"{name}: no flax mapping")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def face_nets_loss(locator: torch.nn.Module, landmarker: torch.nn.Module, images: torch.Tensor,
                   masks: torch.Tensor, landmarks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, bce, landmark mse) of the reference's train_face_nets: BCE with
    logits of the face mask plus 10 x the landmarks' mean squared error."""
    logits = locator(images)
    bce = (logits.clamp_min(0) - logits * masks + torch.log1p(torch.exp(-logits.abs()))).mean()
    lm = landmarker(images)
    lm_err = ((lm.float() - landmarks) ** 2).mean()
    return bce + 10.0 * lm_err, bce, lm_err


def build_face_nets(device: torch.device, seed: int = 0, init: Optional[Dict] = None):
    """(FaceLocator, FaceLandmarkNet) on `device`, float32: random weights
    from `seed` (the port's own init), or the flax-layout tree `init`."""
    from emox_torch.interop.from_flax import load_module
    from emox_torch.nn.conditioners import FaceLandmarkNet, FaceLocator
    from emox_torch.nn.layers import init_weights

    with torch.device(device):
        nets = (FaceLocator(), FaceLandmarkNet())
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, net in zip(FACE_NETS, nets):
        with torch.no_grad():
            init_weights(net, gen)
        if init is not None:
            load_module(net, init[name], name)
    return nets


def train_face_nets(steps: int = 1500, batch_size: int = 32, image_size: int = 128, learning_rate: float = 2e-3,
                    seed: int = 0, log_every: int = 200, device: Optional[Union[str, torch.device]] = None,
                    init: Optional[Dict] = None) -> Tuple[Dict, Dict[str, float]]:
    """Train both nets jointly on synthetic faces with Adam (the reference's
    optax.adam: the same moments, bias correction and eps), on `device`: the
    CUDA card unless told otherwise. Starts from the port's random init
    drawn from `seed`, or from the flax-layout tree `init`. Returns (params,
    metrics): params is the flax-layout tree {"face_locator": ...,
    "landmarker": ...} that save_face_nets writes; metrics the last logged
    step's loss, bce and landmark_mse and the held-out val_bce,
    val_landmark_mse and val_landmark_px."""
    from emox_torch.core.device import resolve_device
    from emox_torch.data.fixtures import synthetic_face_batch

    dev = resolve_device(device)
    locator, landmarker = build_face_nets(dev, seed, init)
    opt = torch.optim.Adam([*locator.parameters(), *landmarker.parameters()], lr=learning_rate)

    def tensors(b):
        return [torch.from_numpy(b[k]).to(dev, non_blocking=True) for k in ("image", "mask", "landmarks")]

    rng = np.random.default_rng(seed)
    metrics: Dict[str, float] = {}
    for i in range(steps):
        loss, bce, lm_err = face_nets_loss(locator, landmarker,
                                           *tensors(synthetic_face_batch(rng, batch_size, image_size, image_size)))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            metrics = {"loss": loss.item(), "bce": bce.item(), "landmark_mse": lm_err.item()}
            print(f"step {i}: loss {metrics['loss']:.4f} bce {metrics['bce']:.4f} "
                  f"lm_mse {metrics['landmark_mse']:.5f}", flush=True)
    # held-out validation (fresh seed), as the reference
    vb = synthetic_face_batch(np.random.default_rng(seed + 10_000), 64, image_size, image_size)
    with torch.no_grad():
        _, vbce, vlm = face_nets_loss(locator, landmarker, *tensors(vb))
    metrics["val_bce"] = float(vbce)
    metrics["val_landmark_mse"] = float(vlm)
    metrics["val_landmark_px"] = float(np.sqrt(metrics["val_landmark_mse"]) * image_size)
    print(f"held-out: bce {metrics['val_bce']:.4f} lm_rmse ~{metrics['val_landmark_px']:.2f} px "
          f"@ {image_size}px", flush=True)
    return {"face_locator": flax_tree(locator), "landmarker": flax_tree(landmarker)}, metrics
