"""Weight bridge: the reference's flax param tree -> the port's state dicts.

The port's modules carry the flax submodule names as attribute names, so a
leaf's state-dict key is its path joined with dots, and the transform
depends only on the leaf (the reverse of emox/interop/torch_import.py):

  flax leaf                          port parameter      transform
  Dense `kernel` [I, O]              Dense `weight`      -> [O, I]
  Conv `kernel` HWIO                 Conv `weight`       -> OIHW
  1-D Conv `kernel` (k, I/g, O)      Conv `weight`       -> (O, I/g, k)
  norm `scale`                       norm `weight`       rename only
  Embed `embedding` [num, features]  Embed `weight`      rename only
  `bias`, `null_context`,            same name           none
  `position_embedding`

Submodels: vae, reference_net, denoiser, audio_encoder, and clip_text when
the model has one (clip.text_enabled). face_locator and landmarker are
skipped until their modules are ported. Any other top-level entry, any
leaf that maps to no parameter, any shape mismatch, and any port parameter
left unset raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

SUBMODELS = ("vae", "reference_net", "denoiser", "audio_encoder")  # always present
OPTIONAL_SUBMODELS = ("clip_text",)  # present when the config enables them
SKIPPED = ("face_locator", "landmarker")


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(path: Tuple[str, ...], value) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    a = np.asarray(value)
    if leaf == "kernel":
        if a.ndim == 2:  # Dense [I, O]
            a = a.T
        elif a.ndim == 4:  # Conv HWIO
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 3:  # 1-D Conv (k, I/g, O)
            a = a.transpose(2, 1, 0)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {a.ndim} has no port mapping")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf not in ("bias", "null_context", "position_embedding"):
        raise ValueError(f"{'/'.join(path)}: leaf {leaf!r} has no port mapping")
    return ".".join([*mods, leaf]), np.array(a, copy=True, order="C")


def from_flax(params: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """{submodel: flax param tree} -> {submodel: state dict} (float tensors
    in the leaves' own type, on the CPU)."""
    extra = set(params) - set(SUBMODELS) - set(OPTIONAL_SUBMODELS) - set(SKIPPED)
    if extra:
        raise ValueError(f"no port mapping for top-level params {sorted(extra)}")
    return {name: state_dict_from_flax(params[name]) for name in SUBMODELS + OPTIONAL_SUBMODELS if name in params}


def state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One module's flax param tree -> its port state dict."""
    sd = {}
    for path, value in _leaves(tree):
        key, arr = _convert(path, value)
        if key in sd:
            raise ValueError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(arr)
    return sd


@torch.no_grad()
def load_module(module: nn.Module, tree: Dict[str, Any], name: str = "module") -> None:
    """Copy one module's flax param tree into `module`: every leaf must land
    on a parameter of the same shape, and every parameter must receive one."""
    sd = state_dict_from_flax(tree)
    own = module.state_dict()
    unmapped = sorted(set(sd) - set(own))
    unset = sorted(set(own) - set(sd))
    if unmapped or unset:
        raise ValueError(f"{name}: flax leaves with no port parameter {unmapped[:8]}"
                         f"{'...' if len(unmapped) > 8 else ''}; port parameters left unset "
                         f"{unset[:8]}{'...' if len(unset) > 8 else ''}")
    for key, value in sd.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{name}.{key}: flax shape {tuple(value.shape)} != port {tuple(own[key].shape)}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()}, strict=True)


def load_flax(modules: nn.Module, params: Dict[str, Any]) -> None:
    """Copy a reference param tree into `modules` (an EMOModules), submodel
    by submodel (see load_module)."""
    present = SUBMODELS + tuple(n for n in OPTIONAL_SUBMODELS if getattr(modules, n, None) is not None)
    extra = set(params) - set(present) - set(SKIPPED)
    if extra:
        raise ValueError(f"no port mapping for top-level params {sorted(extra)}")
    missing = [n for n in present if n not in params]
    if missing:
        raise ValueError(f"param tree lacks submodels {missing}")
    for name in present:
        load_module(getattr(modules, name), params[name], name)
