"""Interop: weights carried over from the reference's flax param trees
(from_flax) and from diffusers / transformers checkpoints (torch_import)."""

from emox_torch.interop.from_flax import from_flax, load_flax, load_module, state_dict_from_flax
from emox_torch.interop.torch_import import load_torch_state_dict, merge_imported

__all__ = ["from_flax", "load_flax", "load_module", "load_torch_state_dict", "merge_imported", "state_dict_from_flax"]
