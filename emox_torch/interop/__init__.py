"""Interop: weights carried over from the reference's flax param trees."""

from emox_torch.interop.from_flax import from_flax, load_flax, load_module, state_dict_from_flax

__all__ = ["from_flax", "load_flax", "load_module", "state_dict_from_flax"]
