"""Data: the CLIP tokenizer (the port's copy of emox/data/tokenizer.py)."""

from emox_torch.data.tokenizer import CLIPTokenizer, fallback_vocab

__all__ = ["CLIPTokenizer", "fallback_vocab"]
