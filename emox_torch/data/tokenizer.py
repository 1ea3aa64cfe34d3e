"""Self-contained CLIP BPE tokenizer (the port's copy of emox/data/tokenizer.py).

Prompts are tokenised as transformers' CLIPTokenizer does before the ids go
to the CLIP text encoder: the GPT-2 byte<->unicode table, the CLIP
word-splitting pattern, lowercasing + whitespace cleanup, and rank-driven
BPE merges with the ``</w>`` end-of-word marker. No network access and no
transformers at run time.

Vocabulary sources (first match wins):
  1. explicit ``vocab_path`` argument / ``EMOX_CLIP_VOCAB`` env var,
     pointing at either an HF-format directory or ``vocab.json`` (with a
     sibling ``merges.txt``), or an openai-format
     ``bpe_simple_vocab_16e6.txt(.gz)`` merge list;
  2. a byte-level fallback vocabulary built in-process.

The fallback is id-compatible with the real CLIP vocabulary: ids 0-255 are
the byte symbols, 256-511 the byte+``</w>`` symbols, and 49406/49407 the
start/end specials — exactly the first 512 and last 2 entries of
openai/clip-vit-large-patch14's vocab.

The reference module splits words with the third-party `regex` package,
whose ``\\p{L}`` and ``\\p{N}`` classes stdlib `re` lacks; the card machine
has no `regex`. This copy splits with the standard library alone
(`_split_words`): a scanner over ``unicodedata.category(ch)[0]`` for the
letter and number classes, the Unicode White_Space set for ``\\s``, and
stdlib `re` for the pattern's literal alternatives. It gives the reference
tokenizer's ids (tests/test_torch_clip.py); code points assigned after the
interpreter's Unicode version (15.0 in Python 3.12) may be classed
differently.
"""

from __future__ import annotations

import gzip
import html
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CLIP_VOCAB_SIZE = 49408
CLIP_MAX_LENGTH = 77

# `\s` of the reference's pattern (the `regex` package): Unicode White_Space
_WHITESPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))
_WHITESPACE_RUN = re.compile("[" + re.escape("".join(sorted(_WHITESPACE))) + "]+")
# U+0345 (combining ypogegrammeni, whose case variant iota is a letter): the
# reference's case-insensitive pattern matches it with no alternative, so it
# starts no word and is dropped, as whitespace is
_DROPPED = _WHITESPACE | {"\u0345"}
# the pattern's literal alternatives, tried first at every word start
_LITERALS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d", re.IGNORECASE)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (the exact table
    transformers.CLIPTokenizer uses)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    return _WHITESPACE_RUN.sub(" ", text).strip()


def _basic_clean(text: str) -> str:
    # the reference stack additionally runs ftfy.fix_text (mojibake repair);
    # not available offline and a no-op on clean input
    return html.unescape(html.unescape(text)).strip()


def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace (or dropped), 'O' anything else."""
    if ch in _DROPPED:
        return "S"
    major = unicodedata.category(ch)[0]
    return major if major in ("L", "N") else "O"


def _split_words(text: str) -> List[str]:
    """findall of the CLIP pattern
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (case-insensitive): at each position the first alternative that matches
    wins, each class run is greedy, and whitespace starts no word."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERALS.match(text, i)
        if m:
            words.append(m.group())
            i = m.end()
            continue
        kind = _char_class(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # a letter run, or a run of anything but letters, numbers and whitespace
            while j < n and _char_class(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


def fallback_vocab() -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Byte-level vocab, id-compatible with the real CLIP vocabulary (see
    module docstring). No merges."""
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    for i, c in enumerate(chars):
        vocab[c + "</w>"] = 256 + i
    vocab[SOT_TEXT] = CLIP_VOCAB_SIZE - 2
    vocab[EOT_TEXT] = CLIP_VOCAB_SIZE - 1
    return vocab, []


def _load_openai_merges(path: str) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """openai bpe_simple_vocab_16e6.txt(.gz): merge list; vocab is derived."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
    chars = list(bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    tokens += [SOT_TEXT, EOT_TEXT]
    return {t: i for i, t in enumerate(tokens)}, merges


def _load_hf_vocab(vocab_json: str, merges_txt: str) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_txt, encoding="utf-8") as f:
        lines = f.read().strip().split("\n")
    if lines and lines[0].startswith("#version"):
        lines = lines[1:]
    merges = [tuple(m.split()) for m in lines if m]
    return vocab, merges


class CLIPTokenizer:
    """Exact-compute CLIP BPE tokenizer."""

    def __init__(self, vocab_path: Optional[str] = None):
        vocab_path = vocab_path or os.environ.get("EMOX_CLIP_VOCAB")
        if vocab_path:
            if os.path.isdir(vocab_path):
                vj = os.path.join(vocab_path, "vocab.json")
                mt = os.path.join(vocab_path, "merges.txt")
                if os.path.exists(vj):
                    self.encoder, merges = _load_hf_vocab(vj, mt)
                else:
                    cands = [p for p in os.listdir(vocab_path) if "bpe" in p and "vocab" in p]
                    if not cands:
                        raise FileNotFoundError(f"no CLIP vocab found in {vocab_path}")
                    self.encoder, merges = _load_openai_merges(os.path.join(vocab_path, cands[0]))
            elif vocab_path.endswith(".json"):
                self.encoder, merges = _load_hf_vocab(
                    vocab_path, os.path.join(os.path.dirname(vocab_path), "merges.txt")
                )
            else:
                self.encoder, merges = _load_openai_merges(vocab_path)
            self.is_fallback = False
        else:
            self.encoder, merges = fallback_vocab()
            self.is_fallback = True
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]
        self._cache: Dict[str, List[str]] = {SOT_TEXT: [SOT_TEXT], EOT_TEXT: [EOT_TEXT]}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            self._cache[token] = list(word)
            return list(word)
        pairs = _get_pairs(word) if len(word) > 1 else set()
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids, no specials/padding."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in _split_words(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok))
        return ids

    def encode(
        self, texts: Sequence[str] | str, max_length: int = CLIP_MAX_LENGTH, pad: bool = True
    ) -> np.ndarray:
        """texts -> int32 [B, max_length]: SOT + bpe + EOT, truncated so EOT
        survives, padded with EOT (transformers CLIPTokenizer pad_token —
        the convention SD-1.5 text encoders were trained with)."""
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for t in texts:
            ids = [self.sot] + self.tokenize(t)[: max_length - 2] + [self.eot]
            if pad:
                ids = ids + [self.eot] * (max_length - len(ids))
            rows.append(ids)
        if not pad:
            width = max(len(r) for r in rows)
            rows = [r + [self.eot] * (width - len(r)) for r in rows]
        return np.asarray(rows, np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.decoder[int(i)] for i in ids if int(i) not in (self.sot, self.eot)]
        data = bytearray(self.byte_decoder[c] for c in "".join(toks) if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()
