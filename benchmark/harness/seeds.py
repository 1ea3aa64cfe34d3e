"""Seeds derived from the run's --seed: one independent stream per purpose."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags`, from the run's seed (any whole number)."""
    text = ":".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
