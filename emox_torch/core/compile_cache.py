"""Where the port keeps its compiled kernels (counterpart of
emox/core/compile_cache.py).

The reference points jax's persistent compile cache at a directory so that
a second run loads its programs instead of compiling them. The port's
compiled artefacts are its kernel libraries, which emox_torch/ops/build.py
compiles with nvcc at first use under names that carry a hash of their
sources and flags: a library found there is loaded, not built again.
`python -m emox_torch` calls enable_persistent_cache before every command.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the kernel libraries in `path` (default
    build/emox_torch at the root of the checkout) and return it; idempotent.
    Returns None, and changes nothing, on a machine with no CUDA card, where
    no kernel is built: the counterpart of the reference's skip on a
    forced-CPU run."""
    import torch

    from emox_torch.ops import build

    if not torch.cuda.is_available():
        return None
    target = Path(path) if path else build.DEFAULT_BUILD_DIR
    target.mkdir(parents=True, exist_ok=True)
    build.BUILD_DIR = target
    return str(target)
