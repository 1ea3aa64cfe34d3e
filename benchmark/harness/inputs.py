"""Seeded requests and training batches, made on the device.

`request_inputs` and `train_batch` are frozen copies of chip_smoke.py's `_request_inputs`
and `_train_batch` (stage 2), with the face disc's centre and radius drawn from the seed as
well, so that a change to that script cannot move the benchmark's inputs. `PromptTokenizer`
turns a prompt into CLIP-sized ids with a fixed word table of its own; the pipeline takes it
through its `tokenizer=` argument, and the reference reads the same ids.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

SOT, EOT = 49406, 49407  # CLIP's start and end specials


class PromptTokenizer:
    """Words (lower-cased, split on whitespace and commas) -> ids in [512, 49405) by CRC32,
    between SOT and EOT, padded with EOT to `max_length`."""

    def encode(self, texts: List[str], max_length: int = 77) -> np.ndarray:
        out = np.full((len(texts), max_length), EOT, np.int64)
        for i, text in enumerate(texts):
            words = text.lower().replace(",", " ").split()
            ids = [SOT] + [512 + zlib.crc32(w.encode()) % (EOT - 1 - 512) for w in words][: max_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out


def face_disc(gen: torch.Generator, device, size: int, dtype) -> torch.Tensor:
    """A disc mask [1, size, size, 1]: centre within an eighth of the middle, radius a quarter
    to a third of the side."""
    c = (0.5 + (torch.rand(2, generator=gen, device=device) - 0.5) * 0.25) * size
    r = (0.25 + torch.rand(1, generator=gen, device=device) / 12.0) * size
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device), indexing="ij")
    return (((yy - c[0]) ** 2 + (xx - c[1]) ** 2) < r ** 2).to(dtype)[None, :, :, None]


def request_inputs(gen: torch.Generator, device, size: int, frames: int, dtype, latent_size: int,
                   speed_axes: int = 3, prompts: Optional[List[str]] = None) -> Dict[str, object]:
    """One request: reference image [1, size, size, 3] in [-1, 1], audio of (frames + 4) / 25 s
    at 16 kHz, per-frame head-rotation speeds in [-1, 1], a face mask, the initial noise of
    the latents and, where the traffic has prompts, one of them."""
    img = (torch.rand((1, size, size, 3), generator=gen, device=device) * 2 - 1).to(dtype)
    wav = (torch.randn((1, int(16000 * (frames + 4) / 25.0)), generator=gen, device=device) * 0.1).to(dtype)
    speeds = (torch.rand((1, frames, speed_axes), generator=gen, device=device) * 2 - 1).to(dtype)
    mask = face_disc(gen, device, size, dtype)
    latents = torch.randn((1, frames, latent_size, latent_size, 4), generator=gen, device=device,
                          dtype=torch.float32)
    prompt = None
    if prompts:
        prompt = prompts[int(torch.randint(len(prompts), (1,), generator=gen, device=device))]
    return {"ref_image": img, "wav": wav, "speeds": speeds, "face_mask": mask, "latents": latents,
            "prompt": prompt}


def train_batch(gen: torch.Generator, device, size: int, batch: int, frames: int, context_frames: int = 2
                ) -> Dict[str, torch.Tensor]:
    """A stage-2 batch: reference images and clips N(0, 0.1^2) and audio of
    (frames + 2 * context) / 25 s at 16 kHz."""
    normal = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=device)
    return {"ref_image": normal(batch, size, size, 3), "frames": normal(batch, frames, size, size, 3),
            "wav": normal(batch, int(16000 * (frames + 2 * context_frames) / 25.0))}


def stage2_draws(gen: torch.Generator, batch: Dict[str, torch.Tensor], latent_size: int, num_train: int,
                 uncond_ratio: float, latent_channels: int = 4) -> Dict[str, torch.Tensor]:
    """The random numbers of one stage-2 loss in the order emox_torch.train.stages.sample_draws
    takes them from the same generator (posterior sample, noise, timesteps, reference drop,
    audio keep; no noise offset): a frozen copy, so that the reference draws what the trainer
    drew."""
    dev = gen.device
    b, t = batch["frames"].shape[:2]
    lat = (latent_size, latent_size, latent_channels)
    draws = {"posterior_eps": torch.randn((b * t, *lat), generator=gen, device=dev),
             "noise": torch.randn((b, t, *lat), generator=gen, device=dev),
             "timesteps": torch.randint(0, num_train, (b,), generator=gen, device=dev)}
    if uncond_ratio > 0:
        draws["ref_drop"] = torch.rand((b,), generator=gen, device=dev) < uncond_ratio
        draws["audio_keep"] = (torch.rand((b, 1, 1, 1), generator=gen, device=dev) < 1.0 - uncond_ratio).float()
    return draws
