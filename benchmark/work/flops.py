"""Model FLOPs of a request and of a train step, counted on the meta device.

The reference's own matmuls, convolutions and attention are run at the cell's shapes under
torch.utils.flop_counter.FlopCounterMode, on weights that hold no data: the count is of the
model's arithmetic, whatever implements it. For training, forward and backward as autograd
runs them for the trainable leaves; no recomputation.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.emo import EMORef, param_shapes, vae_downscale
from benchmark.reference.pipeline import RequestRef, stage2_loss
from benchmark.work.sites import reader_calls

META = torch.device("meta")


def _meta_ref(cfg: dict, trainable: Iterable[str] = ()) -> EMORef:
    train = set(trainable)
    W = {n: torch.empty(s, device=META, requires_grad=n in train) for n, s in param_shapes(cfg).items()}
    return EMORef(cfg, W)


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def request_flops(cfg: dict, size: int, frames: int, steps: int, prompt: bool) -> float:
    ref = _meta_ref(cfg)
    lat = size // vae_downscale(cfg["vae"])
    clip = min(frames, cfg["inference"]["context_frames"])
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, device=META, dtype=dtype)
    inputs = {"ref_image": empty(1, size, size, 3), "wav": empty(1, int(16000 * (frames + 4) / 25.0)),
              "speeds": empty(1, frames, 3), "face_mask": empty(1, size, size, 1)}
    ids = empty(1, cfg["clip"]["max_positions"], dtype=torch.int64) if prompt else None
    holder = {}
    total = _count(lambda: holder.setdefault("req", RequestRef(ref, inputs, frames, ids, ids)))
    req = holder["req"]
    ts = torch.zeros(steps, dtype=torch.int64, device=META)
    total += _count(lambda: ref.unet("reference_net", req.ref_latent.expand(steps, -1, -1, -1), ts, emit=True))
    banks = req.banks(0)
    per_windows: Dict[int, float] = {}
    for w in set(reader_calls(cfg, steps, frames)):
        x = empty(w, clip, lat, lat, 4)
        per_windows[w] = _count(lambda: req.call_eps(x, [list(range(clip))] * w, 0, banks))
    total += sum(per_windows[w] for w in reader_calls(cfg, steps, frames))
    total += _count(lambda: ref.decode(empty(frames, lat, lat, 4)))
    return total


def train_step_flops(cfg: dict, size: int, batch: int, frames: int, trainable: Iterable[str], uncond: float) -> float:
    trainable = list(trainable)
    ref = _meta_ref(cfg, trainable)
    lat = size // vae_downscale(cfg["vae"])
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, device=META, dtype=dtype)
    b = {"ref_image": empty(batch, size, size, 3), "frames": empty(batch, frames, size, size, 3),
         "wav": empty(batch, int(16000 * (frames + 2 * cfg["audio"]["context_frames"]) / 25.0))}
    d = {"posterior_eps": empty(batch * frames, lat, lat, 4), "noise": empty(batch, frames, lat, lat, 4),
         "timesteps": empty(batch, dtype=torch.int64), "ref_drop": empty(batch, dtype=torch.bool),
         "audio_keep": empty(batch, 1, 1, 1)}
    acp = torch.empty(cfg["diffusion"]["num_train_timesteps"], device=META)
    params = [ref.W[n] for n in trainable]

    def step():
        loss = stage2_loss(ref, b, d, acp, cfg["audio"]["context_frames"])
        torch.autograd.grad(loss, params)

    return _count(step)
