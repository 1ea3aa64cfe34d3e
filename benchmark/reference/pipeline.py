"""The reference's serving request and stage-2 loss, from the inputs the benchmark made.

`RequestRef` conditions a request as EMOPipeline is documented to (the reference image's
posterior mean, the audio windows of each frame, the face-mask residual, the CLIP embeddings
of the prompt and of the negative prompt, the writer's tokens at each timestep) and computes
the CFG-batched noise prediction of one reader call: the unconditional half sees no reference
(its own tokens in their place), zeroed audio and the negative prompt. `stage2_loss` is the
stage-2 denoising loss of EMO's second training stage, with the draws the trainer took.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference.emo import EMORef
from benchmark.reference.sampling import add_noise

LOSS_ROWS = 2  # rows of a training batch whose loss and gradients the reference takes at a time


class RequestRef:
    def __init__(self, ref: EMORef, inputs: Dict[str, object], frames: int,
                 prompt_ids: Optional[torch.Tensor] = None, negative_ids: Optional[torch.Tensor] = None):
        self.ref = ref
        self.frames = frames
        with torch.no_grad():
            self.ref_latent = ref.encode(inputs["ref_image"].float())  # [1, h, w, 4]
            self.audio = ref.audio_windows(inputs["wav"].float(), frames)  # [1, T, A, D]
            self.speeds = inputs["speeds"].float()  # [1, T, axes]
            self.face = ref.face_mask_feat(inputs["face_mask"])  # [1, h, w, C0]
            self.context = self.uncond = None
            if prompt_ids is not None:
                self.context, self.uncond = ref.text(prompt_ids), ref.text(negative_ids)

    @torch.no_grad()
    def banks(self, t: int) -> List[torch.Tensor]:
        """The writer's tokens at each attention site for timestep t, [1, L, C] each."""
        tt = torch.tensor([t], device=self.ref_latent.device)
        return self.ref.unet("reference_net", self.ref_latent, tt, emit=True)[1]

    @torch.no_grad()
    def call_eps(self, x: torch.Tensor, frame_idx: Sequence[Sequence[int]], t: int,
                 banks: List[torch.Tensor]) -> torch.Tensor:
        """x [W, c, h, w, 4]: the windows of one reader call (frame_idx [W, c] their frames).
        Returns the CFG batch's noise predictions [2W, c, h, w, 4], unconditional half first,
        one row at a time."""
        outs = []
        tt = torch.tensor([t], device=x.device)
        for half in (0, 1):  # 0: unconditional, 1: conditional
            for w, idx in enumerate(frame_idx):
                idx = torch.as_tensor(list(idx), device=x.device)
                audio = self.audio[:, idx]
                eps, _ = self.ref.unet(
                    "denoiser", x[w:w + 1].float(), tt,
                    context=None if self.context is None else (self.context if half else self.uncond),
                    banks=banks, audio=audio if half else torch.zeros_like(audio), speeds=self.speeds[:, idx],
                    face_feat=self.face, ref_drop=torch.tensor([half == 0], device=x.device))
                outs.append(eps)
        return torch.cat(outs)


def stage2_loss(ref: EMORef, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor], acp: torch.Tensor,
                context_frames: int, rows: Optional[slice] = None) -> torch.Tensor:
    """The mean squared error of the noise prediction over a stage-2 batch: clips encoded as
    posterior samples, noised to the drawn timesteps; the reference image's posterior mean
    through the writer; the audio windows of each frame (the wav starts context_frames
    before the clip), kept or zeroed by the draw; the reference dropped by the draw.
    `rows` takes a block of the batch's rows, and the mean is then over that block."""
    rows = rows or slice(None)
    frames = batch["frames"][rows].float()
    b, t = frames.shape[:2]
    with torch.no_grad():
        eps = draws["posterior_eps"].reshape(-1, t, *draws["posterior_eps"].shape[1:])[rows]
        lat = ref.encode(frames.reshape(b * t, *frames.shape[2:]), eps=eps.reshape(b * t, *eps.shape[2:]))
        lat = lat.reshape(b, t, *lat.shape[1:])
        ref_latent = ref.encode(batch["ref_image"][rows].float())
        ts = draws["timesteps"][rows]
        noise = draws["noise"][rows].float()
        noisy = add_noise(acp, lat, noise, ts)
        banks = ref.unet("reference_net", ref_latent, ts, emit=True)[1]
        audio = ref.audio_windows(batch["wav"][rows].float(), t, frame_offset=float(context_frames))
        audio = audio * draws["audio_keep"][rows]
    pred, _ = ref.unet("denoiser", noisy, ts, banks=banks, audio=audio, ref_drop=draws["ref_drop"][rows])
    return ((pred - noise) ** 2).mean()
