"""Per-stage losses and trainable-parameter masks (counterpart of
emox/train/stages.py), for the denoising stages 1-3:

  stage1  single-frame denoising with reference conditioning; trains the
          denoiser's spatial stack and the ReferenceNet.
  stage2  video clips: trains only the temporal and audio cross-attention
          layers (zero-init, so training starts from stage-1 behaviour).
  stage3  trains only the speed embedding and the face-mask encoder, with
          the face-region weighted loss.

Losses use min-SNR-gamma weighting, the noise offset, and CFG dropout of
the reference and of the audio, as the reference configures them. Stage 2
and 3 clips may carry motion frames, which join the clip for temporal
attention but are left out of the loss.

The reference's loss draws its random numbers inside, from a JAX key. Here
they are drawn apart, by `sample_draws` from a torch.Generator, and the
loss is a deterministic function of the batch and those draws: a test can
feed it the reference's own draws. Stages 0 (face locator), 4 (ControlNet)
and 5 (VAE pretraining) and the identity embedding wait for a later slice
(ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from emox_torch.core.config import Config
from emox_torch.diffusion.schedule import Schedule, add_noise, get_velocity, min_snr_loss_weight
from emox_torch.models.audio import align_audio_to_frames, audio_feature_rate
from emox_torch.models.emo import EMOModel

STAGE_DESCRIPTIONS = {
    0: "FaceLocator mask prediction",
    1: "single-frame reference denoising",
    2: "temporal + audio attention",
    3: "speed + face-region control layers",
    4: "ControlNet dense conditioning branch",
    5: "VAE pretraining (recon + KL; the reference loads SD's pretrained "
       "VAE instead — this stage bootstraps one where no weights exist)",
}
PORTED_STAGES = (1, 2, 3)

# parameter-name substrings per conditioning family (denoiser collection)
_TEMPORAL_KEYS = ("_temporal",)
_AUDIO_KEYS = ("_audio",)
_SPEED_KEYS = ("speed_embed",)
_FACE_KEYS = ("face_mask_encoder",)
_FROZEN_SUBMODELS = ("vae", "audio_encoder", "face_locator", "controlnet", "clip_text", "clip_vision")

Draws = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


def check_stage(stage: int) -> None:
    if stage not in STAGE_DESCRIPTIONS:
        raise ValueError(f"bad stage {stage}")
    if stage not in PORTED_STAGES:
        raise NotImplementedError(
            f"stage {stage} ({STAGE_DESCRIPTIONS[stage]}) waits for a later slice of the port "
            "(ROADMAP.md, Queue 1 item 8)"
        )


def is_trainable(name: str, stage: int) -> bool:
    """The reference's predicate on one parameter name (dotted here,
    '/'-joined there; the tests hold the two partitions equal)."""
    check_stage(stage)
    if name.split(".")[0] in _FROZEN_SUBMODELS:
        return False  # frozen in stages 1-3
    is_temporal = any(k in name for k in _TEMPORAL_KEYS)
    is_audio = any(k in name for k in _AUDIO_KEYS)
    is_speed = any(k in name for k in _SPEED_KEYS)
    is_face = any(k in name for k in _FACE_KEYS)
    if stage == 1:
        # spatial stack only (temporal/audio/speed/face stay at init)
        return not (is_temporal or is_audio or is_speed or is_face)
    if stage == 2:
        return is_temporal or is_audio
    return is_speed or is_face


def trainable_mask(modules: nn.Module, stage: int) -> Dict[str, bool]:
    """{parameter name: True when the optimizer updates it} over `modules`
    (an EMOModules: vae, reference_net, denoiser, audio_encoder)."""
    return {name: is_trainable(name, stage) for name, _ in modules.named_parameters()}


def _clip_frames(batch: Batch, stage: int) -> Tuple[torch.Tensor, int]:
    """The clip the loss encodes, [B, T, H, W, 3] with any motion frames
    first, and the number of motion frames."""
    frames = batch["images"][:, None] if stage == 1 else batch["frames"]
    if stage >= 2 and "motion_frames" in batch:
        motion = batch["motion_frames"]
        return torch.cat([motion.to(frames.device), frames], dim=1), motion.shape[1]
    return frames, 0


def sample_draws(config: Config, sched: Schedule, stage: int, batch: Batch,
                 generator: torch.Generator) -> Draws:
    """Every random number of one denoise loss, drawn from `generator` on its
    device: the posterior noise `posterior_eps` [B*T, h, w, C] (with
    train.vae_encode "sample"), `noise` [B, T, h, w, C], `noise_offset`
    [B, 1, 1, 1, 1] (with diffusion.noise_offset > 0), `timesteps` [B], and
    with train.uncond_ratio > 0 the reference-drop mask `ref_drop` [B] bool
    and, when the batch has audio, the audio-keep mask `audio_keep`
    [B, 1, 1, 1] (1 keeps the sample's audio)."""
    check_stage(stage)
    frames, _ = _clip_frames(batch, stage)
    b, t, height, width = frames.shape[:4]
    ds = config.vae.downscale
    lat = (height // ds, width // ds, config.vae.latent_channels)
    dev = generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    uniform = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    draws: Draws = {}
    if config.train.vae_encode == "sample":
        draws["posterior_eps"] = normal(b * t, *lat)
    draws["noise"] = normal(b, t, *lat)
    if config.diffusion.noise_offset > 0:
        draws["noise_offset"] = normal(b, 1, 1, 1, 1)
    draws["timesteps"] = torch.randint(0, sched.num_train_timesteps, (b,), generator=generator, device=dev)
    p = config.train.uncond_ratio
    if p > 0:
        draws["ref_drop"] = uniform(b) < p
        if stage >= 2 and "wav" in batch:
            draws["audio_keep"] = (uniform(b, 1, 1, 1) < 1.0 - p).float()
    return draws


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize's "bilinear" method along
    one axis: a triangle kernel widened by the downscale factor
    (antialiasing), normalised per output sample."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel-space face mask [B, H, W, 1] -> latent resolution [B, 1, h, w, 1]
    (jax.image.resize, bilinear with antialiasing, as the reference)."""
    m = mask.float()
    wy = _resize_weights(m.shape[1], h, m.device)
    wx = _resize_weights(m.shape[2], w, m.device)
    out = torch.einsum("bijc,ih,jw->bhwc", m, wy, wx)
    return out[:, None]


def stage_loss_fn(model: EMOModel, config: Config, sched: Schedule,
                  stage: int) -> Callable[[Batch, Draws], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Returns loss(batch, draws) -> (loss, metrics), deterministic given the
    draws of `sample_draws`. `sched` lives on the model's device."""
    check_stage(stage)
    if config.model.use_identity_embed:
        raise NotImplementedError(
            "model.use_identity_embed: the CLIP identity embedding waits for a later slice of the port "
            "(ROADMAP.md, Queue 1 item 7)"
        )
    dcfg, acfg, tcfg = config.diffusion, config.audio, config.train

    def denoise_loss(batch: Batch, draws: Draws):
        frames, num_motion = _clip_frames(batch, stage)
        t = frames.shape[1]
        eps = draws["posterior_eps"] if tcfg.vae_encode == "sample" else None
        latents = model.encode_images(frames, eps=eps)
        ref_latent = model.encode_images(batch["ref_image"])
        noise = draws["noise"]
        if dcfg.noise_offset > 0:
            noise = noise + dcfg.noise_offset * draws["noise_offset"]
        ts = draws["timesteps"]
        noisy = add_noise(sched, latents, noise, ts)

        # CFG dropout of the reference (identity): the dropped rows attend to
        # themselves in place of the reference tokens
        ref_dropout = draws["ref_drop"] if tcfg.uncond_ratio > 0 else None

        audio_windows = None
        if stage >= 2 and "wav" in batch:
            feats = model.modules.audio_encoder(model._in(batch["wav"]))
            # the wav starts `context_frames` before the un-primed clip; motion
            # frames sit num_motion frames earlier (their windows zero-pad)
            audio_windows = align_audio_to_frames(
                feats, t, audio_feature_rate(acfg), acfg.video_fps, acfg.context_frames,
                frame_offset=acfg.context_frames - num_motion,
            )
            if tcfg.uncond_ratio > 0:
                audio_windows = audio_windows * draws["audio_keep"].to(audio_windows.dtype)

        speeds = batch.get("speeds") if stage == 3 else None
        face_mask = batch.get("masks") if stage == 3 else None
        pred = model.predict_noise(noisy, ts, ref_latent, audio_windows=audio_windows, speeds=speeds,
                                   face_mask=face_mask, ref_dropout=ref_dropout)
        target = noise if sched.prediction_type == "epsilon" else get_velocity(sched, latents, noise, ts)
        err = (pred.float() - target.float()) ** 2
        if num_motion > 0:
            err = err[:, num_motion:]
        per_sample = err.mean(dim=tuple(range(1, err.dim())))
        w = min_snr_loss_weight(sched, ts, dcfg.snr_gamma)
        loss = (w * per_sample).mean()
        metrics = {"loss": loss, "mse": per_sample.mean()}
        if stage == 3 and face_mask is not None:
            lm = downsample_mask(face_mask.to(err.device), latents.shape[2], latents.shape[3])
            face_err = (err * lm).sum() / (lm.sum() * err.shape[1] * err.shape[-1] + 1e-6)
            loss = loss + tcfg.face_loss_weight * face_err
            metrics = {"loss": loss, "mse": metrics["mse"], "face_mse": face_err}
        return loss, metrics

    return denoise_loss

