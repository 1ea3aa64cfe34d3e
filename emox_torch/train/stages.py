"""Per-stage losses and trainable-parameter masks (counterpart of
emox/train/stages.py):

  stage0  FaceLocator mask prediction (BCE with logits) and, where the batch
          has landmarks, FaceLandmarkNet's 6-point regression; trains the
          two face nets only.
  stage1  single-frame denoising with reference conditioning; trains the
          denoiser's spatial stack and the ReferenceNet.
  stage2  video clips: trains only the temporal and audio cross-attention
          layers (zero-init, so training starts from stage-1 behaviour).
  stage3  trains only the speed embedding and the face-mask encoder, with
          the face-region weighted loss.
  stage4  trains the ControlNet alone on the clip's control renders
          (batch["control"]); the denoiser stays frozen and its residual
          inputs take the gradient through its mid and up path.
  stage5  VAE pretraining: L2 + L1 reconstruction of a posterior sample plus
          a small KL term; trains the VAE only.

The denoise losses use min-SNR-gamma weighting, the noise offset, and CFG
dropout of the reference and of the audio, as the reference configures
them. With model.use_identity_embed they also CLIP-encode the reference
image (frozen) into the identity embedding, zeroed where the reference is
dropped. Stage 2 and 3 clips may carry motion frames, which join the clip for
temporal attention but are left out of the loss.

The reference's loss draws its random numbers inside, from a JAX key. Here
they are drawn apart, by `sample_draws` from a torch.Generator, and the
loss is a deterministic function of the batch and those draws: a test can
feed it the reference's own draws.

On a mesh, a stage's loss is given the global batch and the global draws
with this rank's `BatchShard` (emox_torch.core.mesh): it runs on this rank's
rows and, where a clip's frames divide by the context size, its frames only,
and returns this rank's share of each metric (its sum over the shard divided
by the global count), so that the sums over the data x context ranks are the
metrics of the whole batch and the gradients of those shares sum to the
whole loss's. Where the frames stay whole (stage 1's single frame; stage 0's
and stage 5's images), every context rank of a row computes the same sums,
and each share is divided by the context size. A metric that is a ratio of
sums over the whole batch (stage 0's `iou`, stage 5's `latent_std`) is
returned as its parts ("iou/inter", "iou/union"; "latent_std/sum",
"latent_std/sum_sq", "latent_std/count"), which `finish_metrics` turns into
the ratio once they are summed. Stage 0's landmark error divides by the
valid count of the whole batch, which every rank reads from the global
`landmarks_valid`, so its gradient needs no collective before the backward.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from emox_torch.core.mesh import BatchShard
from emox_torch.core.config import Config
from emox_torch.diffusion.schedule import Schedule, add_noise, get_velocity, min_snr_loss_weight
from emox_torch.models.audio import align_audio_to_frames, audio_feature_rate
from emox_torch.models.emo import EMOModel
from emox_torch.nn.layers import resize_bilinear

STAGE_DESCRIPTIONS = {
    0: "FaceLocator mask prediction",
    1: "single-frame reference denoising",
    2: "temporal + audio attention",
    3: "speed + face-region control layers",
    4: "ControlNet dense conditioning branch",
    5: "VAE pretraining (recon + KL; the reference loads SD's pretrained "
       "VAE instead — this stage bootstraps one where no weights exist)",
}

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


def is_trainable(name: str, stage: int) -> bool:
    """The reference's predicate on one parameter name (dotted here,
    '/'-joined there; the tests hold the two partitions equal)."""
    check_stage(stage)
    top = name.split(".")[0]
    if stage == 0:
        return top in ("face_locator", "landmarker")  # the two face nets train together
    if stage == 4:
        return top == "controlnet"  # the ControlNet branch alone
    if stage == 5:
        return top == "vae"  # VAE pretraining: the autoencoder alone
    if top in _FROZEN_SUBMODELS:
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
    (an EMOModules: vae, reference_net, denoiser, audio_encoder,
    face_locator, landmarker, and the side models the config builds)."""
    return {name: is_trainable(name, stage) for name, _ in modules.named_parameters()}


def _clip_frames(batch: Batch, stage: int) -> Tuple[torch.Tensor, int]:
    """The clip the loss encodes, [B, T, H, W, 3] with any motion frames
    first, and the number of motion frames."""
    frames = batch["images"][:, None] if stage == 1 else batch["frames"]
    if stage >= 2 and "motion_frames" in batch:
        motion = batch["motion_frames"]
        return torch.cat([motion.to(frames.device), frames], dim=1), motion.shape[1]
    return frames, 0


def _vae_images(batch: Batch) -> torch.Tensor:
    """Stage 5's images [N, H, W, 3]: `images`, or every frame of `frames`."""
    if "images" in batch:
        return batch["images"]
    f = batch["frames"]
    return f.reshape(-1, *f.shape[-3:])


def sample_draws(config: Config, sched: Schedule, stage: int, batch: Batch,
                 generator: torch.Generator) -> Draws:
    """Every random number of one loss, drawn from `generator` on its device.
    Stage 0 draws none. Stage 5 draws the posterior noise `posterior_eps`
    [N, h, w, C] of its images. A denoise stage draws the posterior noise
    `posterior_eps` [B*T, h, w, C] (with train.vae_encode "sample"), `noise`
    [B, T, h, w, C], `noise_offset` [B, 1, 1, 1, 1] (with
    diffusion.noise_offset > 0), `timesteps` [B], and with
    train.uncond_ratio > 0 the reference-drop mask `ref_drop` [B] bool and,
    when the batch has audio, the audio-keep mask `audio_keep` [B, 1, 1, 1]
    (1 keeps the sample's audio)."""
    check_stage(stage)
    ds = config.vae.downscale
    dev = generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    uniform = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    draws: Draws = {}
    if stage == 0:
        return draws
    if stage == 5:
        n, height, width = _vae_images(batch).shape[:3]
        draws["posterior_eps"] = normal(n, height // ds, width // ds, config.vae.latent_channels)
        return draws
    frames, _ = _clip_frames(batch, stage)
    b, t, height, width = frames.shape[:4]
    lat = (height // ds, width // ds, config.vae.latent_channels)
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


def _block(shard: BatchShard, t: int):
    """x -> this rank's rows of x and, where a clip of t frames splits over
    the context ranks, its frames (axis 1)."""
    if shard.frames_split(t):
        return lambda x: shard.frames(shard.rows(x))
    return shard.rows


def downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel-space face mask [B, H, W, 1] -> latent resolution [B, 1, h, w, 1]
    (jax.image.resize, bilinear with antialiasing, as the reference)."""
    return resize_bilinear(mask.float(), h, w)[:, None]


def finish_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics of the whole batch from their sums over the data x context
    ranks: the parts of a ratio (module docstring) become the ratio, as the
    reference forms it over the whole batch; every other metric is the sum
    itself. A whole batch's metrics have no parts and pass unchanged."""
    out = {k: v for k, v in metrics.items() if "/" not in k}
    if "iou/inter" in metrics:
        out["iou"] = (metrics["iou/inter"] / metrics["iou/union"].clamp_min(1.0)).float()
    if "latent_std/count" in metrics:
        n = metrics["latent_std/count"]
        mean = metrics["latent_std/sum"] / n
        out["latent_std"] = (metrics["latent_std/sum_sq"] / n - mean * mean).clamp_min(0.0).sqrt().float()
    return out


def stage_loss_fn(model: EMOModel, config: Config, sched: Schedule, stage: int,
                  shard: Optional[BatchShard] = None) -> Callable[[Batch, Draws], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Returns loss(batch, draws) -> (loss, metrics), deterministic given the
    draws of `sample_draws`. `sched` lives on the model's device. shard:
    this rank's block of the batch (module docstring): the metrics are then
    shares and parts, to be summed over the data x context ranks and
    finished by `finish_metrics`; a whole batch's come finished."""
    check_stage(stage)
    dcfg, acfg, tcfg = config.diffusion, config.audio, config.train
    shard = shard or BatchShard()
    rows = shard.rows

    def facelocator_loss(batch: Batch, draws: Draws):
        images = rows(batch["images"])
        logits = model.locate_face(images)
        labels = rows(batch["masks"]).to(logits.device)
        bce = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
        iou_pred = (torch.sigmoid(logits) > 0.5).float()
        inter = (iou_pred * labels).sum()
        union = torch.maximum(iou_pred, labels).sum()
        copies = shard.ctx_size  # the context ranks that compute these rows
        loss = bce.sum() / (bce.numel() * shard.data_size * copies)
        metrics = {"loss": loss, "iou/inter": inter / copies, "iou/union": union / copies}
        if "landmarks" in batch:
            # joint 6-point landmark regression; items without landmarks
            # weigh 0 (landmarks_valid), over the whole batch's valid count
            lm_pred = model.locate_landmarks(images)
            per = ((lm_pred.float() - rows(batch["landmarks"]).to(lm_pred.device)) ** 2).mean(dim=(1, 2))  # [B]
            valid_all = batch.get("landmarks_valid")
            valid_all = (torch.ones(batch["images"].shape[0], device=per.device) if valid_all is None
                         else valid_all.to(per.device).float())
            valid = rows(valid_all)
            lm_err = (per * valid).sum() / valid_all.sum().clamp_min(1.0) / copies
            frac = valid.sum() / (valid_all.numel() * copies)
            loss = loss + 10.0 * lm_err
            metrics = dict(metrics, loss=loss, landmark_mse=lm_err, landmark_frac=frac)
        return loss, (finish_metrics(metrics) if shard.whole else metrics)

    def vae_loss(batch: Batch, draws: Draws):
        """L2 + L1 reconstruction of the posterior sample plus
        train.vae_kl_weight times the mean KL (summed over latent dims);
        latent_std, the population std of the posterior means, is reported
        to calibrate vae.scaling_factor."""
        imgs, eps = _vae_images(batch), draws["posterior_eps"]
        n_all, copies = imgs.shape[0], shard.ctx_size
        if "images" in batch:
            imgs, eps = rows(imgs), rows(eps)
        else:  # every frame of `frames`: this rank's rows, and its frames where they split
            b_all, t_all = batch["frames"].shape[:2]
            block = _block(shard, t_all)
            copies = 1 if shard.frames_split(t_all) else shard.ctx_size
            imgs = block(batch["frames"]).reshape(-1, *imgs.shape[1:])
            eps = block(eps.reshape(b_all, t_all, *eps.shape[1:])).reshape(-1, *eps.shape[1:])
        recon, dist = model.modules.vae(model._in(imgs), eps=eps)
        x = imgs.to(recon.device).float()
        recon = recon.float()
        # shares of the whole batch's means, and the std's parts
        share = imgs.shape[0] / (n_all * copies)
        rec_mse = ((recon - x) ** 2).mean() * share
        rec_l1 = (recon - x).abs().mean() * share
        kl = dist.kl().float().mean() * share
        m = dist.mean.detach().double()
        loss = rec_mse + rec_l1 + tcfg.vae_kl_weight * kl
        metrics = {"loss": loss, "recon_mse": rec_mse, "recon_l1": rec_l1, "kl": kl,
                   "latent_std/sum": m.sum() / copies, "latent_std/sum_sq": m.square().sum() / copies,
                   "latent_std/count": torch.tensor(m.numel() / copies, dtype=torch.float64, device=m.device)}
        return loss, (finish_metrics(metrics) if shard.whole else metrics)

    def denoise_loss(batch: Batch, draws: Draws):
        frames, num_motion = _clip_frames(batch, stage)
        b_all, t_all = frames.shape[:2]
        split = shard.frames_split(t_all)
        block = _block(shard, t_all)  # this rank's rows, and its frames where the clip splits
        t0 = shard.frame_range(t_all).start if split else 0
        # the context ranks that compute each of these rows: all of them where
        # the clip's frames stay whole
        copies = 1 if split else shard.ctx_size
        frames = block(frames)
        t = frames.shape[1]
        eps = None
        if tcfg.vae_encode == "sample":
            eps = draws["posterior_eps"]
            if not shard.whole:
                eps = block(eps.reshape(b_all, t_all, *eps.shape[1:])).reshape(-1, *eps.shape[1:])
        latents = model.encode_images(frames, eps=eps)
        ref_latent = model.encode_images(rows(batch["ref_image"]))
        noise = block(draws["noise"])
        if dcfg.noise_offset > 0:
            noise = noise + dcfg.noise_offset * rows(draws["noise_offset"])
        ts = rows(draws["timesteps"])
        noisy = add_noise(sched, latents, noise, ts)

        # CFG dropout of the reference (identity): the dropped rows attend to
        # themselves in place of the reference tokens
        ref_dropout = rows(draws["ref_drop"]) if tcfg.uncond_ratio > 0 else None

        identity_embed = None
        if config.model.use_identity_embed:
            # the frozen CLIP vision encoding of the reference image, dropped
            # with the reference: a zero embedding adds nothing through the
            # bias-free projection
            identity_embed = model.identity_embedding(rows(batch["ref_image"]))
            if ref_dropout is not None:
                identity_embed = identity_embed * (1.0 - ref_dropout.to(identity_embed.dtype))[:, None]

        audio_windows = None
        if stage >= 2 and "wav" in batch:
            feats = model.modules.audio_encoder(model._in(rows(batch["wav"])))
            # the wav starts `context_frames` before the un-primed clip; motion
            # frames sit num_motion frames earlier (their windows zero-pad);
            # a context shard's frames start t0 frames into the clip
            audio_windows = align_audio_to_frames(
                feats, t, audio_feature_rate(acfg), acfg.video_fps, acfg.context_frames,
                frame_offset=acfg.context_frames - num_motion + t0,
            )
            if tcfg.uncond_ratio > 0:
                audio_windows = audio_windows * rows(draws["audio_keep"]).to(audio_windows.dtype)

        speeds = block(batch.get("speeds")) if stage == 3 else None
        face_mask = rows(batch.get("masks")) if stage == 3 else None
        control_cond = batch.get("control") if stage == 4 else None
        if control_cond is not None:
            control_cond = block(control_cond) if control_cond.dim() == 5 else rows(control_cond)
        pred = model.predict_noise(noisy, ts, ref_latent, audio_windows=audio_windows, speeds=speeds,
                                   face_mask=face_mask, control_cond=control_cond, ref_dropout=ref_dropout,
                                   identity_embed=identity_embed, whole_clip=not split)
        target = noise if sched.prediction_type == "epsilon" else get_velocity(sched, latents, noise, ts)
        err = (pred.float() - target.float()) ** 2
        if num_motion > t0:
            err = err[:, num_motion - t0:]
        dims = tuple(range(1, err.dim()))
        w = min_snr_loss_weight(sched, ts, dcfg.snr_gamma)
        if shard.whole:
            per_sample = err.mean(dim=dims)
            loss = (w * per_sample).mean()
            mse = per_sample.mean()
        else:  # this block's share of the means over the whole batch
            per_sample = err.sum(dim=dims) / float((t_all - num_motion) * math.prod(err.shape[2:]))
            loss = (w * per_sample).sum() / (b_all * copies)
            mse = per_sample.sum() / (b_all * copies)
        metrics = {"loss": loss, "mse": mse}
        if stage == 3 and face_mask is not None:
            lm = downsample_mask(face_mask.to(err.device), latents.shape[2], latents.shape[3])
            lm_all = lm if shard.whole else downsample_mask(batch["masks"].to(err.device), *latents.shape[2:4])
            face_err = (err * lm).sum() / (lm_all.sum() * (t_all - num_motion) * err.shape[-1] + 1e-6) / copies
            loss = loss + tcfg.face_loss_weight * face_err
            metrics = {"loss": loss, "mse": metrics["mse"], "face_mse": face_err}
        return loss, metrics

    if stage == 0:
        return facelocator_loss
    if stage == 5:
        return vae_loss
    return denoise_loss

