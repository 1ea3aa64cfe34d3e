"""Quality metrics for generated clips (emox_torch.eval.metrics)."""

from emox_torch.eval.metrics import (
    audio_sync_score,
    evaluate_clip,
    frechet_distance,
    frame_audio_envelope,
    identity_similarity,
    mouth_openness,
    pearson,
    psnr,
    ssim,
    temporal_flicker,
)

__all__ = [
    "audio_sync_score",
    "evaluate_clip",
    "frechet_distance",
    "frame_audio_envelope",
    "identity_similarity",
    "mouth_openness",
    "pearson",
    "psnr",
    "ssim",
    "temporal_flicker",
]
