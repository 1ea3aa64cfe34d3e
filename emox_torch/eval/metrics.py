"""Quality metrics for generated talking-head video (counterpart of
emox/eval/metrics.py), in torch on the tensors' device, float32:

- reconstruction fidelity: PSNR and windowed SSIM (an 11x11 Gaussian
  window as a depthwise convolution);
- temporal stability: the mismatch of frame-to-frame deltas against the
  ground truth;
- identity preservation: cosine similarity of per-frame identity
  embeddings (EMOModel.encode_image_embedding) to the reference image's;
- audio-visual sync: the correlation of a mouth-openness series with the
  per-frame audio envelope;
- a latent Fréchet distance between Gaussian fits of two feature sets.

Frames are [T, H, W, C] in [-1, 1]; numpy arrays are taken as they are.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from emox_torch.core.device import resolve_device

__all__ = [
    "psnr",
    "ssim",
    "temporal_flicker",
    "frame_audio_envelope",
    "mouth_openness",
    "pearson",
    "audio_sync_score",
    "identity_similarity",
    "frechet_distance",
    "evaluate_clip",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr(pred, target, data_range: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over all elements, capped at 100 dB
    (identical inputs stay finite)."""
    mse = torch.mean((_f32(pred) - _f32(target)) ** 2)
    mse = torch.clamp_min(mse, (data_range ** 2) * 1e-10)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel(window: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(window, dtype=torch.float32, device=device) - (window - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]  # [w, w]


def _depthwise_blur(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] valid-padded depthwise filter."""
    c = x.shape[-1]
    w = kernel2d[None, None].expand(c, 1, *kernel2d.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), w, groups=c).permute(0, 2, 3, 1)


def ssim(pred, target, data_range: float = 2.0, data_min: float = -1.0, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity (Wang et al. 2004 constants) over
    [T, H, W, C] (or [H, W, C]) frames with a Gaussian 11x11 window; H and W
    at least the window. The frames are rescaled to [0, 1] by (x - data_min)
    / data_range first, where the luminance term is defined, and scored
    with L = 1."""
    pred, target = _f32(pred), _f32(target)
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    x = (pred - data_min) / data_range
    y = (target - data_min) / data_range
    kern = _gaussian_kernel(window, sigma, x.device)
    mu_x = _depthwise_blur(x, kern)
    mu_y = _depthwise_blur(y, kern)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _depthwise_blur(x * x, kern) - mu_xx
    sig_y = _depthwise_blur(y * y, kern) - mu_yy
    sig_xy = _depthwise_blur(x * y, kern) - mu_xy
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu_xy + c1) * (2.0 * sig_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sig_x + sig_y + c2)
    return torch.mean(num / den)


def temporal_flicker(pred, target) -> torch.Tensor:
    """Mean squared mismatch of consecutive-frame deltas, [T, H, W, C]: 0 when
    the motion is reproduced exactly, large when the output strobes or
    freezes. Lower is better."""
    p, t = _f32(pred), _f32(target)
    return torch.mean(((p[1:] - p[:-1]) - (t[1:] - t[:-1])) ** 2)


def frame_audio_envelope(wav, num_frames: int, samples_per_frame: int) -> torch.Tensor:
    """Per-video-frame RMS amplitude of the waveform -> [T], max-normalised
    (the envelope the synthetic fixtures drive the mouth with)."""
    wav = _f32(wav)
    need = num_frames * samples_per_frame
    wav = torch.cat([wav, wav.new_zeros(max(0, need - wav.shape[0]))])[:need]
    env = torch.sqrt(torch.mean(wav.reshape(num_frames, samples_per_frame) ** 2, dim=1))
    return env / torch.clamp_min(torch.max(env), 1e-8)


def mouth_openness(frames, masks) -> torch.Tensor:
    """Mouth-openness proxy -> [T]: the mean darkness (negative luminance)
    over the lower half of the face region, the face mask gated below its
    own row centroid in each frame."""
    x, m = _f32(frames), _f32(masks)
    if m.dim() == 3:
        m = m[..., None]
    h = x.shape[1]
    rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None, None]  # [1, H, 1, 1]
    denom = torch.clamp_min(torch.sum(m, dim=(1, 2, 3), keepdim=True), 1e-6)
    cy = torch.sum(m * rows, dim=(1, 2, 3), keepdim=True) / denom  # [T, 1, 1, 1]
    lower = m * (rows > cy)
    lum = torch.mean(x, dim=-1, keepdim=True)  # [-1, 1]
    w = torch.clamp_min(torch.sum(lower, dim=(1, 2, 3)), 1e-6)
    return -torch.sum(lum * lower, dim=(1, 2, 3)) / w


def pearson(a, b) -> torch.Tensor:
    """Pearson correlation of two 1-D series (0 when either is constant)."""
    a, b = _f32(a), _f32(b)
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    denom = torch.sqrt(torch.sum(a ** 2) * torch.sum(b ** 2))
    r = torch.sum(a * b) / torch.clamp_min(denom, 1e-8)
    return torch.where(denom > 1e-8, r, torch.zeros_like(r))


def audio_sync_score(frames, masks, wav, fps: float = 25.0, sample_rate: int = 16000) -> torch.Tensor:
    """Audio-visual sync in [-1, 1]: the Pearson correlation of the
    mouth-openness series with the per-frame audio envelope."""
    t = frames.shape[0]
    spf = int(sample_rate / fps)
    return pearson(mouth_openness(frames, masks), frame_audio_envelope(wav, t, spf))


def identity_similarity(frame_embeds, ref_embed) -> torch.Tensor:
    """Mean cosine similarity of per-frame identity embeddings [T, D] to the
    reference image's [D] (or [1, D])."""
    fe = _f32(frame_embeds)
    re = _f32(ref_embed).reshape(-1)
    fe = fe / torch.clamp_min(torch.linalg.vector_norm(fe, dim=-1, keepdim=True), 1e-8)
    re = re / torch.clamp_min(torch.linalg.vector_norm(re), 1e-8)
    return torch.mean(fe @ re)


def frechet_distance(feats_a, feats_b, eps: float = 1e-6) -> torch.Tensor:
    """Fréchet distance between Gaussian fits of two feature sets [N, ...]
    (each flattened per row): |mu_a - mu_b|^2 + tr(Ca) + tr(Cb) - 2
    tr((Ca^1/2 Cb Ca^1/2)^1/2), the square roots from eigh/eigvalsh with
    negative eigenvalues clipped to 0; eps on both diagonals. The float32
    features are fitted in float64 and the distance returned in float32: with
    few samples (N <= D) the covariances are singular and their square roots
    amplify float32 rounding (the reference's float32 result is then off by
    up to 1e-4 relative)."""
    if feats_a.shape[0] < 2 or feats_b.shape[0] < 2:
        raise ValueError(f"frechet_distance needs >= 2 frames per set to fit a gaussian, "
                         f"got {feats_a.shape[0]} vs {feats_b.shape[0]}")
    a = _f32(feats_a).reshape(feats_a.shape[0], -1).double()
    b = _f32(feats_b).reshape(feats_b.shape[0], -1).double()
    eye = torch.eye(a.shape[1], dtype=torch.float64, device=a.device)
    ca = torch.cov(a.T) + eps * eye
    cb = torch.cov(b.T) + eps * eye
    diff = torch.sum((a.mean(0) - b.mean(0)) ** 2)
    ev_a, u = torch.linalg.eigh(ca)
    sqrt_a = (u * torch.sqrt(torch.clamp_min(ev_a, 0.0))) @ u.T
    ev = torch.linalg.eigvalsh(sqrt_a @ cb @ sqrt_a)
    tr_sqrt = torch.sum(torch.sqrt(torch.clamp_min(ev, 0.0)))
    return (diff + torch.trace(ca) + torch.trace(cb) - 2.0 * tr_sqrt).float()


def evaluate_clip(gen: np.ndarray, gt: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
                  wav: Optional[np.ndarray] = None, fps: float = 25.0, sample_rate: int = 16000,
                  device: Optional[torch.device] = None) -> Dict[str, float]:
    """Every metric the inputs allow, as plain floats. gen/gt: [T, H, W, 3]
    in [-1, 1]; masks: [T, H, W, 1]; wav: [S]. With gt: psnr_db, ssim and
    temporal_flicker. With masks and wav: audio_sync (and gt_audio_sync, the
    achievable anchor, when gt is given too). device: where to compute; the
    CUDA card unless the caller names another (raises without one)."""
    device = resolve_device(device)
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    out: Dict[str, float] = {}
    g = put(gen)
    t = None
    if gt is not None:
        t = put(gt)
        if t.shape != g.shape:
            raise ValueError(f"gen {tuple(g.shape)} vs gt {tuple(t.shape)}: shapes must match (resize first)")
        out["psnr_db"] = float(psnr(g, t))
        out["ssim"] = float(ssim(g, t))
        out["temporal_flicker"] = float(temporal_flicker(g, t))
    if masks is not None and wav is not None:
        m, w = put(masks), put(wav)
        out["audio_sync"] = float(audio_sync_score(g, m, w, fps, sample_rate))
        if t is not None:
            out["gt_audio_sync"] = float(audio_sync_score(t, m, w, fps, sample_rate))
    return out
