"""EMOPipeline: one reference image + audio -> talking-head video
(counterpart of emox/infer/pipeline.py, short clips).

  * per-clip prep: VAE-encode the reference, encode the audio, pre-encode
    the face mask once;
  * with a prompt (clip.text_enabled): the prompt and the negative prompt
    encoded once by the CLIP text encoder (`encode_prompt`);
  * one batched ReferenceNet writer pass for all sampler steps;
  * a DDIM loop, each step one CFG-batched, fully conditioned predict_noise
    (uncond = no reference + zeroed audio + the negative prompt's context,
    in the same batch);
  * VAE decode.

Clips longer than one context window (the windowed sampler), long-video
continuation, DDIM inversion, identity embeddings, latent interpolation
and the two-call CFG program wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from emox_torch.core.config import Config
from emox_torch.data.tokenizer import CLIPTokenizer
from emox_torch.diffusion.sampler import cfg_combine
from emox_torch.diffusion.schedule import ddim_step, inference_timesteps, make_schedule
from emox_torch.models.emo import EMOModel


class EMOPipeline:
    def __init__(self, model: EMOModel, config: Optional[Config] = None):
        self.model = model
        self.config = config or model.config
        if not self.config.inference.cfg_batching:
            raise NotImplementedError(
                "inference.cfg_batching=False (two-call CFG) waits for a later slice of the port (ROADMAP.md)"
            )
        self.device = model.device
        self.sched = make_schedule(self.config.diffusion, device=self.device)

    # ---- conditioning ----------------------------------------------------
    def _prepare(self, ref_image: torch.Tensor, wav: torch.Tensor, num_frames: int):
        return self.model.encode_images(ref_image), self.model.encode_audio(wav, num_frames)

    def encode_prompt(self, prompt: str, negative_prompt: str = "", tokenizer=None):
        """Prompt strings -> (context, uncond_context) CLIP embeddings: the
        prompt and the negative (by default empty) prompt for the CFG uncond
        half. Requires clip.text_enabled."""
        if tokenizer is None:
            tokenizer = self._default_tokenizer = getattr(self, "_default_tokenizer", None) or CLIPTokenizer()
        ml = min(self.config.clip.max_positions, 77)
        ids = tokenizer.encode([prompt], max_length=ml)
        uids = tokenizer.encode([negative_prompt], max_length=ml)
        vs = self.config.clip.vocab_size
        hi = int(max(ids.max(), uids.max()))
        if hi >= vs:
            raise ValueError(
                f"tokenizer produced id {hi} but clip.vocab_size={vs}; the "
                f"tokenizer vocabulary does not match this model's text encoder"
            )
        return self.model.encode_text(torch.from_numpy(ids)), self.model.encode_text(torch.from_numpy(uids))

    def _model_out(self, latents, t, ref_latent, audio, speeds, face_mask, guidance_scale,
                   context=None, uncond_context=None, ref_features=None):
        """CFG-combined noise prediction for the full latent clip. face_mask
        holds the PRE-ENCODED residual (EMOModel.encode_face_mask). With
        guidance, the uncond half runs in the same batch with no reference
        (per-sample ref_dropout), zeroed audio and uncond_context in place
        of context."""
        if guidance_scale == 1.0:
            return self.model.predict_noise(latents, t, ref_latent, audio_windows=audio, speeds=speeds,
                                            face_feat=face_mask, context=context, ref_features=ref_features)
        if context is not None and uncond_context is None:
            raise ValueError(
                "prompt-conditioned CFG needs uncond_context (the empty-prompt embedding); "
                "use EMOPipeline.encode_prompt"
            )
        b = latents.shape[0]
        cat = lambda x, y: torch.cat([x, y], dim=0)
        drop = torch.cat([torch.ones(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool)]).to(self.device)
        rf2 = None if ref_features is None else [[cat(x, x) for x in site] for site in ref_features]
        out = self.model.predict_noise(
            cat(latents, latents), cat(t, t), cat(ref_latent, ref_latent),
            audio_windows=None if audio is None else cat(torch.zeros_like(audio), audio),
            speeds=None if speeds is None else cat(speeds, speeds),
            face_feat=None if face_mask is None else cat(face_mask, face_mask),
            context=None if context is None else cat(uncond_context, context),
            ref_dropout=drop, ref_features=rf2,
        )
        return cfg_combine(out[:b], out[b:], guidance_scale)

    def _precompute_banks(self, ref_latent, ts):
        """One batched writer pass for all sampler steps; None when disabled
        or no reference is in play."""
        if (not self.config.inference.precompute_ref_banks or ref_latent is None
                or not self.model.config.model.use_reference):
            return None
        return self.model.reference_outputs_for_steps(ref_latent, ts)[0]

    # ---- sampler -----------------------------------------------------------
    def _sample_short(self, generator, ref_latent, audio, speeds, face_mask, num_frames, num_steps,
                      guidance_scale, latents=None, context=None, uncond_context=None,
                      timings: Optional[Dict[str, float]] = None):
        """Single-window DDIM loop. The initial latents are drawn from
        `generator` (the counterpart of the reference's PRNG key) unless
        given."""
        b, h, w, c = ref_latent.shape
        ts = inference_timesteps(self.sched.num_train_timesteps, num_steps)
        if latents is None:
            latents = torch.randn((b, num_frames, h, w, c), generator=generator, device=self.device,
                                  dtype=torch.float32)
        else:
            latents = torch.as_tensor(latents).to(device=self.device, dtype=torch.float32)
        mark = _Marks(self.device, timings)
        feats_all = self._precompute_banks(ref_latent, ts)
        mark("ref_banks_s")
        eta = self.config.diffusion.ddim_eta
        steps = ts.tolist()
        for i, (t, t_prev) in enumerate(zip(steps, steps[1:] + [-1])):
            tb = torch.full((b,), t, dtype=torch.int64, device=self.device)
            rf = None if feats_all is None else [[x[i] for x in site] for site in feats_all]
            out = self._model_out(latents, tb, ref_latent, audio, speeds, face_mask, guidance_scale,
                                  context=context, uncond_context=uncond_context, ref_features=rf)
            latents = ddim_step(self.sched, out, latents, tb,
                                torch.full((b,), t_prev, dtype=torch.int64, device=self.device),
                                eta=eta, generator=generator if eta > 0 else None)
        mark("denoise_s")
        return latents

    # ---- public API ------------------------------------------------------
    @torch.inference_mode()
    def generate_latents(self, ref_image: torch.Tensor, wav: torch.Tensor,
                         video_length: Optional[int] = None, num_inference_steps: Optional[int] = None,
                         guidance_scale: Optional[float] = None, speeds: Optional[torch.Tensor] = None,
                         face_mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         latents: Optional[torch.Tensor] = None,
                         context: Optional[torch.Tensor] = None,  # [B, Lc, cross_dim] prompt embedding
                         uncond_context: Optional[torch.Tensor] = None,  # negative-prompt embedding (CFG)
                         timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        icfg = self.config.inference
        n_frames = video_length or icfg.video_length
        steps = num_inference_steps or icfg.num_inference_steps
        g = icfg.guidance_scale if guidance_scale is None else guidance_scale
        if n_frames > icfg.context_frames:
            raise NotImplementedError(
                f"{n_frames} frames > inference.context_frames={icfg.context_frames}: the windowed "
                "sampler waits for a later slice of the port (ROADMAP.md)"
            )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(icfg.seed)
        mark = _Marks(self.device, timings)
        ref_latent, audio = self._prepare(ref_image, wav, n_frames)
        mark("prepare_s")
        if face_mask is not None and self.model.config.model.use_face_mask:
            face_mask = self.model.encode_face_mask(face_mask, ref_latent.shape[1])
        if speeds is not None:
            speeds = torch.as_tensor(speeds).to(self.device)
        mark("face_mask_s")
        return self._sample_short(generator, ref_latent, audio, speeds, face_mask, n_frames, steps, g,
                                  latents=latents, context=context, uncond_context=uncond_context,
                                  timings=timings)

    @torch.inference_mode()
    def __call__(self, ref_image: torch.Tensor, wav: torch.Tensor, video_length: Optional[int] = None,
                 num_inference_steps: Optional[int] = None, guidance_scale: Optional[float] = None,
                 speeds: Optional[torch.Tensor] = None, face_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, latents: Optional[torch.Tensor] = None,
                 interpolation_factor: Optional[int] = None, prompt: Optional[str] = None,
                 negative_prompt: str = "", tokenizer=None,
                 timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """Returns video frames [B, T, H, W, 3] in [-1, 1]. `prompt` is
        tokenized and CLIP-encoded, and the denoiser's text cross-attention
        reads it (the CFG uncond half reads `negative_prompt`; requires
        clip.text_enabled). `latents` injects the initial noise; `timings`,
        when given, is filled with the seconds of each phase (the device is
        synchronised at each phase boundary)."""
        f = interpolation_factor or self.config.inference.interpolation_factor
        if f > 1:
            raise NotImplementedError("latent interpolation waits for a later slice of the port (ROADMAP.md)")
        mark = _Marks(self.device, timings)
        context = uncond_context = None
        if prompt is not None:
            context, uncond_context = self.encode_prompt(prompt, negative_prompt, tokenizer)
            mark("prompt_s")
        lat = self.generate_latents(ref_image, wav, video_length, num_inference_steps, guidance_scale,
                                    speeds, face_mask, generator, latents=latents, context=context,
                                    uncond_context=uncond_context, timings=timings)
        mark = _Marks(self.device, timings)
        video = self.model.decode_latents(lat, chunk=self.config.inference.decode_chunk)
        mark("decode_s")
        return video


class _Marks:
    """Phase timer for EMOPipeline(timings=...): a no-op without a dict."""

    def __init__(self, device: torch.device, timings: Optional[Dict[str, float]]):
        self.device, self.timings = device, timings
        self.t0 = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.timings is not None:
            now = self._now()
            self.timings[name] = self.timings.get(name, 0.0) + now - self.t0
            self.t0 = now
