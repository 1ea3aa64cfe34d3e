"""EMOPipeline: one reference image + audio -> talking-head video
(counterpart of emox/infer/pipeline.py).

  * per-clip prep: VAE-encode the reference, encode the audio, pre-encode
    the face mask once;
  * with a prompt (clip.text_enabled): the prompt and the negative prompt
    encoded once by the CLIP text encoder (`encode_prompt`);
  * one batched ReferenceNet writer pass for all sampler steps (with
    model.use_gn_ref, the AdaIN statistic banks too);
  * a DDIM loop. Each step runs one CFG-batched, fully conditioned
    predict_noise (uncond = no reference + zeroed audio + the negative
    prompt's context, in the same batch), or with
    inference.cfg_batching=False two calls, the uncond one with no
    reference branch at all. A clip of at most inference.context_frames
    frames is one window; a longer one is denoised in overlapping windows
    (diffusion/context.py), WINDOWS_PER_CALL of them folded into the batch
    of one call, their outputs averaged per frame;
  * motion-frame locking: the first `num_locked` frames re-noised from
    known latents at every step; `generate_long` chains segments so;
  * optional latent slerp interpolation, then VAE decode.

`invert` runs DDIM inversion of real frames. Identity embeddings and
ControlNet conditioning wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from emox_torch.core.config import Config
from emox_torch.data.tokenizer import CLIPTokenizer
from emox_torch.diffusion.context import window_plan
from emox_torch.diffusion.interp import interpolate_latents
from emox_torch.diffusion.sampler import cfg_combine, ddim_invert, windowed_model_out
from emox_torch.diffusion.schedule import add_noise, ddim_step, inference_timesteps, make_schedule
from emox_torch.models.emo import EMOModel

# Windows of one windowed denoise step folded into the batch of one
# predict_noise call. At 256^2 with CFG that is 4 x 16 x 2 = 128 frames a
# call (peak memory in PERF.md); a step with more windows makes more calls.
WINDOWS_PER_CALL = 4


class EMOPipeline:
    def __init__(self, model: EMOModel, config: Optional[Config] = None):
        self.model = model
        self.config = config or model.config
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
                   context=None, uncond_context=None, ref_features=None, ref_gn=None):
        """CFG-combined noise prediction. face_mask holds the PRE-ENCODED
        residual (EMOModel.encode_face_mask). The uncond branch sees no
        reference, zeroed audio and uncond_context in place of context:
        with inference.cfg_batching in the same batch (per-sample
        ref_dropout), else as a second call with ref_latent=None, which runs
        no writer and no AdaIN.

        With model.use_gn_ref the two programs are deliberately not equal:
        the batched one keeps style_fidelity of the uncond half's own
        statistics (the reference's uncond semantics), the two-call one runs
        a pure no-reference uncond (the style_fidelity=1 limit)."""
        if guidance_scale == 1.0:
            return self.model.predict_noise(latents, t, ref_latent, audio_windows=audio, speeds=speeds,
                                            face_feat=face_mask, context=context, ref_features=ref_features,
                                            ref_gn=ref_gn)
        if context is not None and uncond_context is None:
            raise ValueError(
                "prompt-conditioned CFG needs uncond_context (the empty-prompt embedding); "
                "use EMOPipeline.encode_prompt"
            )
        b = latents.shape[0]
        if not self.config.inference.cfg_batching:
            cond = self.model.predict_noise(latents, t, ref_latent, audio_windows=audio, speeds=speeds,
                                            face_feat=face_mask, context=context, ref_features=ref_features,
                                            ref_gn=ref_gn)
            uncond = self.model.predict_noise(latents, t, None,
                                              audio_windows=None if audio is None else torch.zeros_like(audio),
                                              speeds=speeds, face_feat=face_mask, context=uncond_context)
            return cfg_combine(uncond, cond, guidance_scale)
        cat = lambda x, y: torch.cat([x, y], dim=0)
        drop = torch.cat([torch.ones(b, dtype=torch.bool), torch.zeros(b, dtype=torch.bool)]).to(self.device)
        rf2 = None if ref_features is None else [[cat(x, x) for x in site] for site in ref_features]
        rg2 = None if ref_gn is None else [cat(x, x) for x in ref_gn]
        out = self.model.predict_noise(
            cat(latents, latents), cat(t, t), cat(ref_latent, ref_latent),
            audio_windows=None if audio is None else cat(torch.zeros_like(audio), audio),
            speeds=None if speeds is None else cat(speeds, speeds),
            face_feat=None if face_mask is None else cat(face_mask, face_mask),
            context=None if context is None else cat(uncond_context, context),
            ref_dropout=drop, ref_features=rf2, ref_gn=rg2,
        )
        return cfg_combine(out[:b], out[b:], guidance_scale)

    def _denoise_windows(self, windows, t, frame_idx, ref_latent, audio, speeds, face_mask, guidance_scale,
                         context, uncond_context, ref_features, ref_gn):
        """windows [W, B, c, h, w, C], frame_idx [W, c] -> CFG-combined
        outputs of the same shape. Up to WINDOWS_PER_CALL windows at a time
        are folded into the batch (window-major): their audio and speeds
        gathered along the frame axis, the per-clip conditioning (reference
        latent, face residual, writer and AdaIN banks, prompt context)
        repeated, one _model_out call per group."""
        b = windows.shape[1]
        outs = []
        for s in range(0, windows.shape[0], WINDOWS_PER_CALL):
            wl, wi = windows[s:s + WINDOWS_PER_CALL], frame_idx[s:s + WINDOWS_PER_CALL]
            n = wl.shape[0]
            fold = lambda x: x.reshape(n * b, *x.shape[2:])
            tile = lambda x: x if x is None or n == 1 else x.repeat(n, *(1,) * (x.dim() - 1))
            frames = lambda x: None if x is None else fold(x[:, wi].transpose(0, 1))
            out = self._model_out(
                fold(wl), tile(t), tile(ref_latent), frames(audio), frames(speeds), tile(face_mask),
                guidance_scale, context=tile(context), uncond_context=tile(uncond_context),
                ref_features=None if ref_features is None else [[tile(x) for x in site] for site in ref_features],
                ref_gn=None if ref_gn is None else [tile(x) for x in ref_gn],
            )
            outs.append(out.reshape(n, b, *out.shape[1:]))
        return torch.cat(outs)

    def _precompute_banks(self, ref_latent, ts):
        """One batched writer pass for all sampler steps: (ref_features,
        ref_gn), or (None, None) when disabled or no reference is in play."""
        if (not self.config.inference.precompute_ref_banks or ref_latent is None
                or not self.model.config.model.use_reference):
            return None, None
        return self.model.reference_outputs_for_steps(ref_latent, ts)

    # ---- sampler -----------------------------------------------------------
    def _sample(self, generator, ref_latent, audio, speeds, face_mask, num_frames, num_steps, guidance_scale,
                latents=None, lock_latents=None, num_locked=0, lock_noise=None, context=None,
                uncond_context=None, timings: Optional[Dict[str, float]] = None):
        """The DDIM loop: one window over the clip when num_frames <=
        inference.context_frames, else the overlapping windows of a
        WindowPlan. With lock_latents, the first num_locked frames are the
        known latents re-noised to each step's level (motion-frame
        continuation). Draws come from `generator` in the reference's order
        (the initial latents, then per step the lock re-noise and the eta
        noise); `latents` and `lock_noise` ([steps, *lock_latents.shape])
        inject the first two."""
        icfg = self.config.inference
        b, h, w, c = ref_latent.shape
        ts = inference_timesteps(self.sched.num_train_timesteps, num_steps)
        if latents is None:
            latents = torch.randn((b, num_frames, h, w, c), generator=generator, device=self.device,
                                  dtype=torch.float32)
        else:
            latents = torch.as_tensor(latents).to(device=self.device, dtype=torch.float32)
        locked = lock_latents is not None and num_locked > 0
        if locked:
            lock_latents = torch.as_tensor(lock_latents).to(device=self.device, dtype=torch.float32)
        plan = None
        if num_frames > icfg.context_frames:
            plan = window_plan(num_steps, num_frames, icfg.context_frames, icfg.context_stride,
                               icfg.context_overlap)
        mark = _Marks(self.device, timings)
        feats_all, gn_all = self._precompute_banks(ref_latent, ts)
        mark("ref_banks_s")
        eta = self.config.diffusion.ddim_eta
        steps = ts.tolist()
        for i, (t, t_prev) in enumerate(zip(steps, steps[1:] + [-1])):
            tb = torch.full((b,), t, dtype=torch.int64, device=self.device)
            if locked:
                noise = (torch.randn(lock_latents.shape, generator=generator, device=self.device,
                                     dtype=torch.float32)
                         if lock_noise is None else torch.as_tensor(lock_noise[i]).to(self.device, torch.float32))
                noised = add_noise(self.sched, lock_latents, noise, tb)
                latents = torch.cat([noised[:, :num_locked], latents[:, num_locked:]], dim=1)
            rf = None if feats_all is None else [[x[i] for x in site] for site in feats_all]
            rg = None if gn_all is None else [x[i] for x in gn_all]
            cond = (ref_latent, audio, speeds, face_mask, guidance_scale)
            if plan is None:
                out = self._model_out(latents, tb, *cond, context=context, uncond_context=uncond_context,
                                      ref_features=rf, ref_gn=rg)
            else:
                out = windowed_model_out(
                    lambda wl, tw, wi: self._denoise_windows(wl, tw, wi, *cond, context, uncond_context, rf, rg),
                    latents, tb, plan.indices[i], plan.weights[i])
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
                         lock_latents: Optional[torch.Tensor] = None,  # [B, T, h, w, C] known latents
                         num_locked: int = 0,
                         lock_noise: Optional[torch.Tensor] = None,  # [steps, B, T, h, w, C] re-noise draws
                         context: Optional[torch.Tensor] = None,  # [B, Lc, cross_dim] prompt embedding
                         uncond_context: Optional[torch.Tensor] = None,  # negative-prompt embedding (CFG)
                         timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """Latents [B, T, h, w, C] of a clip of video_length frames; speeds
        [B, T(, axes)] per frame. A clip longer than
        inference.context_frames takes the windowed sampler."""
        icfg = self.config.inference
        n_frames = video_length or icfg.video_length
        steps = num_inference_steps or icfg.num_inference_steps
        g = icfg.guidance_scale if guidance_scale is None else guidance_scale
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
        return self._sample(generator, ref_latent, audio, speeds, face_mask, n_frames, steps, g,
                            latents=latents, lock_latents=lock_latents, num_locked=num_locked,
                            lock_noise=lock_noise, context=context, uncond_context=uncond_context,
                            timings=timings)

    @torch.inference_mode()
    def __call__(self, ref_image: torch.Tensor, wav: torch.Tensor, video_length: Optional[int] = None,
                 num_inference_steps: Optional[int] = None, guidance_scale: Optional[float] = None,
                 speeds: Optional[torch.Tensor] = None, face_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, latents: Optional[torch.Tensor] = None,
                 interpolation_factor: Optional[int] = None, prompt: Optional[str] = None,
                 negative_prompt: str = "", tokenizer=None,
                 timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """Returns video frames [B, T', H, W, 3] in [-1, 1]: T' = T, or
        (T-1)*f + 1 with latent slerp interpolation by f =
        interpolation_factor (default inference.interpolation_factor).
        `prompt` is tokenized and CLIP-encoded, and the denoiser's text
        cross-attention reads it (the CFG uncond half reads
        `negative_prompt`; requires clip.text_enabled). `latents` injects the
        initial noise; `timings`, when given, is filled with the seconds of
        each phase (the device is synchronised at each phase boundary)."""
        mark = _Marks(self.device, timings)
        context = uncond_context = None
        if prompt is not None:
            context, uncond_context = self.encode_prompt(prompt, negative_prompt, tokenizer)
            mark("prompt_s")
        lat = self.generate_latents(ref_image, wav, video_length, num_inference_steps, guidance_scale,
                                    speeds, face_mask, generator, latents=latents, context=context,
                                    uncond_context=uncond_context, timings=timings)
        mark = _Marks(self.device, timings)
        f = interpolation_factor or self.config.inference.interpolation_factor
        if f > 1:
            lat = interpolate_latents(lat, f, mode="slerp")
        video = self.model.decode_latents(lat, chunk=self.config.inference.decode_chunk)
        mark("decode_s")
        return video

    @torch.inference_mode()
    def invert(self, video: torch.Tensor, ref_image: torch.Tensor, wav: torch.Tensor,
               num_inference_steps: Optional[int] = None) -> torch.Tensor:
        """DDIM inversion of real frames video [B, T, H, W, 3] in [-1, 1]
        into the model's noise space: latents [B, T, h, w, C] to sample back
        from (generate_latents(latents=...)). The denoiser is conditioned on
        the reference and the audio only: no CFG, no speeds, no face mask;
        the writer runs at every step."""
        steps = num_inference_steps or self.config.inference.num_inference_steps
        latents = self.model.encode_images(video).float()
        ref_latent, audio = self._prepare(ref_image, wav, video.shape[1])

        def denoise(lat, tb):
            return self.model.predict_noise(lat, tb, ref_latent, audio_windows=audio)

        return ddim_invert(denoise, latents, self.sched, steps)

    @torch.inference_mode()
    def generate_long(self, ref_image: torch.Tensor, wav: torch.Tensor, total_frames: int,
                      segment_length: int = 16, num_motion_frames: int = 2,
                      num_inference_steps: Optional[int] = None, guidance_scale: Optional[float] = None,
                      generator: Optional[torch.Generator] = None,
                      speeds: Optional[torch.Tensor] = None,  # [B, total_frames(, axes)]
                      face_mask: Optional[torch.Tensor] = None,  # [B, H, W, 1] static face region
                      prompt: Optional[str] = None, negative_prompt: str = "", tokenizer=None,
                      latents: Optional[Sequence[torch.Tensor]] = None,
                      lock_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                      timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """Autoregressive long-video generation: each segment after the first
        locks its first num_motion_frames latent frames to the previous
        segment's tail (re-noised at every step), and takes its slice of the
        audio (zero-padded past the end of wav) and of the speeds (zero-padded
        past their end). Returns the decoded video [B, total_frames, H, W, 3].
        `latents` and `lock_noise` hold one entry per segment (the first
        segment's lock noise is None) in place of the generator's draws."""
        icfg = self.config.inference
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(icfg.seed)
        sr = self.config.audio.sample_rate
        fps = self.config.audio.video_fps
        steps = num_inference_steps or icfg.num_inference_steps
        g = icfg.guidance_scale if guidance_scale is None else guidance_scale
        context = uncond_context = None
        if prompt is not None:
            context, uncond_context = self.encode_prompt(prompt, negative_prompt, tokenizer)
        wav = torch.as_tensor(wav).to(self.device)
        if speeds is not None:
            speeds = torch.as_tensor(speeds).to(self.device)
        segs: List[torch.Tensor] = []
        produced, prev_tail = 0, None
        while produced < total_frames:
            first = prev_tail is None
            seg = len(segs)
            new = min(segment_length - (0 if first else num_motion_frames), total_frames - produced)
            seg_frames = new + (0 if first else num_motion_frames)
            start_frame = produced - (0 if first else num_motion_frames)
            s0 = max(0, int(start_frame / fps * sr))
            s1 = int((start_frame + seg_frames) / fps * sr)
            wav_seg = wav.new_zeros((wav.shape[0], s1 - s0))
            wav_seg[:, : min(wav.shape[1], s1) - s0] = wav[:, s0: min(wav.shape[1], s1)]
            lock = None
            if not first:
                pad = prev_tail.new_zeros((prev_tail.shape[0], seg_frames - num_motion_frames, *prev_tail.shape[2:]))
                lock = torch.cat([prev_tail, pad], dim=1)
            seg_speeds = None
            if speeds is not None:
                pad_t = max(0, start_frame + seg_frames - speeds.shape[1])
                sp = speeds if pad_t == 0 else torch.cat(
                    [speeds, speeds.new_zeros((speeds.shape[0], pad_t, *speeds.shape[2:]))], dim=1)
                seg_speeds = sp[:, max(0, start_frame): max(0, start_frame) + seg_frames]
            lat = self.generate_latents(
                ref_image, wav_seg, video_length=seg_frames, num_inference_steps=steps, guidance_scale=g,
                speeds=seg_speeds, face_mask=face_mask, generator=generator,
                latents=None if latents is None else latents[seg],
                lock_latents=lock, num_locked=0 if first else num_motion_frames,
                lock_noise=None if lock_noise is None else lock_noise[seg],
                context=context, uncond_context=uncond_context, timings=timings,
            )
            segs.append(lat if first else lat[:, num_motion_frames:])
            prev_tail = lat[:, -num_motion_frames:]
            produced += new
        mark = _Marks(self.device, timings)
        video = self.model.decode_latents(torch.cat(segs, dim=1)[:, :total_frames], chunk=icfg.decode_chunk)
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
