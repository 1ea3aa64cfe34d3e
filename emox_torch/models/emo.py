"""EMOModel: the full composition (counterpart of emox/models/emo.py).

VAE + ReferenceNet (writer) + denoising UNet (reader) + audio encoder +
face locator and landmarker, as nn.Modules held by one object. Where the
reference's methods take a param tree, these take only inputs: the weights
live in the modules (random from a seed, or carried over from a flax param
tree with `load_flax`).

Every parameter starts frozen. The methods a training loss calls
(`encode_images`, `encode_audio`, `reference_outputs`, `predict_noise`,
`locate_face`, `locate_landmarks`) run with autograd as the caller has it,
so they take a gradient once `set_trainable` has marked leaves; the serving
calls (`EMOPipeline`, and here `decode_latents`,
`reference_outputs_for_steps`, `encode_face_mask`) run under
`torch.inference_mode`.

The side models are built where the config enables them:
  * clip.text_enabled: the CLIP text encoder (`clip_text`); `encode_text`
    turns prompt ids into the context the denoiser's text cross-attention
    reads (`predict_noise(context=...)`);
  * clip.vision_enabled: the CLIP vision encoder (`clip_vision`);
    `encode_image_embedding` turns CLIP-normalised images into the identity
    embedding that model.use_identity_embed adds to the denoiser's time
    embedding (`predict_noise(identity_embed=...)`);
  * model.use_controlnet: the ControlNet (`controlnet`), run inside
    `predict_noise(control_cond=...)` on the same noisy latents and
    timesteps as the denoiser, whose skips take its residuals.

On a mesh (`mesh=`, or `distribute`), every rank holds rank 0's weights,
the tensor-parallel leaves sliced to its shard of the `model` axis
(emox_torch.comm.sharding), and with a `context` axis of more than one rank
the denoiser's temporal attention runs as ring attention over it, and its
sparse-causal self-attention (model.use_sparse_causal) takes the first and
previous frames from the other context ranks: its calls then take this
rank's block of each clip's frames, or with `whole_clip` every frame of
them (clips whose frames do not divide by the context size). A model driven
through the windowed sampler is built without the ring (the sampler
splits whole windows over `context` instead, EMOPipeline(mesh=...)).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from emox_torch.core.config import Config
from emox_torch.core.device import resolve_device
from emox_torch.models.audio import AudioEncoder, align_audio_to_frames, audio_feature_rate
from emox_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder, clip_normalize
from emox_torch.models.controlnet import ControlNetEncoder
from emox_torch.models.unet import UNet, UNetOutputs, reference_net_config
from emox_torch.models.vae import AutoencoderKL
from emox_torch.nn.conditioners import FaceLandmarkNet, FaceLocator
from emox_torch.nn.layers import init_weights, resize_bilinear

Banks = List[List[torch.Tensor]]


def _row_major(shape) -> Tuple[int, ...]:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def _check_config(config: Config) -> None:
    if config.model.use_identity_embed and not config.clip.vision_enabled:
        raise ValueError(
            "model.use_identity_embed=True needs clip.vision_enabled=True: the identity embedding is "
            "the CLIP-vision encoding of the reference image"
        )


class EMOModules(nn.Module):
    """The submodels, under the names of the reference's param tree."""

    def __init__(self, config: Config):
        super().__init__()
        face_downs = max(0, config.vae.downscale.bit_length() - 1)
        self.vae = AutoencoderKL(config.vae)
        self.reference_net = UNet(reference_net_config(config.model), face_mask_downs=face_downs)
        self.denoiser = UNet(config.model, face_mask_downs=face_downs, identity_dim=config.clip.projection_dim)
        self.audio_encoder = AudioEncoder(config.audio)
        self.clip_text = CLIPTextEncoder(config.clip) if config.clip.text_enabled else None
        self.face_locator = FaceLocator()
        self.landmarker = FaceLandmarkNet()
        self.controlnet = (ControlNetEncoder(config.model, cond_num_downs=face_downs)
                           if config.model.use_controlnet else None)
        self.clip_vision = CLIPVisionEncoder(config.clip) if config.clip.vision_enabled else None


class EMOModel:
    def __init__(self, config: Config, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0, mesh=None):
        """Builds the submodels on `device` (the CUDA card unless told
        otherwise; raises when there is none) with random weights drawn from
        `seed` (the port's own init), held in `dtype`; with `mesh`, placed on
        it (`distribute`)."""
        _check_config(config)
        self.config = config
        self.mesh = None
        self.tp = None  # the tensor-parallel plan applied (emox_torch.comm.sharding.TensorParallel)
        self.device = resolve_device(device)
        self.dtype = dtype
        with torch.device(self.device):
            self.modules = EMOModules(config)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_weights(self.modules, gen)
        self.modules.to(dtype=dtype)
        if self.device.type == "cuda":
            self.modules.to(memory_format=torch.channels_last)  # conv kernels as cuDNN reads them
        self.modules.eval().requires_grad_(False)
        if mesh is not None:
            self.distribute(mesh)

    def distribute(self, mesh) -> "EMOModel":
        """Place the model on `mesh`: rank 0's parameters broadcast to every
        rank, the tensor-parallel leaves sliced (`self.tp`), and with a
        context axis of more than one rank the ring on the denoiser's
        temporal attention and the frame exchange on its sparse-causal
        self-attention."""
        from emox_torch.comm.sharding import apply_tensor_parallel
        from emox_torch.core.mesh import MeshAxes, axis_size, shard_params_replicated

        if self.mesh is not None:
            raise ValueError("the model is already placed on a mesh")
        if mesh is None:
            return self
        ring = axis_size(mesh, MeshAxes.CONTEXT) > 1
        shard_params_replicated(list(self.modules.parameters()), mesh)
        self.tp = apply_tensor_parallel(self.modules, mesh)
        if ring:
            self.modules.denoiser.set_ring(mesh)
        self.mesh = mesh
        return self

    @property
    def ring(self) -> bool:
        """Whether the denoiser's calls take this rank's block of the frames."""
        from emox_torch.core.mesh import MeshAxes, axis_size

        return self.mesh is not None and axis_size(self.mesh, MeshAxes.CONTEXT) > 1

    def load_flax(self, params: Dict[str, Any]) -> "EMOModel":
        """Load a reference param tree (nested dicts of numpy arrays) into the
        submodels; every leaf must map and every parameter must be set."""
        from emox_torch.interop.from_flax import load_flax

        load_flax(self.modules, params)
        return self

    def set_trainable(self, mask: Dict[str, bool]) -> None:
        """requires_grad on the parameters that `mask` (parameter name ->
        bool, every parameter named) marks True; the others stay frozen."""
        params = dict(self.modules.named_parameters())
        if set(mask) != set(params):
            raise ValueError(f"the mask names {len(mask)} parameters, the model has {len(params)}")
        for name, p in params.items():
            p.requires_grad_(bool(mask[name]))

    def train(self, mode: bool = True) -> "EMOModel":
        """Train (or eval) mode on every submodel."""
        self.modules.train(mode)
        return self

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """x on the model's device in its dtype, with the row-major strides of
        its shape. cuDNN picks a convolution's algorithm by its input's
        strides, those of size-1 dims included (numpy's x[None] has stride 0
        there), and the algorithms round differently: equal inputs must not
        differ in them."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        return x if x.stride() == _row_major(x.shape) else x.clone(memory_format=torch.contiguous_format)

    # ---- submodel applies --------------------------------------------------
    def encode_images(self, images: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[..., H, W, 3] in [-1,1] -> scaled latents [..., h, w, 4]: the
        posterior mode, or with `eps` (N(0, 1) noise of the flattened
        posterior's shape [prod(...), h, w, 4], drawn by the caller) the
        posterior sample mean + std * eps."""
        images = self._in(images)
        shape = images.shape
        dist = self.modules.vae.encode(images.reshape(-1, *shape[-3:]))
        z = dist.mode() if eps is None else dist.sample(eps)
        z = z * self.config.vae.scaling_factor
        return z.reshape(*shape[:-3], *z.shape[-3:])

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor, chunk: int = 0) -> torch.Tensor:
        """Latents -> images; chunk > 0 decodes that many frames at a time."""
        latents = torch.as_tensor(latents).to(self.device)
        shape = latents.shape
        flat = latents.reshape(-1, *shape[-3:]) / self.config.vae.scaling_factor  # the VAE casts
        n = flat.shape[0]
        if chunk and n > chunk:
            img = torch.cat([self.modules.vae.decode(z) for z in flat.split(chunk)])
        else:
            img = self.modules.vae.decode(flat)
        return img.reshape(*shape[:-3], *img.shape[-3:])

    def reference_outputs(self, ref_latent: torch.Tensor, timesteps: torch.Tensor) -> UNetOutputs:
        """Writer pass: UNetOutputs with ref_features (the K/V banks) and,
        with model.use_gn_ref, ref_gn (the AdaIN statistic banks)."""
        return self.modules.reference_net(self._in(ref_latent), timesteps.to(self.device), emit_ref=True)

    @torch.inference_mode()
    def reference_outputs_for_steps(self, ref_latent: torch.Tensor,
                                    timesteps_vec: torch.Tensor) -> Tuple[Banks, Optional[List[torch.Tensor]]]:
        """Writer banks for ALL S sampler timesteps in ONE batched [S*B] pass
        (the writer depends only on (ref_latent, t)). Returns (ref_features,
        ref_gn) with a leading S axis on every bank; ref_gn (the AdaIN
        statistics) is None unless model.use_gn_ref."""
        ref_latent = self._in(ref_latent)
        s = timesteps_vec.shape[0]
        b = ref_latent.shape[0]
        tiled = ref_latent[None].expand(s, *ref_latent.shape).reshape(s * b, *ref_latent.shape[1:])
        out = self.reference_outputs(tiled, timesteps_vec.to(self.device).repeat_interleave(b))
        feats = [[x.reshape(s, b, *x.shape[1:]) for x in site] for site in out.ref_features]
        gn = None if out.ref_gn is None else [x.reshape(s, b, *x.shape[1:]) for x in out.ref_gn]
        return feats, gn

    def encode_audio(self, wav: torch.Tensor, num_frames: int) -> torch.Tensor:
        cfg = self.config.audio
        feats = self.modules.audio_encoder(self._in(wav))
        return align_audio_to_frames(feats, num_frames, audio_feature_rate(cfg), cfg.video_fps, cfg.context_frames)

    def locate_face(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> face-region logits [B, H, W, 1]."""
        return self.modules.face_locator(self._in(images))

    def locate_landmarks(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> [B, 6, 2] normalised (y, x) landmarks."""
        return self.modules.landmarker(self._in(images))

    @torch.inference_mode()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP token ids [B, L] -> per-token embeddings [B, L, C], the
        context of the denoiser's text cross-attention."""
        if self.modules.clip_text is None:
            raise ValueError("clip.text_enabled is False in this config")
        return self.modules.clip_text(torch.as_tensor(input_ids).to(self.device).long())

    def encode_image_embedding(self, images: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised images [B, H, W, 3] -> the projected identity
        embedding [B, proj]."""
        if self.modules.clip_vision is None:
            raise ValueError("clip.vision_enabled is False in this config")
        return self.modules.clip_vision(self._in(images))

    def identity_embedding(self, ref_image: torch.Tensor) -> torch.Tensor:
        """Reference image [B, H, W, 3] in [-1, 1] -> the identity embedding
        [B, proj]: mapped to [0, 1] in float32, resized to clip.image_size as
        jax.image.resize does (antialiased when it shrinks), normalised,
        encoded."""
        size = self.config.clip.image_size
        x01 = (torch.as_tensor(ref_image).to(self.device).float() + 1.0) * 0.5
        return self.encode_image_embedding(clip_normalize(resize_bilinear(x01, size, size)))

    @torch.inference_mode()
    def encode_face_mask(self, face_mask: torch.Tensor, latent_size: int) -> torch.Tensor:
        """Pre-encode the face-region mask residual once per clip; pass the
        result as predict_noise(face_feat=...)."""
        face_mask = self._in(face_mask)
        ds = face_mask.shape[1] // latent_size
        enc = self.modules.denoiser.face_mask_encoder
        if max(0, ds.bit_length() - 1) != enc.num_downs:
            raise ValueError(f"face mask {face_mask.shape[1]}px does not match latent size {latent_size}")
        return enc(face_mask)

    # ---- the denoise step ----------------------------------------------------
    def predict_noise(
        self,
        noisy_latents: torch.Tensor,  # [B, T, h, w, 4]
        timesteps: torch.Tensor,  # [B]
        ref_latent: Optional[torch.Tensor],  # [B, h, w, 4]; None = no reference branch
        audio_windows: Optional[torch.Tensor] = None,  # [B, T, A, D]
        speeds: Optional[torch.Tensor] = None,  # [B, T] or [B, T, axes]
        face_mask: Optional[torch.Tensor] = None,  # [B, H, W, 1]
        context: Optional[torch.Tensor] = None,  # [B, Lc, cross_dim] CLIP text tokens
        control_cond: Optional[torch.Tensor] = None,  # [B(, T), H, W, Cc] pixel space
        control_scale: float = 1.0,
        ref_dropout: Optional[torch.Tensor] = None,  # [B] bool, True = sample sees no ref
        identity_embed: Optional[torch.Tensor] = None,  # [B, proj] CLIP image embedding
        ref_features: Optional[Banks] = None,  # precomputed writer banks
        ref_gn: Optional[List[torch.Tensor]] = None,  # precomputed AdaIN banks (model.use_gn_ref)
        face_feat: Optional[torch.Tensor] = None,  # pre-encoded mask residual
        whole_clip: bool = False,
    ) -> torch.Tensor:
        """ref_latent=None runs no reference branch at all (the two-call CFG's
        uncond program); ref_dropout drops the reference per sample inside
        one batch. Without ref_features the writer runs here, and its banks
        (and AdaIN statistics) replace ref_gn. With a ControlNet and
        control_cond, the ControlNet runs on the same noisy latents and
        timesteps, its residuals scaled by control_scale. whole_clip: on a
        context mesh, the latents hold every frame of their clips (the
        one-rank temporal and sparse-causal attention), not this rank's
        block."""
        timesteps = timesteps.to(self.device)
        ref_feats = ref_features
        if ref_latent is not None and ref_feats is None:
            rout = self.reference_outputs(ref_latent, timesteps)
            ref_feats, ref_gn = rout.ref_features, rout.ref_gn
        opt = lambda x: None if x is None else self._in(x)
        noisy_latents = self._in(noisy_latents)
        control = None
        if control_cond is not None and self.modules.controlnet is not None:
            control = self.modules.controlnet(noisy_latents, timesteps, self._in(control_cond),
                                              conditioning_scale=control_scale)
        out = self.modules.denoiser(
            noisy_latents, timesteps,
            context=opt(context),
            ref_features=ref_feats,
            ref_gn=ref_gn,
            audio=opt(audio_windows),
            speeds=None if speeds is None else torch.as_tensor(speeds).to(self.device),
            face_mask=opt(face_mask),
            face_feat=opt(face_feat),
            control=control,
            identity_embed=opt(identity_embed),
            ref_dropout=None if ref_dropout is None else ref_dropout.to(self.device),
            whole_clip=whole_clip,
        )
        return out.sample
