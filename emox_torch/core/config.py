"""Typed dataclass configuration: the port's copy of emox.core.config.

Field for field the same dataclasses as emox/core/config.py (a test holds
them equal), so a YAML written for the reference loads here unchanged.
The port imports nothing of emox, so AugmentConfig is copied in too.
load_config and save_config read and write YAML through the port's own
reader (emox_torch.core.yamlio): PyYAML is not needed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from emox_torch.core import yamlio


@dataclass(frozen=True)
class AugmentConfig:
    """Paired data augmentation ranges (a copy of emox.data.augment.AugmentConfig;
    the port imports nothing of emox)."""

    horizontal_flip: float = 0.5  # probability
    crop_scale_min: float = 0.85  # random-resized-crop area lower bound
    crop_scale_max: float = 1.0
    brightness: float = 0.1  # +/- range, frames only
    contrast: float = 0.1
    enabled: bool = True


def _tuplify(x):
    return tuple(x) if isinstance(x, list) else x


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL-shaped VAE (reference uses stabilityai/sd-vae-ft-mse,
    reference train_stage_1_referencenet.py:124-127)."""

    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215  # reference train_stage_1_referencenet.py:164
    sample_size: int = 256

    def __post_init__(self):
        object.__setattr__(self, "channel_multipliers", _tuplify(self.channel_multipliers))

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_multipliers) - 1)


@dataclass(frozen=True)
class AudioConfig:
    """wav2vec2-style audio encoder + per-video-frame feature framing
    (reference Net.py:607-797 Wav2VecFeatureExtractor)."""

    sample_rate: int = 16000
    hidden_dim: int = 768
    num_layers: int = 4
    num_heads: int = 8
    conv_dim: int = 512
    # conv feature extractor strides/kernels (wav2vec2-base layout)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    # +/- context frames concatenated per video frame
    # (reference configs/training/stage2.yaml audio_ctx_frames: 2)
    context_frames: int = 2
    video_fps: float = 25.0

    def __post_init__(self):
        object.__setattr__(self, "conv_strides", _tuplify(self.conv_strides))
        object.__setattr__(self, "conv_kernels", _tuplify(self.conv_kernels))

    @property
    def frames_per_window(self) -> int:
        return 2 * self.context_frames + 1

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.conv_strides:
            s *= st
        return s


@dataclass(frozen=True)
class ModelConfig:
    """The denoising UNet3D + conditioning modules.

    Mirrors the SD-1.5 UNet topology the reference inflates
    (reference magicanimate/models/unet_controlnet.py:54-160,
    configs/unet-config.yaml) at a configurable scale, plus the EMO
    conditioning the reference declared but never wired into the denoiser
    (reference EMOAnimationPipeline.py:777-786 vs unet_controlnet.py:328-339):
    audio cross-attention, speed embedding, face-region mask residual.
    """

    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 128
    channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    norm_groups: int = 32
    attention_head_dim: int = 64
    # 0: derive heads from attention_head_dim (fixed head dim);
    # >0: fixed head count with head_dim = channels // heads (SD-1.5 uses 8,
    # required for faithful SD weight import)
    attention_heads: int = 0
    # "scale_shift" (default) or "add" (SD-1.5 resnet convention,
    # required for faithful SD weight import)
    resnet_temb_mode: str = "scale_shift"
    cross_attention_dim: int = 768
    # text/CLIP cross-attention (attn2). True keeps SD-1.5 structure (needed
    # for faithful SD weight import); False removes it — EMO is audio-driven
    # with no text prompt, so a null-token attn2 at every site is pure
    # overhead (the reference inherited it from SD and fed empty prompts,
    # EMOAnimationPipeline.py:641-679)
    use_cross_attention: bool = True
    # which resolutions get spatial/cross attention (index into multipliers);
    # (0, 1, 2) mirrors SD-1.5's CrossAttnDownBlock placement
    attention_levels: Tuple[int, ...] = (0, 1, 2)
    # temporal motion modules (reference motion_module.py:42-334)
    use_temporal: bool = True
    temporal_pos_max_len: int = 24  # reference configs/inference.yaml / motion_module.py:235
    # audio cross-attention injection (EMO-specific; finishes reference wiring)
    use_audio: bool = True
    audio_context_dim: int = 768
    # reference-image attention (K/V concat into self-attention,
    # reference mutual_self_attention.py:237-241)
    use_reference: bool = True
    # speed-bucket conditioning added to the time embedding
    # (reference Net.py:198-258 SpeedEncoder, Net.py:554-589 SpeedController)
    use_speed: bool = True
    num_speed_buckets: int = 9  # reference train_stage_3_speedlayers.py:31-32
    speed_bucket_radius: float = 0.1
    # 1: scalar ||d pose|| speed; 3: signed per-axis (pitch, yaw, roll)
    # velocities — the reference buckets each axis (vector input,
    # reference Net.py:248-258), which preserves head-turn direction
    speed_axes: int = 1
    # face-region mask conv encoder added at conv_in
    # (reference Net.py:819-855 FaceLocator, Net.py:591-605 FaceRegionController;
    # channel count inferred from the mask array)
    use_face_mask: bool = True
    # sparse-causal spatial self-attention: K/V from (first, previous) frames
    # instead of the current frame (reference magicanimate/models/attention.py
    # SparseCausalAttention2D). Off for the EMO flagship (reference attention
    # fills that role); on for MagicAnimate-style animation without a
    # reference UNet.
    use_sparse_causal: bool = False
    # ControlNet-style dense conditioning branch (pose skeleton / landmark
    # render per frame, reference magicanimate/models/controlnet.py)
    use_controlnet: bool = False
    control_cond_channels: int = 3
    # CLIP identity-image embedding added to the time embedding through a
    # zero-init projection (finishes the reference's unconsumed
    # image_encoder wiring, reference EMOAnimationPipeline.py:867,
    # Net.py:421-430 EMOModel(image_encoder=...)). Works in the audio-driven
    # flagship too (no attn2 required).
    use_identity_embed: bool = False
    # depthwise-separable 3x3 convs in ResBlocks (working version of the
    # reference's abandoned depthwise experiment, reference depthwise.py)
    separable_convs: bool = False
    # False pins every attention of the UNet to the plain path (impl "xla");
    # EMOX_ATTENTION_IMPL, where set, beats it (emox_torch/models/unet.py).
    flash_attention: bool = True
    remat: bool = True
    # AdaIN-style GroupNorm statistic transfer: the writer (ReferenceNet)
    # also emits per-channel spatial mean/var at every attention site, and
    # the reader renormalises its activations to those statistics
    # (reference mutual_self_attention.py:319-530 mean_bank/var_bank mode).
    # Optional fidelity mode on top of the K/V-concat reference attention.
    use_gn_ref: bool = False
    # Blend factor for the CFG-uncond half under AdaIN: uncond keeps
    # style_fidelity of its own statistics (reference
    # stable_diffusion_controlnet_reference.py style_fidelity, default 0.5).
    style_fidelity: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "channel_multipliers", _tuplify(self.channel_multipliers))
        object.__setattr__(self, "attention_levels", _tuplify(self.attention_levels))

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_multipliers)


@dataclass(frozen=True)
class CLIPConfig:
    """CLIP text/image encoders (reference loads CLIPTextModel for prompt
    embeddings, magicanimate/pipelines/animation.py:76 /
    pipeline_animation.py:184-271, and CLIPVisionModelWithProjection as the
    EMO image encoder, EMOAnimationPipeline.py:867). Disabled by default —
    the EMO flagship is audio-driven — and enabled for MagicAnimate-style
    prompt-conditioned runs and identity-embedding conditioning.

    Defaults mirror openai/clip-vit-large-patch14, the encoder SD-1.5 ships."""

    text_enabled: bool = False
    vision_enabled: bool = False
    vocab_size: int = 49408
    text_hidden_dim: int = 768
    text_layers: int = 12
    text_heads: int = 12
    max_positions: int = 77
    vision_hidden_dim: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    # "quick_gelu" (openai CLIP / SD-1.5) or "gelu" (newer LAION CLIPs)
    hidden_act: str = "quick_gelu"


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM/DDIM schedule (reference train_stage_1_referencenet.py:145-150:
    1000 steps, scaled_linear beta 0.00085 -> 0.012)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear", "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # or "v_prediction"
    # training loss shaping (reference configs/training/stage0.yaml)
    snr_gamma: float = 0.0  # 0 disables; reference stage0 uses 5.0
    noise_offset: float = 0.0  # reference stage0 uses 0.05
    zero_terminal_snr: bool = False
    # sampling
    num_inference_steps: int = 50  # reference EMOAnimationPipeline.py:550
    guidance_scale: float = 7.5  # reference EMOAnimationPipeline.py:551
    ddim_eta: float = 0.0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes: data x context x model.

    `context` shards the video-frame window axis (the reference's only real
    parallelism: denoise windows split rank::world_size,
    reference EMOAnimationPipeline.py:757); `model` is tensor parallelism
    over attention heads / conv channels (new capability, GSPMD)."""

    data: int = -1  # -1: all remaining devices
    context: int = 1
    model: int = 1
    axis_names: Tuple[str, str, str] = ("data", "context", "model")

    def __post_init__(self):
        object.__setattr__(self, "axis_names", _tuplify(self.axis_names))


@dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing (reference Net.py:1189-1445 EMODataset)."""

    metadata_json: str = "data/overfit.json"
    video_dir: str = "data/videos"
    cache_dir: str = "data/cache"
    width: int = 256
    height: int = 256
    num_frames: int = 8  # reference configs/training/stage2.yaml num_frames: 8
    num_motion_frames: int = 2
    batch_size: int = 4
    num_workers: int = 0
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Unified trainer config; per-stage values mirror the reference
    (reference configs/training/stage{1,2,3}.yaml: s1 lr 1e-4 bs4,
    s2 lr 1e-5 bs2, s3 lr 1e-5 bs2 face_loss_weight 0.5)."""

    stage: int = 1
    learning_rate: float = 1e-4
    # "adamw" (default) or "adafactor" (factored second moment, no first
    # moment: less optimizer state)
    optimizer: str = "adamw"
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float = 1.0
    num_steps: int = 1000
    warmup_steps: int = 0
    gradient_accumulation: int = 1
    ema_decay: float = 0.0  # 0 disables
    face_loss_weight: float = 0.5  # reference configs/training/stage3.yaml
    vae_kl_weight: float = 1e-6  # stage-5 VAE pretrain KL weight (SD's VAE
    # training value; the reference never trains its VAE — it loads SD's)
    vae_encode: str = "sample"  # latent draw for the denoise stages:
    # "sample" = posterior sample (reference parity: latent_dist.sample());
    # "mode" = deterministic mean, needed with a self-trained VAE whose
    # posterior stays wide
    uncond_ratio: float = 0.1  # CFG dropout, reference configs/training/stage0.yaml
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    log_every: int = 50
    eval_every: int = 0  # 0 disables
    resume: bool = True
    seed: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # storage dtype for FROZEN leaves: "compute" (checkpoints then persist
    # frozen leaves in the compute dtype, a one-way precision loss) or
    # "param" (keep fp32 masters for frozen leaves)
    frozen_dtype: str = "compute"


@dataclass(frozen=True)
class InferenceConfig:
    """Windowed long-video inference
    (reference EMOAnimationPipeline.py:563-567: context 16, overlap 4)."""

    context_frames: int = 16
    context_overlap: int = 4
    context_stride: int = 1
    video_length: int = 16
    width: int = 256
    height: int = 256
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    fps: float = 25.0
    interpolation_factor: int = 1  # latent slerp upsampling (reference util.py:128-138)
    # batch cond+uncond into one model call (costs 2x activation memory)
    cfg_batching: bool = True
    # precompute ReferenceNet banks for every sampler timestep in one
    # batched writer pass before the denoise loop (identical math; the
    # writer depends only on (ref_latent, t)) instead of rerunning the
    # writer inside every step like the reference
    # (EMOAnimationPipeline.py:711-716). Costs S x bank memory.
    precompute_ref_banks: bool = True
    # frames per VAE-decode chunk (0 = all at once; reference VAE slicing,
    # EMOAnimationPipeline.py:170-174)
    decode_chunk: int = 0
    seed: int = 0


_SECTIONS = {
    "vae": VAEConfig,
    "augment": AugmentConfig,
    "audio": AudioConfig,
    "model": ModelConfig,
    "clip": CLIPConfig,
    "diffusion": DiffusionConfig,
    "mesh": MeshConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "inference": InferenceConfig,
}


@dataclass(frozen=True)
class Config:
    """Top-level bundle of all sections."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    clip: CLIPConfig = field(default_factory=CLIPConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


# Fields that existed in earlier released configs but were since removed.
# Saved checkpoint-dir YAMLs (save_config dumps every field) must stay
# loadable: these are dropped with a warning instead of rejected, while
# true typos still raise.
_REMOVED_FIELDS = {
    "DataConfig": {"data_dir", "shuffle"},
    "ModelConfig": {"face_mask_channels"},
}


def _build(cls, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    removed = (set(d) - names) & _REMOVED_FIELDS.get(cls.__name__, set())
    if removed:
        import warnings

        warnings.warn(
            f"{cls.__name__}: ignoring removed config fields {sorted(removed)} "
            "(present in a YAML saved by an older version)"
        )
        d = {k: v for k, v in d.items() if k not in removed}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**d)


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Dict[str, Any]]] = None) -> Config:
    """Load a Config from YAML with optional nested-dict overrides."""
    raw: Dict[str, Any] = {}
    if path is not None:
        raw = yamlio.load(path) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: a configuration is a mapping of sections, got {type(raw).__name__}")
    if overrides:
        for sec, vals in overrides.items():
            raw.setdefault(sec, {}).update(vals)
    kwargs = {}
    for sec, cls in _SECTIONS.items():
        if sec in raw:
            kwargs[sec] = _build(cls, raw[sec])
    extra = set(raw) - set(_SECTIONS)
    if extra:
        raise ValueError(f"unknown config sections: {sorted(extra)}")
    return Config(**kwargs)


def save_config(cfg: Config, path: str) -> None:
    out = {}
    for sec in _SECTIONS:
        d = dataclasses.asdict(getattr(cfg, sec))
        out[sec] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
    yamlio.dump(out, path)


# Per-stage presets mirroring the reference recipes.
def stage_presets(stage: int) -> Dict[str, Dict[str, Any]]:
    """Hyperparameter presets per training stage
    (reference configs/training/stage{1,2,3}.yaml)."""
    if stage == 1:
        return {"train": {"stage": 1, "learning_rate": 1e-4}, "data": {"batch_size": 4, "num_frames": 1}}
    if stage == 2:
        return {"train": {"stage": 2, "learning_rate": 1e-5}, "data": {"batch_size": 2, "num_frames": 8}}
    if stage == 3:
        return {"train": {"stage": 3, "learning_rate": 1e-5, "face_loss_weight": 0.5},
                "data": {"batch_size": 2, "num_frames": 8}}
    if stage == 5:
        # VAE pretraining (emox extension; single frames, AE-style lr)
        return {"train": {"stage": 5, "learning_rate": 1e-4},
                "data": {"batch_size": 4, "num_frames": 1}}
    raise ValueError(f"stage must be 1, 2, 3 or 5, got {stage}")
