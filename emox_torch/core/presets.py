"""Named model-scale presets (the port's copy of emox.core.presets).

`flagship` mirrors the scale the reference targets (SD-1.5 UNet inflated to
video + EMO conditioning, 512/256 px, reference configs/unet-config.yaml):
base 320, multipliers (1,2,4,4), 2 layers/block, attention at levels 0-2,
wav2vec2-base audio encoder. `small`/`tiny` are dev scales.
"""

from __future__ import annotations

from emox_torch.core.config import AudioConfig, Config, DataConfig, InferenceConfig, ModelConfig, VAEConfig


def flagship_config(image_size: int = 256, num_frames: int = 16) -> Config:
    return Config(
        vae=VAEConfig(base_channels=128, channel_multipliers=(1, 2, 4, 4), num_res_blocks=2, sample_size=image_size),
        model=ModelConfig(
            base_channels=320, channel_multipliers=(1, 2, 4, 4), layers_per_block=2,
            attention_head_dim=64, cross_attention_dim=768, attention_levels=(0, 1, 2),
            audio_context_dim=768,
            # audio-driven: no text prompt, so no attn2 (the reference fed
            # empty prompts through SD's text cross-attention)
            use_cross_attention=False,
            # per-axis (pitch, yaw, roll) signed head velocities — the
            # reference buckets each axis (Net.py:248-258); scalar speed
            # loses head-turn direction
            speed_axes=3,
        ),
        audio=AudioConfig(hidden_dim=768, num_layers=12, num_heads=12, conv_dim=512),
        data=DataConfig(width=image_size, height=image_size, num_frames=num_frames),
        inference=InferenceConfig(width=image_size, height=image_size, video_length=num_frames),
    )


def small_config(image_size: int = 128, num_frames: int = 8) -> Config:
    return Config(
        vae=VAEConfig(base_channels=64, channel_multipliers=(1, 2, 4), num_res_blocks=1, norm_groups=16, sample_size=image_size),
        model=ModelConfig(
            base_channels=128, channel_multipliers=(1, 2, 4), layers_per_block=2, norm_groups=16,
            attention_head_dim=64, cross_attention_dim=256, attention_levels=(1, 2), audio_context_dim=256,
        ),
        audio=AudioConfig(hidden_dim=256, num_layers=4, num_heads=8, conv_dim=256),
        data=DataConfig(width=image_size, height=image_size, num_frames=num_frames),
        inference=InferenceConfig(width=image_size, height=image_size, video_length=num_frames),
    )


def tiny_config(image_size: int = 32, num_frames: int = 2) -> Config:
    return Config(
        vae=VAEConfig(base_channels=8, channel_multipliers=(1, 2), num_res_blocks=1, norm_groups=4, sample_size=image_size),
        model=ModelConfig(
            base_channels=8, channel_multipliers=(1, 2), layers_per_block=1, norm_groups=4,
            attention_head_dim=4, cross_attention_dim=8, attention_levels=(1,), audio_context_dim=16,
        ),
        audio=AudioConfig(hidden_dim=16, num_layers=1, num_heads=2, conv_dim=8),
        data=DataConfig(width=image_size, height=image_size, num_frames=num_frames),
        inference=InferenceConfig(width=image_size, height=image_size, video_length=num_frames),
    )


PRESETS = {"flagship": flagship_config, "small": small_config, "tiny": tiny_config}
