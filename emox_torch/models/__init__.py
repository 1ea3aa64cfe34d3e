"""Models: VAE, audio encoder, CLIP text encoder, UNet and the EMO composition."""

from emox_torch.models.audio import AudioEncoder, align_audio_to_frames, audio_feature_rate
from emox_torch.models.clip import CLIPTextEncoder
from emox_torch.models.emo import EMOModel
from emox_torch.models.unet import UNet, UNetOutputs, reference_net_config
from emox_torch.models.vae import AutoencoderKL, DiagonalGaussian

__all__ = [
    "AudioEncoder",
    "AutoencoderKL",
    "CLIPTextEncoder",
    "DiagonalGaussian",
    "EMOModel",
    "UNet",
    "UNetOutputs",
    "align_audio_to_frames",
    "audio_feature_rate",
    "reference_net_config",
]
