"""Model bodies of the PyTorch port (SD1.5 and SDXL text-to-image slices)."""

from .text_encoders import CLIPTextConfig, CLIPTextModel, clip_g_config, clip_l_config
from .unet import UNet2DCondition, UNetConfig, sd15_unet_config, sdxl_unet_config
from .vae import AutoencoderKL, AutoencoderKLConfig, sd_vae_config

__all__ = [
    "AutoencoderKL",
    "AutoencoderKLConfig",
    "CLIPTextConfig",
    "CLIPTextModel",
    "UNet2DCondition",
    "UNetConfig",
    "clip_g_config",
    "clip_l_config",
    "sd15_unet_config",
    "sd_vae_config",
    "sdxl_unet_config",
]
