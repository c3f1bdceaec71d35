"""Model bodies of the PyTorch port (SD1.5, SDXL and Pixart-α text-to-image slices)."""

from .dit import DiT, DiTConfig, pixart_config
from .text_encoders import (
    CLIPTextConfig,
    CLIPTextModel,
    T5Config,
    T5Encoder,
    clip_g_config,
    clip_l_config,
    t5_xxl_config,
)
from .unet import UNet2DCondition, UNetConfig, sd15_unet_config, sdxl_unet_config
from .vae import AutoencoderKL, AutoencoderKLConfig, sd_vae_config

__all__ = [
    "AutoencoderKL",
    "AutoencoderKLConfig",
    "CLIPTextConfig",
    "CLIPTextModel",
    "DiT",
    "DiTConfig",
    "T5Config",
    "T5Encoder",
    "UNet2DCondition",
    "UNetConfig",
    "clip_g_config",
    "clip_l_config",
    "pixart_config",
    "sd15_unet_config",
    "sd_vae_config",
    "sdxl_unet_config",
    "t5_xxl_config",
]
