"""Model bodies of the PyTorch port (SD1.5, SDXL, Pixart-α and SD3 text-to-image slices; the T2I-Adapter and the DPT depth model)."""

from .adapters import T2IAdapter, T2IAdapterConfig, pixel_unshuffle
from .depth import DPTDepth, import_dpt_large, make_depth_fn
from .dit import DiT, DiTConfig, pixart_config
from .mmdit import MMDiT, MMDiTConfig, sd3_medium_config
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
from .vae import AutoencoderKL, AutoencoderKLConfig, sd3_vae_config, sd_vae_config

__all__ = [
    "AutoencoderKL",
    "AutoencoderKLConfig",
    "CLIPTextConfig",
    "CLIPTextModel",
    "DPTDepth",
    "DiT",
    "DiTConfig",
    "MMDiT",
    "MMDiTConfig",
    "T5Config",
    "T2IAdapter",
    "T2IAdapterConfig",
    "T5Encoder",
    "UNet2DCondition",
    "UNetConfig",
    "clip_g_config",
    "clip_l_config",
    "import_dpt_large",
    "make_depth_fn",
    "pixart_config",
    "pixel_unshuffle",
    "sd15_unet_config",
    "sd3_medium_config",
    "sd3_vae_config",
    "sd_vae_config",
    "sdxl_unet_config",
    "t5_xxl_config",
]
