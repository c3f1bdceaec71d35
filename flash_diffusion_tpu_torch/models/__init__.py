"""Model bodies of the PyTorch port (SD1.5, SDXL, Pixart-α and SD3 text-to-image slices; the T2I-Adapter and the DPT depth model; the CLIP vision tower and InceptionV3 of the eval path)."""

from .adapters import T2IAdapter, T2IAdapterConfig, pixel_unshuffle
from .depth import DPTDepth, import_dpt_large, make_depth_fn
from .dit import DiT, DiTConfig, pixart_config
from .inception import InceptionV3Pool3, import_inception_v3, load_inception_v3
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
from .vision import CLIPVisionConfig, CLIPVisionModel, clip_vit_l14_config, import_clip_text, import_clip_vision

__all__ = [
    "AutoencoderKL",
    "AutoencoderKLConfig",
    "CLIPTextConfig",
    "CLIPTextModel",
    "CLIPVisionConfig",
    "CLIPVisionModel",
    "DPTDepth",
    "DiT",
    "DiTConfig",
    "InceptionV3Pool3",
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
    "clip_vit_l14_config",
    "import_clip_text",
    "import_clip_vision",
    "import_dpt_large",
    "import_inception_v3",
    "load_inception_v3",
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
