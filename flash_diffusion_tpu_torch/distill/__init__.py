"""Flash distillation of the PyTorch port (the SD1.5, SDXL, Pixart-α and SD3 steps)."""

from .common import (
    boundary_scalings,
    gaussian_mixture_pdf,
    predicted_x0_eps,
    sample_start_index,
    stage_index,
    timestep_pdf,
)
from .discriminator import ConvDiscriminator, DiscriminatorConfig, sd3_discriminator_config
from .flash import FlashDiffusion, FlashDiffusionConfig
from .flash_sd3 import FlashDiffusionSD3, FlashDiffusionSD3Config
from .losses import center_crop, clip_disc_weights, dmd_loss, gan_losses, huber_loss, l1_loss, l2_loss
from .lpips import LPIPS, VGG16Features

__all__ = [
    "LPIPS",
    "ConvDiscriminator",
    "DiscriminatorConfig",
    "FlashDiffusion",
    "FlashDiffusionConfig",
    "FlashDiffusionSD3",
    "FlashDiffusionSD3Config",
    "VGG16Features",
    "boundary_scalings",
    "center_crop",
    "clip_disc_weights",
    "dmd_loss",
    "gan_losses",
    "gaussian_mixture_pdf",
    "huber_loss",
    "l1_loss",
    "l2_loss",
    "predicted_x0_eps",
    "sd3_discriminator_config",
    "sample_start_index",
    "stage_index",
    "timestep_pdf",
]
