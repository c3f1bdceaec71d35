"""Flash distillation of the PyTorch port (the SD1.5 and SDXL steps)."""

from .common import (
    boundary_scalings,
    gaussian_mixture_pdf,
    predicted_x0_eps,
    sample_start_index,
    stage_index,
    timestep_pdf,
)
from .discriminator import ConvDiscriminator, DiscriminatorConfig
from .flash import FlashDiffusion, FlashDiffusionConfig
from .losses import center_crop, clip_disc_weights, dmd_loss, gan_losses, huber_loss, l1_loss, l2_loss
from .lpips import LPIPS, VGG16Features

__all__ = [
    "LPIPS",
    "ConvDiscriminator",
    "DiscriminatorConfig",
    "FlashDiffusion",
    "FlashDiffusionConfig",
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
    "sample_start_index",
    "stage_index",
    "timestep_pdf",
]
