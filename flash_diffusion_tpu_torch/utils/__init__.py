"""Utilities of the PyTorch port."""

from .convert import (
    clip_text_from_jax,
    dit_from_jax,
    discriminator_from_jax,
    lora_from_jax,
    lpips_from_jax,
    t5_from_jax,
    unet_from_jax,
    vae_from_jax,
)

__all__ = [
    "clip_text_from_jax",
    "dit_from_jax",
    "discriminator_from_jax",
    "lora_from_jax",
    "lpips_from_jax",
    "t5_from_jax",
    "unet_from_jax",
    "vae_from_jax",
]
