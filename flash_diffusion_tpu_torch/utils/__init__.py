"""Utilities of the PyTorch port."""

from .convert import (
    adapter_from_jax,
    clip_text_from_jax,
    dit_from_jax,
    discriminator_from_jax,
    dpt_from_jax,
    inception_from_jax,
    lora_from_jax,
    lpips_from_jax,
    mmdit_from_jax,
    module_embedder_from_jax,
    t5_from_jax,
    unet_from_jax,
    vae_from_jax,
    vision_from_jax,
)

__all__ = [
    "adapter_from_jax",
    "clip_text_from_jax",
    "dit_from_jax",
    "discriminator_from_jax",
    "dpt_from_jax",
    "inception_from_jax",
    "lora_from_jax",
    "lpips_from_jax",
    "mmdit_from_jax",
    "module_embedder_from_jax",
    "t5_from_jax",
    "unet_from_jax",
    "vae_from_jax",
    "vision_from_jax",
]
