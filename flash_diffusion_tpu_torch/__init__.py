"""flash_diffusion_tpu_torch — the PyTorch + CUDA port of flash_diffusion_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper, sm_90a).
It mirrors the JAX package's module names; every Pallas kernel on a ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use.
Ported so far: SD1.5 4-step text-to-image sampling (CLIP-L → LCM → UNet →
VAE decode). Imports ``torch`` and never ``jax``.
"""

from .pipelines import FlashPipeline

__all__ = ["FlashPipeline"]
