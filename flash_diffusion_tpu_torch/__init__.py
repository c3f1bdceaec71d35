"""flash_diffusion_tpu_torch — the PyTorch + CUDA port of flash_diffusion_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper, sm_90a).
It mirrors the JAX package's module names; every Pallas kernel on a ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use.
Ported so far: 4-step text-to-image sampling of SD1.5 at 512², SDXL,
Pixart-α and SD3-medium at 1024² (the text towers → LCM, or SD3's Flash
flow matching → UNet, DiT or MMDiT → VAE decode), the SD1.5, SDXL,
Pixart-α and SD3 distillation steps and the training run around them
(``trainer/``: tar-shard data from ``data/``, EMA, gradient accumulation,
the alternating GAN mode, validation sampling, checkpoints and resume,
text-encoder offload, PEFT export), the Canny T2I-Adapter distillation of
SD1.5 (``models/adapters.py``) and the DPT depth model (``models/depth.py``),
and serving (``serving.py``,
``serve.py``) with LoRA hot swap and the int8 W8A8 mode (``quant.py``).
Imports ``torch`` and never ``jax``.
"""

from .pipelines import FlashPipeline

__all__ = ["FlashPipeline"]
