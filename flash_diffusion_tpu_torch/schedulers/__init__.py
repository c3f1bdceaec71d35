"""Diffusion schedulers of the PyTorch port.

Each scheduler family is a module exposing ``set_timesteps``,
``scale_model_input`` and ``step``, as in ``flash_diffusion_tpu.schedulers``.
``REGISTRY`` maps the diffusers class names of the training configs onto
the families ported so far: DDPM (the teacher's rollout) and LCM (the
student's sampler). Euler-ancestral, which serves only the JAX
``log_samples``, waits.
"""

from . import ddpm, lcm
from .base import (
    SchedulerConfig,
    add_noise,
    make_betas,
    predicted_x0,
    spaced_timesteps,
    step_noise,
    training_tables,
)

REGISTRY = {"DDPMScheduler": ddpm, "LCMScheduler": lcm}

__all__ = [
    "REGISTRY",
    "SchedulerConfig",
    "add_noise",
    "ddpm",
    "lcm",
    "make_betas",
    "predicted_x0",
    "spaced_timesteps",
    "step_noise",
    "training_tables",
]
