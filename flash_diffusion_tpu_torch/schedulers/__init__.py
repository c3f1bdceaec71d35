"""Diffusion schedulers of the PyTorch port.

Each scheduler family is a module exposing ``set_timesteps``,
``scale_model_input`` and ``step``, as in ``flash_diffusion_tpu.schedulers``.
``REGISTRY`` maps the diffusers class names of the training configs onto
the families ported so far: DDPM (the SD1.5 teacher's rollout),
DPM-Solver++ 2M (the SDXL teacher's, with its multistep carry) and LCM
(the student's sampler). Euler and Euler-ancestral, which serve only the
JAX ``log_samples``, wait.
"""

from . import ddpm, dpm, lcm
from .base import (
    SchedulerConfig,
    add_noise,
    interp_sigma,
    make_betas,
    predicted_x0,
    spaced_timesteps,
    step_noise,
    training_tables,
)

REGISTRY = {"DDPMScheduler": ddpm, "DPMSolverMultistepScheduler": dpm, "LCMScheduler": lcm}

__all__ = [
    "REGISTRY",
    "SchedulerConfig",
    "add_noise",
    "ddpm",
    "dpm",
    "interp_sigma",
    "lcm",
    "make_betas",
    "predicted_x0",
    "spaced_timesteps",
    "step_noise",
    "training_tables",
]
