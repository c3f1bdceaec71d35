"""Diffusion schedulers of the PyTorch port.

Each scheduler family is a module exposing ``set_timesteps``,
``scale_model_input`` and ``step``, as in ``flash_diffusion_tpu.schedulers``.
Only the LCM sampler (the 4-step text-to-image path) is ported so far, so
there is no registry of families yet.
"""

from . import lcm
from .base import (
    SchedulerConfig,
    make_betas,
    predicted_x0,
    step_noise,
    training_tables,
)

__all__ = [
    "SchedulerConfig",
    "lcm",
    "make_betas",
    "predicted_x0",
    "step_noise",
    "training_tables",
]
