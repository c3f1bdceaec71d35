"""Diffusion schedulers of the PyTorch port.

Each scheduler family is a module exposing ``set_timesteps``,
``scale_model_input`` and ``step``, as in ``flash_diffusion_tpu.schedulers``.
``REGISTRY`` maps the diffusers class names of the training configs onto
the families ported so far: DDPM (the SD1.5 teacher's rollout),
DPM-Solver++ 2M (the SDXL teacher's, with its multistep carry), LCM (the
student's sampler), SD3's flow matching: the plain Euler step
(``FlowMatchEulerDiscreteScheduler``, the SD3 teacher's) and the Flash
student's re-noising step (``FlashFlowMatchEulerDiscreteScheduler``: the
same tables, ``flow_match.flash_step``), and Euler and Euler-ancestral in
σ space (``EulerDiscreteScheduler``, ``EulerAncestralDiscreteScheduler``:
the teachers' validation samplers).
"""

from types import SimpleNamespace

from . import ddpm, dpm, euler, flow_match, lcm
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

# Euler ancestral shares the euler module, with ancestral=True at set_timesteps
_euler_ancestral = SimpleNamespace(
    set_timesteps=lambda config, n: euler.set_timesteps(config, n, ancestral=True),
    scale_model_input=euler.scale_model_input,
    step=euler.step,
)

# Flash flow-match shares flow_match's tables and steps with flash_step
_flash_flow_match = SimpleNamespace(
    set_timesteps=flow_match.set_timesteps,
    scale_model_input=flow_match.scale_model_input,
    step=flow_match.flash_step,
    add_noise=flow_match.add_noise,
    get_sigmas=flow_match.get_sigmas,
)

REGISTRY = {
    "DDPMScheduler": ddpm,
    "DPMSolverMultistepScheduler": dpm,
    "EulerDiscreteScheduler": euler,
    "EulerAncestralDiscreteScheduler": _euler_ancestral,
    "LCMScheduler": lcm,
    "FlowMatchEulerDiscreteScheduler": flow_match,
    "FlashFlowMatchEulerDiscreteScheduler": _flash_flow_match,
}

__all__ = [
    "REGISTRY",
    "SchedulerConfig",
    "add_noise",
    "ddpm",
    "dpm",
    "euler",
    "flow_match",
    "interp_sigma",
    "lcm",
    "make_betas",
    "predicted_x0",
    "spaced_timesteps",
    "step_noise",
    "training_tables",
]
