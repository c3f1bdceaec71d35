"""LCM sampler — the published Flash Diffusion student scheduler.

Port of ``flash_diffusion_tpu/schedulers/lcm.py``. Each step predicts x̂₀,
forms the consistency output ``c_out·x̂₀ + c_skip·x_t`` (timestep_scaling=10,
sigma_data=0.5), then — except at the final step — re-noises to the next
timestep with fresh noise. Coefficients are float32 values, as in the JAX
schedule's tables, applied as Python scalars.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .base import SchedulerConfig, predicted_x0, training_tables


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    timesteps: List[int]  # [n], descending
    sqrt_acp_t: List[float]  # [n] at the current timestep
    sqrt_1macp_t: List[float]
    sqrt_acp_prev: List[float]  # [n] at the next timestep (1.0 at the final step)
    sqrt_1macp_prev: List[float]  # (0.0 at the final step)
    c_skip: List[float]
    c_out: List[float]
    prediction_type: str
    init_noise_sigma: float = 1.0

    @property
    def num_inference_steps(self) -> int:
        return len(self.timesteps)


def boundary_scalings(timesteps, timestep_scaling: float = 10.0, sigma_data: float = 0.5):
    """LCM consistency boundary conditions c_skip/c_out."""
    scaled = np.asarray(timesteps, np.float64) * timestep_scaling
    c_skip = sigma_data**2 / (scaled**2 + sigma_data**2)
    c_out = scaled / np.sqrt(scaled**2 + sigma_data**2)
    return c_skip, c_out


def set_timesteps(
    config: SchedulerConfig,
    num_inference_steps: Optional[int] = None,
    timesteps: Optional[Sequence[int]] = None,
) -> LCMSchedule:
    """Build the schedule from a step count or explicit (descending) timesteps.

    Without ``timesteps`` the grid is diffusers' LCMScheduler skipping grid
    over ``original_inference_steps`` origin timesteps: 4 steps at T=1000,
    orig=50 give [999, 759, 499, 259]."""
    _, sqrt_acp, sqrt_1macp = training_tables(config)
    if timesteps is None:
        orig = config.original_inference_steps
        k = config.num_train_timesteps // orig
        origin = np.arange(1, orig + 1, dtype=np.int64)[::-1] * k - 1
        idx = np.floor(
            np.linspace(0, len(origin), num=num_inference_steps, endpoint=False)
        ).astype(np.int64)
        timesteps = origin[idx]
    timesteps = np.asarray(timesteps, np.int64)
    prev_timesteps = np.append(timesteps[1:], 0)
    c_skip, c_out = boundary_scalings(timesteps, config.timestep_scaling, config.sigma_data)

    f32 = lambda x: [float(v) for v in np.asarray(x, np.float32)]
    return LCMSchedule(
        timesteps=[int(t) for t in timesteps],
        sqrt_acp_t=f32(sqrt_acp[timesteps]),
        sqrt_1macp_t=f32(sqrt_1macp[timesteps]),
        sqrt_acp_prev=f32(sqrt_acp[prev_timesteps]),
        sqrt_1macp_prev=f32(sqrt_1macp[prev_timesteps]),
        c_skip=f32(c_skip),
        c_out=f32(c_out),
        prediction_type=config.prediction_type,
    )


def scale_model_input(schedule: LCMSchedule, sample: torch.Tensor, i: int) -> torch.Tensor:
    del schedule, i
    return sample


def step(
    schedule: LCMSchedule,
    model_output: torch.Tensor,
    i: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One LCM step at position ``i``. Returns the denoised output at the
    final position; elsewhere re-noises with ``noise`` (zeros when None)."""
    x0 = predicted_x0(
        model_output, sample, schedule.sqrt_acp_t[i], schedule.sqrt_1macp_t[i],
        schedule.prediction_type,
    )
    denoised = schedule.c_out[i] * x0 + schedule.c_skip[i] * sample
    if i == schedule.num_inference_steps - 1:
        return denoised
    renoised = schedule.sqrt_acp_prev[i] * denoised
    if noise is not None:
        renoised = renoised + schedule.sqrt_1macp_prev[i] * noise.to(sample.dtype)
    return renoised
