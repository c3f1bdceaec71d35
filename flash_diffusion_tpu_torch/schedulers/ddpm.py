"""DDPM ancestral sampler — the teacher's scheduler in Flash distillation.

Port of ``flash_diffusion_tpu/schedulers/ddpm.py:44-111`` (diffusers
``DDPMScheduler`` semantics, fixed-small variance). Coefficient tables are
built in float64 and stored as float32 values, as the JAX schedule holds
them, and applied as Python scalars; ``step`` takes the posterior noise as a
tensor (None for the variance-free step), so tests can hand both packages
the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .base import SchedulerConfig, predicted_x0, spaced_timesteps, training_tables


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    timesteps: List[int]  # [n], descending
    alphas_cumprod: torch.Tensor  # [T] fp32, the full training table (add_noise)
    sqrt_acp_t: List[float]  # [n] tables indexed by the position i
    sqrt_1macp_t: List[float]
    x0_coeff: List[float]  # posterior mean coefficient on x̂₀
    sample_coeff: List[float]  # posterior mean coefficient on x_t
    sigma_noise: List[float]  # sqrt(posterior variance); 0 at t = 0
    prediction_type: str
    clip_sample: bool = False
    clip_range: float = 1.0
    init_noise_sigma: float = 1.0

    @property
    def num_inference_steps(self) -> int:
        return len(self.timesteps)


def set_timesteps(config: SchedulerConfig, num_inference_steps: int) -> DDPMSchedule:
    acp, _, _ = training_tables(config)
    timesteps = spaced_timesteps(
        config.num_train_timesteps, num_inference_steps, config.timestep_spacing,
        config.steps_offset,
    )
    prev_t = timesteps - config.num_train_timesteps // num_inference_steps
    alpha_prod_t = acp[timesteps]
    alpha_prod_prev = np.where(prev_t >= 0, acp[np.clip(prev_t, 0, None)], 1.0)
    beta_prod_t, beta_prod_prev = 1.0 - alpha_prod_t, 1.0 - alpha_prod_prev
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha
    variance = np.clip(beta_prod_prev / beta_prod_t * current_beta, 1e-20, None)

    f32 = lambda x: [float(v) for v in np.asarray(x, np.float32)]
    return DDPMSchedule(
        timesteps=[int(t) for t in timesteps],
        alphas_cumprod=torch.tensor(np.asarray(acp, np.float32)),
        sqrt_acp_t=f32(np.sqrt(alpha_prod_t)),
        sqrt_1macp_t=f32(np.sqrt(beta_prod_t)),
        x0_coeff=f32(np.sqrt(alpha_prod_prev) * current_beta / beta_prod_t),
        sample_coeff=f32(np.sqrt(current_alpha) * beta_prod_prev / beta_prod_t),
        sigma_noise=f32(np.where(timesteps > 0, np.sqrt(variance), 0.0)),
        prediction_type=config.prediction_type,
        clip_sample=config.clip_sample,
        clip_range=config.clip_sample_range,
    )


def scale_model_input(schedule: DDPMSchedule, sample: torch.Tensor, i: int) -> torch.Tensor:
    del schedule, i
    return sample


def step(
    schedule: DDPMSchedule,
    model_output: torch.Tensor,
    i: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One ancestral reverse step from position ``i``; ``noise`` is the
    posterior draw (None: the variance-free step)."""
    x0 = predicted_x0(
        model_output, sample, schedule.sqrt_acp_t[i], schedule.sqrt_1macp_t[i],
        schedule.prediction_type,
    )
    if schedule.clip_sample:
        x0 = torch.clamp(x0, -schedule.clip_range, schedule.clip_range)
    prev = schedule.x0_coeff[i] * x0 + schedule.sample_coeff[i] * sample
    if noise is not None:
        prev = prev + schedule.sigma_noise[i] * noise.to(sample.dtype)
    return prev
