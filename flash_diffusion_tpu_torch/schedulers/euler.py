"""Euler and Euler-ancestral samplers in σ space (diffusers semantics).

Port of ``flash_diffusion_tpu/schedulers/euler.py:30-120``.
``EulerDiscreteScheduler`` is the SDXL teacher's sampler in validation,
``EulerAncestralDiscreteScheduler`` SD1.5's. The tables are built in
float64 numpy and stored as float32 values, and every coefficient a step
applies is formed in float32, as the JAX schedule computes it; the
ancestral step takes its noise as a tensor (None: no noise).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .base import SchedulerConfig, interp_sigma, spaced_timesteps, training_tables

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    """``sigmas`` has n + 1 entries, the terminal 0 last."""

    timesteps: List[int]  # [n], descending
    sigmas: List[float]  # [n + 1] fp32 values
    sigma_up: List[float]  # [n] ancestral noise scale (0 at the last step)
    sigma_down: List[float]  # [n]
    alphas_cumprod: torch.Tensor  # [T] fp32, the full training table (add_noise)
    init_noise_sigma: float
    prediction_type: str
    ancestral: bool = False

    @property
    def num_inference_steps(self) -> int:
        return len(self.timesteps)


def set_timesteps(config: SchedulerConfig, num_inference_steps: int, ancestral: bool = False) -> EulerSchedule:
    acp, _, _ = training_tables(config)
    sigmas_all = np.sqrt((1.0 - acp) / acp)
    timesteps = spaced_timesteps(config.num_train_timesteps, num_inference_steps, config.timestep_spacing,
                                 config.steps_offset).astype(np.float64)
    sigmas = np.append(interp_sigma(timesteps, sigmas_all), 0.0)
    if config.timestep_spacing in ("linspace", "trailing"):
        init_noise_sigma = sigmas.max()
    else:
        init_noise_sigma = (sigmas.max() ** 2 + 1.0) ** 0.5
    # the ancestral split: sigma_up² + sigma_down² = sigma_next²
    s, s_next = sigmas[:-1], sigmas[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_up = np.where(
            s_next > 0,
            np.sqrt(np.clip(s_next ** 2 * (s ** 2 - s_next ** 2) / np.where(s > 0, s ** 2, 1.0), 0, None)), 0.0)
    sigma_down = np.sqrt(np.clip(s_next ** 2 - sigma_up ** 2, 0, None))
    f32 = lambda x: [float(v) for v in np.asarray(x, np.float32)]
    return EulerSchedule(
        timesteps=[int(t) for t in np.round(timesteps)],
        sigmas=f32(sigmas),
        sigma_up=f32(sigma_up),
        sigma_down=f32(sigma_down),
        alphas_cumprod=torch.tensor(np.asarray(acp, np.float32)),
        init_noise_sigma=float(_f32(init_noise_sigma)),
        prediction_type=config.prediction_type,
        ancestral=ancestral,
    )


def scale_model_input(schedule: EulerSchedule, sample: torch.Tensor, i: int) -> torch.Tensor:
    sigma = _f32(schedule.sigmas[i])
    return sample / float(np.sqrt(sigma * sigma + _f32(1.0)))


def _pred_x0(schedule: EulerSchedule, model_output: torch.Tensor, sample: torch.Tensor, sigma) -> torch.Tensor:
    if schedule.prediction_type == "epsilon":
        return sample - float(sigma) * model_output
    if schedule.prediction_type == "v_prediction":
        var = sigma * sigma + _f32(1.0)
        return model_output * float(-sigma / np.sqrt(var)) + sample / float(var)
    if schedule.prediction_type == "sample":
        return model_output
    raise ValueError(f"Unknown prediction_type {schedule.prediction_type!r}")


def step(schedule: EulerSchedule, model_output: torch.Tensor, i: int, sample: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Euler (or ancestral Euler) step in σ space from position ``i``:
    ``sample`` is the unscaled latent (the model saw
    ``scale_model_input(sample)``); s_churn 0. The ancestral step adds
    ``sigma_up``·``noise`` when ``noise`` is given."""
    sigma = _f32(schedule.sigmas[i])
    x0 = _pred_x0(schedule, model_output, sample, sigma)
    derivative = (sample - x0) / float(sigma)
    if schedule.ancestral:
        prev = sample + derivative * float(_f32(schedule.sigma_down[i]) - sigma)
        if noise is not None:
            prev = prev + schedule.sigma_up[i] * noise.to(sample.dtype)
        return prev
    return sample + derivative * float(_f32(schedule.sigmas[i + 1]) - sigma)
