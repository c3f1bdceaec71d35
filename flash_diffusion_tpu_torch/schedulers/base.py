"""Shared diffusion-schedule machinery for the PyTorch port.

Mirrors ``flash_diffusion_tpu/schedulers/base.py``: host-side coefficient
tables are built once in numpy (float64, then rounded to float32 exactly as
the JAX package stores them), and ``step`` functions are plain functions of
tensors indexed by the step position ``i``. Stochastic steps take their noise
from an explicit ``torch.Generator`` or from a tensor the caller passes in,
so tests can hand both packages the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_betas(
    num_train_timesteps: int = 1000,
    beta_schedule: str = "linear",
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
) -> np.ndarray:
    """Beta schedule table (diffusers' ``betas_for_alpha_bar`` family)."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
            ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = 1.0 - alpha_bar((ts + 1) / num_train_timesteps) / alpha_bar(
            ts / num_train_timesteps
        )
        return np.minimum(betas, 0.999)
    raise ValueError(f"Unknown beta_schedule {beta_schedule!r}")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduler hyperparameters (the JAX package's fields and defaults)."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "scaled_linear"  # SD family default
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    timestep_spacing: str = "trailing"
    steps_offset: int = 0
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    # DPM-Solver specific; ``dpm.set_timesteps`` implements these defaults
    # (and final_sigmas_type "sigma_min") and refuses other values
    solver_order: int = 2
    final_sigmas_type: str = "zero"  # zero | sigma_min
    lower_order_final: bool = True
    euler_at_final: bool = False
    # LCM specific
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    original_inference_steps: int = 50  # LCM origin-grid density (diffusers)
    # flow-match specific (SD3's rectified flow): the sigma warp
    # σ ← s·σ / (1 + (s − 1)·σ)
    shift: float = 3.0


def spaced_timesteps(
    num_train_timesteps: int,
    num_inference_steps: int,
    spacing: str = "trailing",
    steps_offset: int = 0,
) -> np.ndarray:
    """Inference timestep selection (descending), diffusers semantics."""
    t, n = num_train_timesteps, num_inference_steps
    if spacing == "linspace":
        return np.linspace(0, t - 1, n).round()[::-1].astype(np.int64)
    if spacing == "leading":
        return (np.arange(0, n) * (t // n)).round()[::-1].astype(np.int64) + steps_offset
    if spacing == "trailing":
        return np.arange(t, 0, -t / n).round().astype(np.int64) - 1
    raise ValueError(f"Unknown timestep spacing {spacing!r}")


def training_tables(config: SchedulerConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(alphas_cumprod, sqrt_acp, sqrt_one_minus_acp) over all T train steps."""
    betas = make_betas(
        config.num_train_timesteps,
        config.beta_schedule,
        config.beta_start,
        config.beta_end,
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    return alphas_cumprod, np.sqrt(alphas_cumprod), np.sqrt(1.0 - alphas_cumprod)


def interp_sigma(timesteps: np.ndarray, sigmas_all: np.ndarray) -> np.ndarray:
    """diffusers-style linear interpolation of sigma at (possibly float) t."""
    return np.interp(timesteps, np.arange(len(sigmas_all)), sigmas_all)


def add_noise(
    schedule, sample: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
) -> torch.Tensor:
    """Forward noising q(x_t | x_0) = sqrt(ᾱ_t)·x0 + sqrt(1 − ᾱ_t)·noise, from
    the schedule's fp32 ``alphas_cumprod`` table, per-sample ``timesteps``
    broadcast over the trailing dims."""
    acp = schedule.alphas_cumprod.to(sample.device)[timesteps.to(sample.device)]
    shape = acp.shape + (1,) * (sample.dim() - acp.dim())
    return torch.sqrt(acp).reshape(shape) * sample + torch.sqrt(1.0 - acp).reshape(shape) * noise.to(sample.dtype)


def predicted_x0(
    model_output: torch.Tensor,
    sample: torch.Tensor,
    sqrt_acp_t,
    sqrt_1macp_t,
    prediction_type: str,
) -> torch.Tensor:
    """x̂₀ from a model output under the given parameterization."""
    if prediction_type == "epsilon":
        return (sample - sqrt_1macp_t * model_output) / sqrt_acp_t
    if prediction_type == "v_prediction":
        return sqrt_acp_t * sample - sqrt_1macp_t * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"Unknown prediction_type {prediction_type!r}")


def step_noise(sample: torch.Tensor, generator=None) -> torch.Tensor:
    """One ``sample``-shaped standard normal draw for a stochastic step.

    ``generator`` is one ``torch.Generator`` (one batch-shaped draw), or a
    sequence of one per sample: then sample j's noise is drawn from its own
    generator at ``sample.shape[1:]``, so it never depends on its slot or on
    the (padded) batch size (``flash_diffusion_tpu/schedulers/base.py:193``,
    JAX's per-sample key batch). Generators live on ``sample``'s device."""
    if isinstance(generator, (list, tuple)):
        return torch.stack([
            torch.randn(sample.shape[1:], generator=g, device=sample.device, dtype=sample.dtype)
            for g in generator
        ])
    return torch.randn(
        sample.shape, generator=generator, device=sample.device, dtype=sample.dtype
    )
