"""Flow-matching Euler schedulers of the SD3 (rectified flow) family.

Port of ``flash_diffusion_tpu/schedulers/flow_match.py``: diffusers'
``FlowMatchEulerDiscreteScheduler`` tables (σ(t) = t/T warped by
σ ← s·σ / (1 + (s − 1)·σ)), the training noising ``σ·noise + (1 − σ)·x``,
the plain Euler step ``x += (σ_{i+1} − σ_i)·v`` and ``flash_step``, the
Flash student's few-step sampler (``FlashFlowMatchEulerDiscreteScheduler``):
predict x̂₀ = x − σ·v, then re-noise to σ_{i+1} with fresh noise (the
denoised sample at the final step, where σ_{i+1} = 0).

Timesteps are floats (σ·T), not integers. Without an explicit grid the
inference sigmas are shifted twice, as diffusers does: the training table is
shifted once, and the linspace between its ends is shifted again. An
explicit ``timesteps`` grid is taken as it is. Coefficients are the JAX
schedule's float32 values, applied as Python scalars; a step takes its noise
as a tensor (None: zeros), as the other schedulers of the port do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .base import SchedulerConfig


def _shift_sigma(sigma: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigma / (1.0 + (shift - 1.0) * sigma)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    timesteps: List[float]  # [n] σ·T, descending
    sigmas: List[float]  # [n + 1], the terminal 0 last
    one_minus_sigmas: List[float]  # [n + 1] 1 − σ in fp32 (the re-noise weight of x̂₀)
    sigma_deltas: List[float]  # [n] σ_{i+1} − σ_i in fp32 (the Euler step)
    sigmas_train: torch.Tensor  # [T] fp32, the shifted training table
    timesteps_train: torch.Tensor  # [T] fp32, σ·T of each training step
    init_noise_sigma: float = 1.0

    @property
    def num_inference_steps(self) -> int:
        return len(self.timesteps)


def set_timesteps(
    config: SchedulerConfig,
    num_inference_steps: Optional[int] = None,
    timesteps: Optional[Sequence[float]] = None,
) -> FlowMatchSchedule:
    """The schedule of ``num_inference_steps`` steps (diffusers' grid, shifted
    twice), or of an explicit descending ``timesteps`` grid (not shifted)."""
    T = config.num_train_timesteps
    t_train = np.linspace(1, T, T, dtype=np.float64)[::-1]
    sig_train = _shift_sigma(t_train / T, config.shift)
    if timesteps is None:
        ts_lin = np.linspace(sig_train[0] * T, sig_train[-1] * T, num_inference_steps)
        sigmas = _shift_sigma(ts_lin / T, config.shift)
        ts = sigmas * T
    else:
        ts = np.asarray(timesteps, np.float64)
        sigmas = ts / T
    sig32 = np.append(sigmas, 0.0).astype(np.float32)

    f32 = lambda x: [float(v) for v in np.asarray(x, np.float32)]
    t32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    return FlowMatchSchedule(
        timesteps=f32(ts),
        sigmas=f32(sig32),
        one_minus_sigmas=f32(np.float32(1.0) - sig32),
        sigma_deltas=f32(sig32[1:] - sig32[:-1]),
        sigmas_train=t32(sig_train),
        timesteps_train=t32(sig_train * T),
    )


def scale_model_input(schedule: FlowMatchSchedule, sample: torch.Tensor, i: int) -> torch.Tensor:
    del schedule, i
    return sample


def get_sigmas(schedule: FlowMatchSchedule, timesteps: torch.Tensor) -> torch.Tensor:
    """σ of (batched, float) training timesteps: the nearest entry of the
    training table, as the JAX ``get_sigmas`` matches it."""
    table = schedule.timesteps_train.to(timesteps.device)
    idx = torch.argmin((table[None, :] - timesteps.reshape(-1, 1).float()).abs(), dim=-1)
    return schedule.sigmas_train.to(timesteps.device)[idx]


def add_noise(schedule: FlowMatchSchedule, sample: torch.Tensor, noise: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """The rectified-flow interpolation σ·noise + (1 − σ)·x, with a per-sample
    σ broadcast over the trailing dims."""
    del schedule
    sigma = torch.as_tensor(sigma, device=sample.device).to(sample.dtype)
    sigma = sigma.reshape(sigma.shape + (1,) * (sample.dim() - sigma.dim()))
    return sigma * noise.to(sample.dtype) + (1.0 - sigma) * sample


def step(
    schedule: FlowMatchSchedule,
    model_output: torch.Tensor,
    i: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain flow-match Euler step x + (σ_{i+1} − σ_i)·v (no noise)."""
    del noise
    return sample + schedule.sigma_deltas[i] * model_output


def flash_step(
    schedule: FlowMatchSchedule,
    model_output: torch.Tensor,
    i: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The Flash few-step step: x̂₀ = x − σ_i·v, then (1 − σ_{i+1})·x̂₀ +
    σ_{i+1}·noise (zeros when ``noise`` is None); at the final position
    σ_{i+1} = 0 and the denoised sample comes out."""
    x0 = sample - schedule.sigmas[i] * model_output
    out = schedule.one_minus_sigmas[i + 1] * x0
    if noise is not None and schedule.sigmas[i + 1] != 0.0:
        out = out + schedule.sigmas[i + 1] * noise.to(sample.dtype)
    return out
