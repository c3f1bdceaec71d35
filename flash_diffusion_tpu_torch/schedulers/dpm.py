"""DPM-Solver++ (2M, multistep) — the SDXL teacher's scheduler in Flash distillation.

Port of ``flash_diffusion_tpu/schedulers/dpm.py:43-160`` (diffusers
``DPMSolverMultistepScheduler`` with ``algorithm_type="dpmsolver++"``,
``solver_order=2`` (midpoint), ``final_sigmas_type="zero"``,
``lower_order_final=True``). The tables are built in float64 numpy and
stored as float32 tensors, as the JAX schedule holds them; each step's
coefficients are formed from them in float32, in JAX's order, and applied
as Python scalars.

The multistep state (the previous x̂₀ and whether there is one) is an
explicit carry: ``init_state`` starts it, ``step`` returns the next one. A
fresh carry makes the first *executed* step first order wherever the
rollout enters, as diffusers resets ``lower_order_nums`` on every fresh
rollout (JAX ``dpm.py:84-97``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .base import SchedulerConfig, interp_sigma, spaced_timesteps, training_tables

State = Tuple[torch.Tensor, bool]  # (previous x̂₀, has history)


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    timesteps: List[int]  # [n], descending
    alphas_cumprod: torch.Tensor  # [T] fp32, the full training table (add_noise)
    sigmas: torch.Tensor  # [n + 1] fp32, sqrt((1 − ᾱ)/ᾱ) at each timestep, then the terminal one
    alpha_t: torch.Tensor  # [n + 1] fp32, 1 / sqrt(σ² + 1)
    sigma_t: torch.Tensor  # [n + 1] fp32, σ·alpha_t
    lambda_t: torch.Tensor  # [n + 1] fp32, log(alpha_t / sigma_t), the terminal σ = 0 guarded
    prediction_type: str
    init_noise_sigma: float = 1.0

    @property
    def num_inference_steps(self) -> int:
        return len(self.timesteps)


def set_timesteps(config: SchedulerConfig, num_inference_steps: int) -> DPMSchedule:
    """The schedule of ``num_inference_steps`` positions. Only the 2M solver
    with a first-order last step is implemented (as in JAX): any other
    ``solver_order``, ``lower_order_final`` or ``euler_at_final`` raises."""
    if (config.solver_order, config.lower_order_final, config.euler_at_final) != (2, True, False):
        raise ValueError(
            "DPM-Solver++ implements solver_order=2, lower_order_final=True, euler_at_final=False; got "
            f"{config.solver_order}, {config.lower_order_final}, {config.euler_at_final}")
    if config.final_sigmas_type not in ("zero", "sigma_min"):
        raise ValueError(f"final_sigmas_type {config.final_sigmas_type!r}: 'zero' or 'sigma_min'")
    acp, _, _ = training_tables(config)
    sigmas_all = np.sqrt((1.0 - acp) / acp)
    timesteps = spaced_timesteps(
        config.num_train_timesteps, num_inference_steps, config.timestep_spacing, config.steps_offset,
    )
    sigmas = interp_sigma(timesteps.astype(np.float64), sigmas_all)
    sigmas = np.append(sigmas, 0.0 if config.final_sigmas_type == "zero" else sigmas_all[0])
    alpha_t = 1.0 / np.sqrt(sigmas**2 + 1.0)
    sigma_t = sigmas * alpha_t
    # the terminal σ = 0 is guarded; the last step never reads its lambda
    # but through exp(−h) ≈ 0 (the σ_t → 0 limit)
    lam = np.log(alpha_t) - np.log(np.where(sigma_t > 0, sigma_t, 1e-10))

    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    return DPMSchedule(
        timesteps=[int(t) for t in timesteps],
        alphas_cumprod=f32(acp),
        sigmas=f32(sigmas),
        alpha_t=f32(alpha_t),
        sigma_t=f32(sigma_t),
        lambda_t=f32(lam),
        prediction_type=config.prediction_type,
    )


def scale_model_input(schedule: DPMSchedule, sample: torch.Tensor, i: int) -> torch.Tensor:
    del schedule, i
    return sample


def init_state(sample: torch.Tensor) -> State:
    """A fresh multistep carry: no x̂₀ history, so the next step is first order."""
    return torch.zeros_like(sample), False


def convert_model_output(
    schedule: DPMSchedule, model_output: torch.Tensor, i: int, sample: torch.Tensor,
) -> torch.Tensor:
    """The model output at position ``i`` as a data (x̂₀) prediction."""
    alpha, sigma = float(schedule.alpha_t[i]), float(schedule.sigma_t[i])
    if schedule.prediction_type == "epsilon":
        return (sample - sigma * model_output) / alpha
    if schedule.prediction_type == "v_prediction":
        return alpha * sample - sigma * model_output
    if schedule.prediction_type == "sample":
        return model_output
    raise ValueError(schedule.prediction_type)


def step(
    schedule: DPMSchedule, model_output: torch.Tensor, i: int, sample: torch.Tensor, state: State,
) -> Tuple[torch.Tensor, State]:
    """One DPM-Solver++ 2M step from position ``i``: (prev_sample, new carry).

    First order (x = (σ_next/σ)·x − α_next·(e^{−h} − 1)·x̂₀, in the VP
    sigmas σ_t) where the carry has no history and at the final position
    (``lower_order_final``; with the terminal σ = 0 it is x̂₀); else the
    midpoint second-order update with D1 = (x̂₀ − x̂₀_prev) / r0, r0 = 1
    where h_prev = 0."""
    prev_x0, has_hist = state
    x0 = convert_model_output(schedule, model_output, i, sample)
    lam, sig = schedule.lambda_t, schedule.sigma_t
    h = lam[i + 1] - lam[i]
    phi = torch.exp(-h) - 1.0
    a_next = schedule.alpha_t[i + 1]
    prev = float(sig[i + 1] / sig[i]) * sample - float(a_next * phi) * x0
    if has_hist and i != schedule.num_inference_steps - 1:
        h_prev = lam[i] - lam[max(i - 1, 0)]
        r0 = float(h_prev / h) if float(h_prev) != 0 else 1.0
        prev = prev - float(0.5 * a_next * phi) * ((x0 - prev_x0) / r0)
    return prev, (x0, True)
