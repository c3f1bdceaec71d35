"""Shared distillation machinery: stage schedule, timestep distribution,
boundary scalings, x̂₀ prediction.

Port of ``flash_diffusion_tpu/distill/common.py:20-103``. The start-index
pdfs are host-side numpy tables built once per stage, as in JAX; the start
index itself is one categorical draw for the whole batch, taken on the host
(the teacher rollout is a Python loop from it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def gaussian_mixture_pdf(
    k: int, num_components: int, var: float, mode_probs: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Mixture-of-Gaussians pdf over K teacher-step indices, component means
    at ``i · (K // num_components)``, normalized."""
    if mode_probs is None:
        mode_probs = [1.0 / num_components] * num_components
    locs = [i * (k // num_components) for i in range(num_components)]
    xs = np.arange(k, dtype=np.float64)
    pdf = np.zeros(k, dtype=np.float64)
    for p, loc in zip(mode_probs, locs):
        pdf += p * np.exp(-((xs - loc) ** 2) / var)
    return pdf / pdf.sum()


def timestep_pdf(
    distribution: str, k: int, num_components: int = 4, var: float = 0.5,
    mode_probs: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Start-index pdf over the K-step teacher schedule."""
    if distribution == "uniform":
        return np.full(k, 1.0 / k)
    if distribution == "gaussian":
        xs = np.arange(k, dtype=np.float64)
        pdf = np.exp(-((xs - k / 2) ** 2) / k)
        return pdf / pdf.sum()
    if distribution == "mixture":
        return gaussian_mixture_pdf(k, num_components, var, mode_probs)
    raise ValueError(f"Unknown timestep_distribution {distribution!r}")


def sample_start_index(pdf: np.ndarray, generator: Optional[torch.Generator] = None) -> int:
    """One categorical draw shared by the whole batch, as a host int."""
    device = generator.device if generator is not None else "cpu"
    probs = torch.as_tensor(np.asarray(pdf, np.float32) + 1e-20, device=device)
    return int(torch.multinomial(probs, 1, generator=generator).item())


def stage_index(iter_step: int, num_iterations_per_k: Sequence[int]) -> int:
    """Which stage a (1-based) iteration belongs to; the final iteration
    stays in the last stage."""
    cum = np.cumsum(num_iterations_per_k)
    if iter_step >= cum[-1]:
        return len(cum) - 1
    return int(np.argmax(iter_step < cum))


def boundary_scalings(timestep: torch.Tensor, sigma_data: float = 0.5, timestep_scaling: float = 10.0):
    """LCM boundary conditions (c_skip, c_out) in fp32."""
    scaled = timestep.float() * timestep_scaling
    c_skip = sigma_data**2 / (scaled**2 + sigma_data**2)
    c_out = scaled / torch.sqrt(scaled**2 + sigma_data**2)
    return c_skip, c_out


def predicted_x0_eps(
    model_output: torch.Tensor, timesteps: torch.Tensor, sample: torch.Tensor,
    sqrt_acp: torch.Tensor, sqrt_1macp: torch.Tensor, input_sample: torch.Tensor,
) -> torch.Tensor:
    """ε-parameterized x̂₀ from the full training tables; where ᾱ_t = 0 the
    prediction falls back to ``input_sample``."""
    shape = (-1,) + (1,) * (sample.dim() - 1)
    a = sqrt_acp.to(sample.device)[timesteps].reshape(shape)
    s = sqrt_1macp.to(sample.device)[timesteps].reshape(shape)
    x0 = (sample - s * model_output) / torch.where(a > 0, a, torch.ones_like(a))
    return torch.where(a > 0, x0, input_sample)
