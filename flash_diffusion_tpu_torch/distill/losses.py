"""Distillation, DMD and adversarial losses.

Port of ``flash_diffusion_tpu/distill/losses.py:21-134``. ``gan_losses``
keeps the JAX stop-gradient partition, so that one backward of
loss_G + loss_D yields both updates: loss_G reaches the discriminator only
through detached parameters (``torch.func.functional_call``) and so
updates the generator alone; loss_D sees detached features and so updates
the discriminator alone.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error, then batch mean."""
    return torch.square(a - b).reshape(a.shape[0], -1).mean(dim=1).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).reshape(a.shape[0], -1).mean(dim=1).mean()


def huber_loss(a: torch.Tensor, b: torch.Tensor, c: float = 0.001) -> torch.Tensor:
    """Pseudo-huber (the LCM paper's distill loss)."""
    return (torch.sqrt(torch.square(a - b) + c * c) - c).mean()


def center_crop(x: torch.Tensor, size: int = 64) -> torch.Tensor:
    """Center-crop NHWC latents to ``size``²."""
    h, w = x.shape[1], x.shape[2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[:, top: top + size, left: left + size, :]


def dmd_loss(
    student_output: torch.Tensor, real_noise_pred: torch.Tensor, fake_noise_pred: torch.Tensor,
    pred_x0_from_real: torch.Tensor, alpha_prod_t: torch.Tensor, weighted: bool = True,
) -> torch.Tensor:
    """Distribution Matching Distillation loss; the noise predictions come
    in detached, the weight and the target are detached here."""
    score_diff = real_noise_pred - fake_noise_pred
    if weighted:
        ap = alpha_prod_t.reshape((-1,) + (1,) * (student_output.dim() - 1))
        coeff = score_diff * torch.sqrt(1.0 - ap) / torch.sqrt(ap)
    else:
        coeff = score_diff
    dims = tuple(range(1, student_output.dim()))
    weight = 1.0 / (torch.abs(student_output - pred_x0_from_real).mean(dim=dims, keepdim=True) + 1e-5)
    target = (student_output - weight.detach() * coeff).detach()
    return torch.square(student_output - target).mean()


def gan_losses(
    disc: nn.Module, fake_features: torch.Tensor, real_features: torch.Tensor,
    loss_type: str = "hinge",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_G, loss_D) for the five GAN variants; ``disc(features)`` gives
    [B, N] logits. WGAN weight clipping is the caller's job after the update."""
    frozen = {k: p.detach() for k, p in disc.named_parameters()}
    d_fake_g = functional_call(disc, frozen, (fake_features,))  # grads → generator
    d_fake_d = disc(fake_features.detach())  # grads → discriminator
    d_real = disc(real_features.detach())
    if loss_type == "wgan":
        return -d_fake_g.mean(), -d_real.mean() + d_fake_d.mean()
    if loss_type == "lsgan":
        loss_g = torch.square(torch.sigmoid(d_fake_g) - 1.0).mean()
        loss_d = 0.5 * (torch.square(torch.sigmoid(d_real) - 1.0).mean()
                        + torch.square(torch.sigmoid(d_fake_d)).mean())
        return loss_g, loss_d
    if loss_type == "hinge":
        return -d_fake_g.mean(), F.relu(1.0 - d_real).mean() + F.relu(1.0 + d_fake_d).mean()
    if loss_type == "non-saturating":
        loss_g = -torch.log(torch.sigmoid(d_fake_g) + 1e-8).mean()
        loss_d = -(torch.log(torch.sigmoid(d_real) + 1e-8)
                   + torch.log(1.0 - torch.sigmoid(d_fake_d) + 1e-8)).mean()
        return loss_g, loss_d
    if loss_type == "vanilla":
        bce = lambda logits, target: (
            torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
        ).mean()
        return bce(d_fake_g, 1.0), bce(d_real, 1.0) + bce(d_fake_d, 0.0)
    raise ValueError(f"Unknown gan_loss_type {loss_type!r}")


@torch.no_grad()
def clip_disc_weights(disc: nn.Module, limit: float = 0.01) -> None:
    """WGAN weight clipping, in place, after the update."""
    for p in disc.parameters():
        p.clamp_(-limit, limit)
