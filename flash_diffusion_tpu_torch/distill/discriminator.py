"""Latent-feature conv discriminator.

Port of ``flash_diffusion_tpu/distill/discriminator.py:23-72``: repeated
[conv k4 s2 → GroupNorm(norm_groups) → SiLU] stages (no norm on the first)
and a valid k4 conv to one logit per position, flattened to [B, N]. NHWC in
(the teacher's mid features), fp32 compute, as the JAX module's default
dtype. Unlike flax, a torch module needs its input width up front
(``in_channels``: 1280 for the SD1.5 and SDXL mid blocks, 4 over Pixart's
output latents, 16 over SD3's post-mid features).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BaseConfig
from ..ops import group_norm


@dataclasses.dataclass
class DiscriminatorConfig(BaseConfig):
    feature_dim: int = 256
    num_stages: int = 3
    norm_groups: int = 4


def sd3_discriminator_config(**kw) -> DiscriminatorConfig:
    """SD3's: 64 features, 4 stages (JAX ``discriminator.py:34``), over the
    MMDiT's 16-channel post-mid features ([B, 128, 128, 16] at 1024²)."""
    return DiscriminatorConfig(**{"feature_dim": 64, "num_stages": 4, **kw})


class ConvDiscriminator(nn.Module):
    def __init__(self, config: DiscriminatorConfig, in_channels: int):
        super().__init__()
        self.config = cfg = config
        ch = in_channels
        for i in range(cfg.num_stages):
            out = cfg.feature_dim * 2**i
            setattr(self, f"conv_{i}", nn.Conv2d(ch, out, 4, stride=2, padding=1, bias=False))
            if i > 0:
                setattr(self, f"gn_{i}_scale", nn.Parameter(torch.ones(out)))
                setattr(self, f"gn_{i}_bias", nn.Parameter(torch.zeros(out)))
            ch = out
        self.conv_out = nn.Conv2d(ch, 1, 4, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = x.float().permute(0, 3, 1, 2)
        for i in range(cfg.num_stages):
            h = getattr(self, f"conv_{i}")(h)
            if i > 0:
                h = group_norm(h, cfg.norm_groups, getattr(self, f"gn_{i}_scale"),
                               getattr(self, f"gn_{i}_bias"))
            h = F.silu(h)
        if h.shape[2] < 4 or h.shape[3] < 4:
            raise ValueError(
                f"discriminator input too small: features reduced to {h.shape[2]}x{h.shape[3]} "
                f"before the 4x4 valid head; reduce num_stages or feed larger feature maps")
        return self.conv_out(h).reshape(h.shape[0], -1).float()
