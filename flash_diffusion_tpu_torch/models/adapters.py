"""T2I-Adapter of the PyTorch port: a control image → one residual per UNet down level.

Port of ``flash_diffusion_tpu/models/adapters.py:24-72``: pixel-unshuffle
×8, ``conv_in``, then per level (a stride-2 3×3 ``down_{lvl}`` conv from
level 1 on) ``num_res_blocks`` residual blocks (3×3 ``block1``, ReLU, 3×3
``block2``), each level's output kept. The module names are JAX's
(``conv_in``, ``down_{lvl}``, ``res_{lvl}_{j}.block1/2``): no published
checkpoint fits this architecture (diffusers' ``FullAdapter`` downsamples
with AvgPool, has a 1×1 ``in_conv`` and ``block2``, and orders the
unshuffled channels otherwise), so ``utils/convert.py adapter_from_jax`` is
its only importer.

The layout at the boundary is the JAX package's: ``forward(control [B, H,
W, 3])`` returns NHWC features [B, H/8·2⁻ˡ, W/8·2⁻ˡ, channels[l]] (views of
channel-first tensors, so the UNet's permute back is free). The compute
dtype is the parameters' (cast the module with ``.to``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BaseConfig


@dataclasses.dataclass
class T2IAdapterConfig(BaseConfig):
    in_channels: int = 3
    channels: List[int] = field(default_factory=lambda: [320, 640, 1280, 1280])
    num_res_blocks: int = 2
    downscale_factor: int = 8


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H/f, W/f, f·f·C] with the channels ordered (i, j, c),
    as JAX's NHWC ``pixel_unshuffle``; ``F.pixel_unshuffle`` orders them
    (c, i, j), so the two differ whenever C > 1."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // factor, w // factor, factor * factor * c)


class _AdapterResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.block2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block2(F.relu(self.block1(x)))


class T2IAdapter(nn.Module):
    """``forward(control [B, H, W, C])`` → the list of NHWC features, one per
    level of ``config.channels``."""

    def __init__(self, config: T2IAdapterConfig):
        super().__init__()
        self.config = cfg = config
        ch_in = cfg.in_channels * cfg.downscale_factor ** 2
        for lvl, ch in enumerate(cfg.channels):
            if lvl == 0:
                self.conv_in = nn.Conv2d(ch_in, ch, 3, padding=1)
            else:
                setattr(self, f"down_{lvl}", nn.Conv2d(ch_in, ch, 3, stride=2, padding=1))
            for j in range(cfg.num_res_blocks):
                setattr(self, f"res_{lvl}_{j}", _AdapterResBlock(ch))
            ch_in = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.config
        x = pixel_unshuffle(x.to(self.conv_in.weight.dtype), cfg.downscale_factor).permute(0, 3, 1, 2)
        features = []
        for lvl in range(len(cfg.channels)):
            x = (self.conv_in if lvl == 0 else getattr(self, f"down_{lvl}"))(x)
            for j in range(cfg.num_res_blocks):
                x = getattr(self, f"res_{lvl}_{j}")(x)
            features.append(x.permute(0, 2, 3, 1))
        return features
