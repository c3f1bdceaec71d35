"""AutoencoderKL (the SD-family VAE) of the PyTorch port: the decode path.

Port of ``flash_diffusion_tpu/models/vae.py`` with diffusers
``AutoencoderKL`` module names (``decoder.*``, ``post_quant_conv``), so the
keys match the published checkpoints. ``decode_latents`` takes NHWC latents
and returns fp32 NHWC images, as in JAX. SD1.5 and SDXL share the
architecture and differ in ``scaling_factor``. The mid-block attention is
single-head with D = C (512 at full width; 16384 tokens at 1024²), which
runs on the streaming flash kernel. Not ported yet: the encoder, ``quant_conv``, the SD3
shift/scale variant and tiled decode.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import List, Optional

import torch
import torch.nn as nn

from ..config import BaseConfig
from .layers import Attention, GroupNorm, ResnetBlock2D, Upsample2D


@dataclasses.dataclass
class AutoencoderKLConfig(BaseConfig):
    """The JAX ``AutoencoderKLConfig`` fields the SD decoder uses."""

    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: List[int] = field(default_factory=lambda: [128, 256, 512, 512])
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # SDXL: 0.13025


def sd_vae_config(**overrides) -> AutoencoderKLConfig:
    return AutoencoderKLConfig(**overrides)


class _AttnBlock(Attention):
    """VAE mid-block attention: GN → single-head attention over HW tokens.

    Subclasses ``Attention`` so that ``to_q``…``to_out`` sit beside
    ``group_norm``, as in diffusers."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(channels, num_heads=1, qkv_bias=True)
        self.group_norm = GroupNorm(channels, groups, eps=1e-6)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        out = super().forward(tokens)
        return out.transpose(1, 2).reshape(b, c, h, w) + x


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, groups, eps=1e-6) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([_AttnBlock(ch, groups)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Decoder(nn.Module):
    """Latent [B, C, h, w] → image [B, 3, 8h, 8w], channel-first."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        cfg = config
        g = cfg.norm_num_groups
        n = len(cfg.block_out_channels)
        ch = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch, g)
        self.up_blocks = nn.ModuleList()
        for i, lvl in enumerate(reversed(range(n))):
            out_ch = cfg.block_out_channels[lvl]
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps=1e-6))
                ch = out_ch
            self.up_blocks.append(_UpBlock(resnets, Upsample2D(ch) if i < n - 1 else None))
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """The VAE's decode half: ``post_quant_conv`` and ``decoder``."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Un-scale and decode NHWC latents; returns fp32 NHWC images."""
        dtype = self.decoder.conv_in.weight.dtype
        z = z.float() / self.config.scaling_factor
        h = self.post_quant_conv(z.to(dtype).permute(0, 3, 1, 2))
        return self.decoder(h).float().permute(0, 2, 3, 1).contiguous()
