"""AutoencoderKL (the SD-family VAE) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/vae.py`` with diffusers
``AutoencoderKL`` module names (``encoder.*``, ``quant_conv``,
``decoder.*``, ``post_quant_conv``), so the keys match the published
checkpoints. ``encode`` takes NHWC images and ``decode_latents`` NHWC
latents, and both return fp32 NHWC, as in JAX. SD1.5 and SDXL share the
architecture and differ in ``scaling_factor``. SD3's VAE
(``sd3_vae_config``) has 16 latent channels, no quant convs
(``use_quant_conv=False``: no such modules and no such keys, as in its
checkpoints) and a shift: ``encode`` gives (z − shift)·scaling and
``decode_latents`` un-scales z / scaling + shift (with per-channel
``latents_mean``/``latents_std``, where given, z·std / scaling + mean). The
mid-block attention is single-head with D = C (512 at full width; 16384
tokens at 1024²), which runs on the streaming flash kernels.
``tiled_decode`` decodes a latent larger than ``tiling_size`` in
overlapping tiles stacked into one batched ``decode_latents`` call, blended
with pyramid weights (JAX ``vae.py:191-243``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BaseConfig
from .layers import Attention, GroupNorm, ResnetBlock2D, Upsample2D


@dataclasses.dataclass
class AutoencoderKLConfig(BaseConfig):
    """The JAX ``AutoencoderKLConfig`` fields the SD VAE uses."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: List[int] = field(default_factory=lambda: [128, 256, 512, 512])
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # SDXL: 0.13025, SD3: 1.5305
    latents_mean: Optional[List[float]] = None  # a per-channel shift (decode only)
    latents_std: Optional[List[float]] = None
    shift_factor: Optional[float] = None  # the scalar shift (SD3: 0.0609)
    # SD1.5/SDXL carry 1×1 quant/post-quant convs around the latent; SD3's
    # VAE has neither
    use_quant_conv: bool = True
    # False: no attention in the mid blocks (diffusers' mid_block_add_attention)
    mid_block_attn: bool = True
    # tiled decode (``tiled_decode``): latent tile and overlap, (h, w)
    tiling_size: Tuple[int, int] = (64, 64)
    tiling_overlap: Tuple[int, int] = (8, 8)

    @property
    def downsampling_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def sd_vae_config(**overrides) -> AutoencoderKLConfig:
    return AutoencoderKLConfig(**overrides)


def sd3_vae_config(**overrides) -> AutoencoderKLConfig:
    """SD3's VAE: 16 latent channels, scaling 1.5305, shift 0.0609, no quant convs."""
    base = dict(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False)
    base.update(overrides)
    return AutoencoderKLConfig(**base)


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
    def __init__(self, ch: int, groups: int, attn: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, groups, eps=1e-6) for _ in range(2)]
        )
        if attn:
            self.attentions = nn.ModuleList([_AttnBlock(ch, groups)])

    def forward(self, h):
        h = self.resnets[0](h)
        if hasattr(self, "attentions"):
            h = self.attentions[0](h)
        return self.resnets[1](h)


class _Downsample(nn.Module):
    """The diffusers VAE downsample: an asymmetric (0, 1) pad, then a
    stride-2 3×3 conv without padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, resnets, downsample: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])


class Encoder(nn.Module):
    """Image [B, 3, H, W] → moments [B, 2·latent, H/8, W/8], channel-first."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        cfg = config
        g = cfg.norm_num_groups
        n = len(cfg.block_out_channels)
        ch = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for lvl, out_ch in enumerate(cfg.block_out_channels):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps=1e-6))
                ch = out_ch
            self.down_blocks.append(_DownBlock(resnets, _Downsample(ch) if lvl < n - 1 else None))
        self.mid_block = _MidBlock(ch, g, cfg.mid_block_attn)
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        return self.conv_out(self.conv_norm_out(self.mid_block(h)))


class Decoder(nn.Module):
    """Latent [B, C, h, w] → image [B, 3, 8h, 8w], channel-first."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        cfg = config
        g = cfg.norm_num_groups
        n = len(cfg.block_out_channels)
        ch = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch, g, cfg.mid_block_attn)
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
    """The VAE: ``encoder``, ``decoder`` and, with ``use_quant_conv``,
    ``quant_conv`` and ``post_quant_conv``."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        lat = config.latent_channels
        quant = config.use_quant_conv
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1) if quant else nn.Identity()
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1) if quant else nn.Identity()

    def moments(self, x: torch.Tensor):
        """(mean, logvar clipped to [-30, 20]) of NHWC images, NHWC, in the
        compute dtype."""
        dtype = self.encoder.conv_in.weight.dtype
        m = self.quant_conv(self.encoder(x.to(dtype).permute(0, 3, 1, 2)))
        mean, logvar = m.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior sample mean + exp(logvar / 2)·noise (the mode when
        ``noise`` is None), less ``shift_factor`` where set, times
        ``scaling_factor``: fp32 NHWC latents. ``noise`` ([B, H/8, W/8,
        latent]) stands for the JAX ``rng`` draw."""
        mean, logvar = self.moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        latents = mean.float()
        if self.config.shift_factor is not None:
            latents = latents - self.config.shift_factor
        return latents * self.config.scaling_factor

    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Un-scale (with SD3's per-channel mean and std, or its scalar
        shift, where set) and decode NHWC latents; returns fp32 NHWC images."""
        cfg = self.config
        dtype = self.decoder.conv_in.weight.dtype
        z = z.float()
        if cfg.latents_mean is not None and cfg.latents_std is not None:
            mean, std = (torch.tensor(v, dtype=torch.float32, device=z.device) for v in (cfg.latents_mean,
                                                                                         cfg.latents_std))
            z = z * std / cfg.scaling_factor + mean
        elif cfg.shift_factor is not None:
            z = z / cfg.scaling_factor + cfg.shift_factor
        else:
            z = z / cfg.scaling_factor
        h = self.post_quant_conv(z.to(dtype).permute(0, 3, 1, 2))
        return self.decoder(h).float().permute(0, 2, 3, 1).contiguous()


def tiled_decode(vae: AutoencoderKL, z: torch.Tensor, tile: Optional[Tuple[int, int]] = None,
                 overlap: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Decode NHWC latents ``z`` [B, h, w, C] in overlapping tiles (JAX
    ``tiled_decode``): fp32 NHWC images, as ``decode_latents``.

    A latent that fits one tile (``tile``, default the config's
    ``tiling_size``) decodes whole. Else tiles of ``tile`` step by tile −
    ``overlap`` (default ``tiling_overlap``), ceil((h − oh) / step) rows
    of them by ceil((w − ow) / step) columns; a tile starts at min(i·step,
    h − th), so the last one is clamped to the edge. The tiles, stacked
    tile-major ([tile, sample] order), go through one ``decode_latents``
    call; each decoded tile is weighted by a pyramid over the whole tile,
    min(i + 1, n − i) along each axis of its n pixels (the smaller of the
    two), summed into place, and the sum divided by the summed weights
    (floored at 1e-8)."""
    cfg = vae.config
    th, tw = tile or cfg.tiling_size
    oh, ow = overlap or cfg.tiling_overlap
    b, h, w, _ = z.shape
    if h <= th and w <= tw:
        return vae.decode_latents(z)
    f = cfg.downsampling_factor
    step_h, step_w = th - oh, tw - ow
    rows = max(1, -(-(h - oh) // step_h))
    cols = max(1, -(-(w - ow) // step_w))
    coords = [(min(i * step_h, max(h - th, 0)), min(j * step_w, max(w - tw, 0)))
              for i in range(rows) for j in range(cols)]
    decoded = vae.decode_latents(torch.cat([z[:, y:y + th, x:x + tw] for y, x in coords]))
    ph, pw = decoded.shape[1:3]  # th·f and tw·f, or less where the latent is smaller than a tile
    ramp = lambda n: torch.minimum(torch.arange(n, device=z.device) + 1,
                                   torch.arange(n, device=z.device).flip(0) + 1).float()
    wmask = torch.minimum(ramp(ph)[:, None], ramp(pw)[None, :])[None, :, :, None]
    out = torch.zeros(b, h * f, w * f, cfg.out_channels, device=z.device)
    weight = torch.zeros(1, h * f, w * f, 1, device=z.device)
    for idx, (y, x) in enumerate(coords):
        out[:, y * f:y * f + ph, x * f:x * f + pw] += decoded[idx * b:(idx + 1) * b] * wmask
        weight[:, y * f:y * f + ph, x * f:x * f + pw] += wmask
    return out / weight.clamp_min(1e-8)
