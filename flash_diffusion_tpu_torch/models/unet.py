"""UNet denoiser (SD1.5 and SDXL) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/unet.py`` with diffusers
``UNet2DConditionModel`` module names, so ``state_dict()`` keys match the
published checkpoints and ``utils/hf.py::import_unet``. The public layout is
the JAX package's: ``forward(sample [B, H, W, C], timestep [B], conditioning)``
returns fp32 [B, H, W, C]; inside, convolutions run channel-first. The
compute dtype is the parameters' dtype (cast the module with ``.to``).

Covers SD1.5 and SDXL: ``CrossAttnDownBlock2D``/``DownBlock2D`` levels with
``transformer_layers_per_block`` transformer blocks each (SDXL: none at
level 0, 2 at level 1, 10 at level 2 and in the mid block), 1×1-conv or
linear (``use_linear_projection``) ``proj_in``/``proj_out``, and SDXL's
projection class embedding: ``conditioning["cond"]["vector"]`` goes through
``add_embedding`` (the diffusers SDXL name; JAX ``class_embedding``) and is
added to the time embedding. ``return_features=True`` also returns the
mid block's output (the GAN's tap), and ``config.remat`` recomputes each
resnet and spatial transformer in the backward (``torch.utils.checkpoint``,
non-reentrant; the JAX ``nn.remat`` of the same blocks) whenever autograd
records. ``adapter_residuals`` (a T2I-Adapter's NHWC features, one per
level) are added after each down level's last resnet/attention pair,
before its downsample and into its skip, as in JAX (``unet.py:181-182``);
``conditioning["cond"]["concat"]`` [B, H, W, c] is concatenated to the
latents' channels before ``conv_in``, whose input is then
``in_channels + concat_channels`` wide (JAX's infers it; widen a
checkpoint's with ``trainer/checkpoint.py adapt_state_dict``).
``AttnDownBlock2D`` levels (JAX ``unet.py:163-164,209-210``) take the
spatial transformer of a cross-attention level without ``attn2``/``norm2``
(self-attention and feed-forward: the JAX ``cross_attention=False``
block, which diffusers' own ``AttnDownBlock2D`` is not), and with
``cross_attention_dim=None`` the mid block's is such a block too and the
conditioning may be None: the weights-free toy UNet of
``toy_quality.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..config import BaseConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SpatialTransformer,
    TimestepEmbedMLP,
    Upsample2D,
    remat_call,
    timestep_embedding,
)


@dataclasses.dataclass
class UNetConfig(BaseConfig):
    """The JAX ``UNetConfig`` fields that SD1.5 and SDXL use, and
    ``use_linear_projection`` (the layout of the checkpoints' ``proj_in``/
    ``proj_out``; the JAX package keeps a Dense for both)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: List[int] = field(default_factory=lambda: [320, 640, 1280, 1280])
    down_block_types: List[str] = field(
        default_factory=lambda: ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]
    )
    layers_per_block: int = 2
    transformer_layers_per_block: List[int] = field(default_factory=lambda: [1, 1, 1, 1])
    num_heads: List[int] = field(default_factory=lambda: [8, 8, 8, 8])
    cross_attention_dim: Optional[int] = 768  # None: no cross-attention anywhere
    norm_num_groups: int = 32
    class_embed_type: Optional[str] = None  # None | "projection"
    projection_class_embeddings_input_dim: Optional[int] = None
    use_linear_projection: bool = False
    remat: bool = False
    concat_channels: int = 0  # channels of a ``concat`` conditioning
    # False: no attention in the mid block (diffusers' mid_block_add_attention)
    mid_block_attn: bool = True

    def __post_init__(self):
        super().__post_init__()
        n = len(self.block_out_channels)
        if isinstance(self.transformer_layers_per_block, int):
            self.transformer_layers_per_block = [self.transformer_layers_per_block] * n
        if isinstance(self.num_heads, int):
            self.num_heads = [self.num_heads] * n
        if len(self.down_block_types) != n or len(self.num_heads) != n:
            raise ValueError("down_block_types and num_heads need one entry per level")
        if len(self.transformer_layers_per_block) < n:  # the mid block takes the last, as in JAX
            raise ValueError("transformer_layers_per_block needs an entry per level")
        unknown = set(self.down_block_types) - {"CrossAttnDownBlock2D", "AttnDownBlock2D", "DownBlock2D"}
        if unknown:
            raise ValueError(f"block types not ported yet: {sorted(unknown)}")
        if self.cross_attention_dim is None and "CrossAttnDownBlock2D" in self.down_block_types:
            raise ValueError("CrossAttnDownBlock2D needs cross_attention_dim")
        if self.class_embed_type not in (None, "projection"):
            raise ValueError(f"class_embed_type {self.class_embed_type!r} not ported yet")
        if self.class_embed_type and not self.projection_class_embeddings_input_dim:
            raise ValueError("class_embed_type='projection' needs projection_class_embeddings_input_dim")


def sd15_unet_config(**overrides) -> UNetConfig:
    """Stable Diffusion 1.5 UNet architecture."""
    base = dict(
        block_out_channels=[320, 640, 1280, 1280],
        down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
        layers_per_block=2,
        num_heads=[8, 8, 8, 8],
        cross_attention_dim=768,
    )
    base.update(overrides)
    return UNetConfig(**base)


def sdxl_unet_config(**overrides) -> UNetConfig:
    """SDXL base UNet architecture: the vector conditioning (pooled CLIP-G
    text embedding and size embeddings, 2816 wide) through the projection
    class embedding, linear projections as in the published checkpoint."""
    base = dict(
        block_out_channels=[320, 640, 1280],
        down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
        layers_per_block=2,
        transformer_layers_per_block=[1, 2, 10],
        num_heads=[5, 10, 20],
        cross_attention_dim=2048,
        class_embed_type="projection",
        projection_class_embeddings_input_dim=2816,
        use_linear_projection=True,
    )
    base.update(overrides)
    return UNetConfig(**base)


class _Block(nn.Module):
    """One diffusers down/mid/up block: resnets, optional attentions and
    an optional resampler."""

    def __init__(self, resnets, attentions=None, sampler=None, sampler_name="downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet2DCondition(nn.Module):
    """The denoiser. ``forward(sample [B,H,W,C], timestep [B], conditioning)``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        g = cfg.norm_num_groups
        b0 = cfg.block_out_channels[0]
        temb_dim = b0 * 4
        n = len(cfg.block_out_channels)

        def attn(lvl, ch, depth=None, cross=True):
            return SpatialTransformer(
                ch, cfg.num_heads[lvl], cfg.cross_attention_dim if cross else None, g,
                depth=depth or cfg.transformer_layers_per_block[lvl],
                use_linear_projection=cfg.use_linear_projection,
            )

        def level_attns(btype, lvl, ch):
            """The attention of one resnet of a level: cross, self-only or none."""
            if btype == "DownBlock2D":
                return []
            return [attn(lvl, ch, cross=btype == "CrossAttnDownBlock2D")]

        self.conv_in = nn.Conv2d(cfg.in_channels + cfg.concat_channels, b0, 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(b0, temb_dim)
        if cfg.class_embed_type == "projection":
            self.add_embedding = TimestepEmbedMLP(cfg.projection_class_embeddings_input_dim, temb_dim)

        # channel bookkeeping of the skip stack, as the JAX forward builds it
        skips = [b0]
        ch_in = b0
        self.down_blocks = nn.ModuleList()
        for lvl, btype in enumerate(cfg.down_block_types):
            ch = cfg.block_out_channels[lvl]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch_in, ch, temb_dim, g))
                attns += level_attns(btype, lvl, ch)
                ch_in = ch
                skips.append(ch)
            sampler = Downsample2D(ch) if lvl < n - 1 else None
            if sampler is not None:
                skips.append(ch)
            self.down_blocks.append(_Block(resnets, attns, sampler))

        ch = cfg.block_out_channels[-1]
        mid_resnets = [ResnetBlock2D(ch, ch, temb_dim, g), ResnetBlock2D(ch, ch, temb_dim, g)]
        mid_attns = [attn(n - 1, ch, depth=cfg.transformer_layers_per_block[-1],
                          cross=cfg.cross_attention_dim is not None)] if cfg.mid_block_attn else None
        self.mid_block = _Block(mid_resnets, mid_attns)

        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(n)):
            ch = cfg.block_out_channels[lvl]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch_in + skips.pop(), ch, temb_dim, g))
                attns += level_attns(cfg.down_block_types[lvl], lvl, ch)
                ch_in = ch
            sampler = Upsample2D(ch) if lvl > 0 else None
            self.up_blocks.append(_Block(resnets, attns, sampler, "upsamplers"))

        self.conv_norm_out = GroupNorm(b0, g, act="silu")
        self.conv_out = nn.Conv2d(b0, cfg.out_channels, 3, padding=1)

    def _block(self, block: nn.Module, *args):
        if self.config.remat and torch.is_grad_enabled():
            return remat_call(block, *args)
        return block(*args)

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        conditioning: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        return_features: bool = False,
        adapter_residuals: Optional[List[torch.Tensor]] = None,
    ):
        """``conditioning["cond"]["crossattn"]``: the text context [B, T, C];
        ``conditioning["cond"]["vector"]`` (SDXL): [B, 2816], added to the
        time embedding through ``add_embedding``; ``["concat"]``: [B, H, W,
        concat_channels]; None without cross-attention. ``adapter_residuals``: [B, h, w, C] for each down
        level, at its resolution and width. Returns fp32 [B, H, W, C], or
        (that, the mid block's output [B, h, w, C] in the compute dtype, the
        JAX layout) with ``return_features`` (any true value: the mid block
        is this module's GAN tap, as the MMDiT's is its post-mid stream)."""
        dtype = self.conv_in.weight.dtype
        cond = (conditioning or {}).get("cond", {})
        context = cond.get("crossattn")
        if context is not None:
            context = context.to(dtype)
        timestep = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        temb = timestep_embedding(timestep, self.config.block_out_channels[0])
        temb = self.time_embedding(temb.to(dtype))
        if hasattr(self, "add_embedding") and cond.get("vector") is not None:
            temb = temb + self.add_embedding(cond["vector"].to(dtype))

        if cond.get("concat") is not None:
            sample = torch.cat([sample, cond["concat"].to(sample.dtype)], dim=-1)
        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for lvl, block in enumerate(self.down_blocks):
            for j, resnet in enumerate(block.resnets):
                h = self._block(resnet, h, temb)
                if block.attentions is not None:
                    h = self._block(block.attentions[j], h, context)
                if j == len(block.resnets) - 1 and adapter_residuals is not None:
                    h = h + adapter_residuals[lvl].permute(0, 3, 1, 2).to(h.dtype)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        h = self._block(self.mid_block.resnets[0], h, temb)
        if self.mid_block.attentions is not None:
            h = self._block(self.mid_block.attentions[0], h, context)
        h = self._block(self.mid_block.resnets[1], h, temb)
        mid_features = h.permute(0, 2, 3, 1)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = self._block(resnet, torch.cat([h, skips.pop()], dim=1), temb)
                if block.attentions is not None:
                    h = self._block(block.attentions[j], h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        out = self.conv_out(self.conv_norm_out(h)).float().permute(0, 2, 3, 1).contiguous()
        return (out, mid_features) if return_features else out
