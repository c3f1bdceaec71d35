"""Pixart-α DiT denoiser (adaLN-single) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/dit.py`` with diffusers
``PixArtTransformer2DModel`` module names (``pos_embed.proj``,
``adaln_single``, ``caption_projection``, ``transformer_blocks.*``,
``scale_shift_table``, ``proj_out``), so that ``utils/hf.py::
import_pixart_dit`` reads a port ``state_dict()``. The one exception is the
JAX package's concat-style multi-vector ``AdaLayerNormSingle``: its
per-chunk embedding MLPs are ``adaln_single.emb.vector_embedders.<i>``; a
stock 1024-MS checkpoint (one ``resolution_embedder`` for height and width,
one ``aspect_ratio_embedder``) goes through ``pixart_state_from_diffusers``,
the surgery of ``import_pixart_dit``.

The public layout is the UNet's: ``forward(sample [B, H, W, C], timestep
[B], conditioning)`` returns fp32 [B, H, W, in_channels] (the predicted
channels cropped back to the input's). The compute dtype is the
parameters'. Conditioning: ``crossattn`` (T5 tokens), ``vector`` ([B, k]
scalars for the extra adaLN embedders) and ``attention_mask`` (the T5
padding mask, an additive bias of the cross-attention, which therefore
takes the plain path, as in JAX). The self-attention (D = 72 at Pixart's
width) goes to the streaming flash kernel, the affine-free LayerNorms to
the LayerNorm kernel. Not ported yet: ``remat``, ``return_features`` and
the ``concat`` conditioning (the family's training).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BaseConfig
from ..ops import layer_norm, modulate
from .layers import Attention, LoraLinear, TimestepEmbedMLP, timestep_embedding


@dataclasses.dataclass
class DiTConfig(BaseConfig):
    in_channels: int = 4
    out_channels: int = 8  # Pixart predicts eps + sigma; cropped to in_channels
    patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    caption_channels: int = 4096  # T5 width
    mlp_ratio: float = 4.0
    # extra embedded scalar conditionings of the concat-style
    # AdaLayerNormSingle (3 for 1024-MS: height, width, aspect ratio); 0: none
    num_vector_embeds: int = 0
    vector_embed_dim: int = 256  # sinusoidal width per extra scalar
    sample_size: int = 64  # base grid of the positional embedding
    # grid divisor of the positional embedding; None → max(sample_size // 64, 1)
    interpolation_scale: Optional[float] = None

    def __post_init__(self):
        super().__post_init__()
        if self.interpolation_scale is None:
            self.interpolation_scale = float(max(self.sample_size // 64, 1))


def pixart_config(**overrides) -> DiTConfig:
    base = dict(hidden_size=1152, depth=28, num_heads=16, caption_channels=4096)
    base.update(overrides)
    return DiTConfig(**base)


def get_2d_sincos_pos_embed(
    dim: int, h: int, w: int, base_size: int = 64, interpolation_scale: float = 1.0
) -> np.ndarray:
    """2D sin-cos positional embedding [h·w, dim] in float64, the diffusers/MAE
    semantics the JAX package keeps: the FIRST half encodes the w (column)
    coordinate, and grid coordinates are divided by ``interpolation_scale``."""
    grid_h = np.arange(h, dtype=np.float64) / (h / base_size) / interpolation_scale
    grid_w = np.arange(w, dtype=np.float64) / (w / base_size) / interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)

    def _1d(pos, d):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([_1d(gw, dim // 2), _1d(gh, dim // 2)], axis=1)


class _AdaEmbeddings(nn.Module):
    """``adaln_single.emb``: the timestep MLP and one MLP per vector chunk."""

    def __init__(self, d: int, n: int, vector_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedMLP(256, d)
        if n:
            self.vector_embedders = nn.ModuleList([TimestepEmbedMLP(vector_dim, d // n) for _ in range(n)])


class AdaLayerNormSingle(nn.Module):
    """Shared timestep (+ extra scalar conditionings) → (6·d modulation,
    embedded t), the JAX package's concat-style variant: the vector
    conditioning splits into ``num_vector_embeds`` chunks, each through its
    own width-d/n MLP, concatenated to width d and added to the timestep
    embedding. ``vector`` is [B, n] raw scalars (embedded here) or
    [B, n·vector_embed_dim] pre-embedded."""

    def __init__(self, d: int, num_vector_embeds: int = 0, vector_embed_dim: int = 256):
        super().__init__()
        if num_vector_embeds and d % num_vector_embeds:
            raise ValueError(f"hidden_size {d} not divisible by num_vector_embeds {num_vector_embeds}")
        self.n, self.vector_embed_dim = num_vector_embeds, vector_embed_dim
        self.emb = _AdaEmbeddings(d, num_vector_embeds, vector_embed_dim)
        self.linear = nn.Linear(d, 6 * d)

    def forward(self, timestep: torch.Tensor, vector: Optional[torch.Tensor] = None):
        dtype = self.linear.weight.dtype
        emb = self.emb.timestep_embedder(timestep_embedding(timestep, 256).to(dtype))
        if self.n and vector is not None:
            if vector.shape[-1] == self.n:  # raw scalars → sinusoidal per column
                chunks = [timestep_embedding(vector[:, i], self.vector_embed_dim) for i in range(self.n)]
            else:  # pre-embedded [B, n·in_dim]
                chunks = vector.chunk(self.n, dim=-1)
            emb = emb + torch.cat([mlp(c.to(dtype)) for mlp, c in zip(self.emb.vector_embedders, chunks)], dim=-1)
        return self.linear(F.silu(emb)), emb


class _GeluProj(nn.Module):
    """diffusers ``GELU(approximate="tanh")``: a projection, then tanh-gelu."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = LoraLinear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class _FeedForward(nn.Module):
    """d → tanh-gelu(inner) → d (diffusers ``ff.net``; JAX ``ff_in``/``ff_out``)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(dim, inner), nn.Identity(), LoraLinear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class PixartBlock(nn.Module):
    """adaLN-single DiT block: modulated self-attention, raw cross-attention,
    modulated feed-forward."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.scale_shift_table = nn.Parameter(torch.randn(6, d) / math.sqrt(d))
        self.attn1 = Attention(d, num_heads, qkv_bias=True)
        self.attn2 = Attention(d, num_heads, qkv_bias=True)
        self.ff = _FeedForward(d, int(d * mlp_ratio))

    def forward(self, x, mod6, context=None, context_bias=None):
        d = x.shape[-1]
        m = self.scale_shift_table[None] + mod6.reshape(-1, 6, d)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = m.unbind(1)
        x = x + gate_msa[:, None] * self.attn1(modulate(layer_norm(x, eps=1e-6), shift_msa, scale_msa))
        if context is not None:
            x = x + self.attn2(x, context=context, bias=context_bias)
        h = self.ff(modulate(layer_norm(x, eps=1e-6), shift_mlp, scale_mlp))
        return x + gate_mlp[:, None] * h


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, d: int, p: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, d, p, stride=p)


class _CaptionProjection(nn.Module):
    def __init__(self, in_dim: int, d: int):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(in_dim, d), nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class DiT(nn.Module):
    """Pixart-α transformer denoiser."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        self.config = cfg = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.pos_embed = _PatchEmbed(cfg.in_channels, d, p)
        self.adaln_single = AdaLayerNormSingle(d, cfg.num_vector_embeds, cfg.vector_embed_dim)
        self.caption_projection = _CaptionProjection(cfg.caption_channels, d)
        self.transformer_blocks = nn.ModuleList(
            [PixartBlock(d, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth)])
        self.scale_shift_table = nn.Parameter(torch.randn(2, d) / math.sqrt(d))
        self.proj_out = nn.Linear(d, p * p * cfg.out_channels)
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    def _pos(self, gh: int, gw: int, like: torch.Tensor) -> torch.Tensor:
        key = (gh, gw, like.device, like.dtype)
        if key not in self._pos_cache:
            cfg = self.config
            pos = get_2d_sincos_pos_embed(cfg.hidden_size, gh, gw, base_size=cfg.sample_size // cfg.patch_size,
                                          interpolation_scale=cfg.interpolation_scale)
            self._pos_cache[key] = torch.from_numpy(pos).to(like.device, like.dtype)
        return self._pos_cache[key]

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        conditioning: Dict[str, Dict[str, torch.Tensor]],
    ) -> torch.Tensor:
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        cond = (conditioning or {}).get("cond", {})
        context, vector, mask = cond.get("crossattn"), cond.get("vector"), cond.get("attention_mask")
        b, hh, ww, _ = sample.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        x = self.pos_embed.proj(sample.to(dtype).permute(0, 3, 1, 2))  # [B, d, gh, gw]
        x = x.flatten(2).transpose(1, 2) + self._pos(gh, gw, x)[None]  # h-major tokens
        timestep = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        mod6, emb_t = self.adaln_single(timestep, vector)

        context_bias = None
        if context is not None:
            context = self.caption_projection(context.to(dtype))
            if mask is not None:  # [B, S_kv] → additive bias [B, 1, 1, S_kv]
                context_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        for block in self.transformer_blocks:
            x = block(x, mod6, context, context_bias)

        shift, scale = (self.scale_shift_table[None] + emb_t[:, None, :]).unbind(1)
        x = self.proj_out(modulate(layer_norm(x, eps=1e-6), shift, scale))
        x = x.reshape(b, gh, gw, p, p, cfg.out_channels)
        x = torch.einsum("bhwpqc->bhpwqc", x).reshape(b, hh, ww, cfg.out_channels)
        return x[..., : cfg.in_channels].float()


# diffusers 1024-MS micro-conditioning embedders → the port's vector chunks
# (height, width, aspect ratio), as ``utils/hf.py::import_pixart_dit`` maps them
_MS_EMBEDDERS = {
    "adaln_single.emb.resolution_embedder.": ("adaln_single.emb.vector_embedders.0.",
                                              "adaln_single.emb.vector_embedders.1."),
    "adaln_single.emb.aspect_ratio_embedder.": ("adaln_single.emb.vector_embedders.2.",),
}


def pixart_state_from_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers Pixart transformer state dict → the port's keys: the
    resolution embedder goes into vector chunks 0 and 1, the aspect-ratio
    embedder into chunk 2; every other key stays."""
    out = {}
    for key, t in sd.items():
        prefix = next((p for p in _MS_EMBEDDERS if key.startswith(p)), None)
        if prefix is None:
            out[key] = t
            continue
        for new in _MS_EMBEDDERS[prefix]:
            out[new + key[len(prefix):]] = t
    return out
