"""CLIP vision tower (ViT) of the PyTorch port, for CLIP-FID and CLIPScore.

Port of ``flash_diffusion_tpu/models/vision.py``: the patch convolution
(no bias, VALID) → [CLS] + patches plus the position embedding →
``pre_layrnorm`` → pre-LN transformer layers (quick-gelu MLP in OpenAI's
CLIP) → the post-LN of the CLS token → ``visual_projection``. The module
names are transformers' ``CLIPVisionModelWithProjection``
(``vision_model.embeddings.*``, the misspelled ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.*``, ``vision_model.post_layernorm``, a
top-level ``visual_projection``), so ``import_clip_vision`` of a published
file is a key filter. Attention goes through ``ops.dot_product_attention``
(K1 over 257 keys at 224² and patch 14: padded to 384 they are past the
packed kernel's 256), every LayerNorm through ``ops.layer_norm`` (K3). The
layout at the boundary is JAX's: ``forward(images [B, H, W, 3])``,
normalized (``eval.clip_preprocess``); the compute dtype is the
parameters' (bf16 on the card: the attention kernels take bf16).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import BaseConfig
from ..ops import dot_product_attention
from .layers import LayerNorm
from .text_encoders import _MLP

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CLIPVisionConfig(BaseConfig):
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    projection_dim: Optional[int] = 512
    hidden_act: str = "quick_gelu"


def clip_vit_l14_config(**overrides) -> CLIPVisionConfig:
    """OpenAI CLIP ViT-L/14 at 224² (openai/clip-vit-large-patch14)."""
    base = dict(hidden_size=1024, intermediate_size=4096, num_layers=24, num_heads=16, projection_dim=768)
    base.update(overrides)
    return CLIPVisionConfig(**base)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads)
        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)))
        return self.out_proj(out.reshape(b, s, d))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = _SelfAttention(d, cfg.num_heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = _MLP(d, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.randn(d) * 0.02)
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, d)
        nn.init.normal_(self.position_embedding.weight, std=0.02)  # the JAX initializer


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size)  # transformers' spelling
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size)


class CLIPVisionModel(nn.Module):
    """``forward(images [B, H, W, 3] normalized)`` → {pooled_output,
    image_embeds}, as the JAX module; ``image_embeds`` is None without
    ``projection_dim``."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        if config.projection_dim is not None:
            self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, images: torch.Tensor):
        vm = self.vision_model
        emb = vm.embeddings
        dtype = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(images.to(dtype).permute(0, 3, 1, 2))  # [B, d, h, w]
        b, d = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # h-major patches, JAX's reshape of NHWC
        x = torch.cat([emb.class_embedding.to(dtype).expand(b, 1, d), x], dim=1)
        x = x + emb.position_embedding.weight[: x.shape[1]][None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0].contiguous())
        embeds = self.visual_projection(pooled) if hasattr(self, "visual_projection") else None
        return {"pooled_output": pooled, "image_embeds": embeds}


def import_clip_vision(sd: StateDict) -> StateDict:
    """A transformers ``CLIPVisionModel(WithProjection)`` or full ``CLIPModel``
    state dict → the port's ``CLIPVisionModel`` one (JAX
    ``utils/hf.py:431-459``): the vision tower's keys, with the
    ``vision_model.`` prefix added where the file has none, and
    ``visual_projection``; the ``position_ids`` buffer left out."""
    prefixed = any(k.startswith("vision_model.") for k in sd)
    out = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        if k.startswith("visual_projection."):
            out[k] = v
        elif prefixed and k.startswith("vision_model."):
            out[k] = v
        elif not prefixed and k.split(".")[0] in ("embeddings", "pre_layrnorm", "encoder", "post_layernorm"):
            out["vision_model." + k] = v
    return out


def import_clip_text(sd: StateDict) -> StateDict:
    """The text tower of a full CLIP state dict (``text_model.*`` and
    ``text_projection``) for the port's ``CLIPTextModel``."""
    return {k: v for k, v in sd.items()
            if (k.startswith("text_model.") or k.startswith("text_projection.")) and not k.endswith("position_ids")}
