"""CLIP text encoders of the PyTorch port.

Port of ``flash_diffusion_tpu/models/text_encoders.py::CLIPTextModel`` with
transformers ``CLIPTextModel(WithProjection)`` module names
(``text_model.*``, top-level ``text_projection``), so the keys match the
published checkpoints and ``utils/hf.py::import_clip_text``. The causal
mask is an additive bias, so attention takes the plain path, as in JAX; the
LayerNorms take the LayerNorm kernel on the card. CLIP-L (quick-gelu) and
OpenCLIP-bigG (exact gelu, text projection) for SD1.5 and SDXL; the T5
encoder is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BaseConfig
from ..ops import dot_product_attention
from .layers import LayerNorm


@dataclasses.dataclass
class CLIPTextConfig(BaseConfig):
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    hidden_act: str = "quick_gelu"  # OpenAI CLIP-L; OpenCLIP-G uses "gelu"
    projection_dim: Optional[int] = None  # set for WithProjection variants
    eos_token_id: int = 49407

    def __post_init__(self):
        super().__post_init__()
        if self.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"hidden_act {self.hidden_act!r}")


def clip_l_config(**overrides) -> CLIPTextConfig:
    """SD1.5/SDXL text_encoder (CLIP ViT-L/14)."""
    return CLIPTextConfig(**overrides)


def clip_g_config(**overrides) -> CLIPTextConfig:
    """SDXL text_encoder_2 (OpenCLIP bigG), with projection."""
    base = dict(hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20,
                hidden_act="gelu", projection_dim=1280)
    base.update(overrides)
    return CLIPTextConfig(**base)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, bias):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads)
        out = dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), bias=bias
        )
        return self.out_proj(out.reshape(b, s, d))


class _MLP(nn.Module):
    """fc1 → quick-gelu (x·σ(1.702x), OpenAI CLIP) or exact (erf) gelu
    (OpenCLIP), in every dtype, as JAX ``_act`` → fc2."""

    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = _SelfAttention(d, cfg.num_heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = _MLP(d, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        # the JAX initializer: normal(0.02)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.position_embedding.weight, std=0.02)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size)


class CLIPTextModel(nn.Module):
    """Returns {hidden_states (incl. embeddings), last_hidden_state,
    pooled_output, text_embeds}, as the JAX module does. ``text_embeds`` is
    ``text_projection(pooled_output)`` where ``projection_dim`` is set, else
    None."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=input_ids.device))
        bias = torch.where(causal, 0.0, -1e9)[None, None]

        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, bias)
            hidden_states.append(x)
        last = tm.final_layer_norm(x)
        # pooled: the final-LN'd state at the first EOS token
        eos_pos = torch.argmax((input_ids == self.config.eos_token_id).int(), dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos_pos]
        return {
            "hidden_states": tuple(hidden_states),
            "last_hidden_state": last,
            "pooled_output": pooled,
            "text_embeds": self.text_projection(pooled) if hasattr(self, "text_projection") else None,
        }
