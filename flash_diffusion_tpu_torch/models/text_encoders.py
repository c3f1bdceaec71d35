"""CLIP text encoder of the PyTorch port.

Port of ``flash_diffusion_tpu/models/text_encoders.py::CLIPTextModel`` with
transformers ``CLIPTextModel`` module names (``text_model.*``), so the keys
match the published checkpoints and ``utils/hf.py::import_clip_text``. The
causal mask is an additive bias, so attention takes the plain path, as in
JAX; the LayerNorms take the LayerNorm kernel on the card. CLIP-L only
(quick-gelu, no text projection): OpenCLIP-G and the T5 encoder are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

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
    eos_token_id: int = 49407


def clip_l_config(**overrides) -> CLIPTextConfig:
    """SD1.5/SDXL text_encoder (CLIP ViT-L/14)."""
    return CLIPTextConfig(**overrides)


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
    """fc1 → quick-gelu (x·σ(1.702x), OpenAI CLIP) → fc2."""

    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = _SelfAttention(d, cfg.num_heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = _MLP(d, cfg.intermediate_size)

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
    pooled_output}, as the JAX module does (which adds ``text_embeds`` for
    the projected variants)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

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
        # pooled: the hidden state at the first EOS token
        eos_pos = torch.argmax((input_ids == self.config.eos_token_id).int(), dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos_pos]
        return {
            "hidden_states": tuple(hidden_states),
            "last_hidden_state": last,
            "pooled_output": pooled,
        }
