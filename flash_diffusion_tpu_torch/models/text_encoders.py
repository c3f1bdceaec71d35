"""Text encoders of the PyTorch port: CLIP and the T5 encoder.

Port of ``flash_diffusion_tpu/models/text_encoders.py``: ``CLIPTextModel``
with transformers ``CLIPTextModel(WithProjection)`` module names
(``text_model.*``, top-level ``text_projection``), and ``T5Encoder`` with
transformers ``T5EncoderModel`` names (``shared``, ``encoder.block.*``,
``encoder.final_layer_norm``), so the keys match the published checkpoints
and ``utils/hf.py::import_clip_text``/``import_t5_encoder``. CLIP's causal
mask and T5's relative-position bias (plus its padding mask) are additive
biases, so their attention takes the plain path, as in JAX; CLIP's
LayerNorms take the LayerNorm kernel on the card, T5's RMS norms are plain.
CLIP-L (quick-gelu) and OpenCLIP-bigG (exact gelu, text projection) for
SD1.5 and SDXL; T5-v1.1-XXL (unscaled attention, gated tanh-gelu MLP) for
Pixart-α.
"""

from __future__ import annotations

import dataclasses
import math
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


# --------------------------------------------------------------------------
# T5 encoder
# --------------------------------------------------------------------------
@dataclasses.dataclass
class T5Config(BaseConfig):
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    d_kv: int = 64
    num_layers: int = 24
    num_heads: int = 64
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6


def t5_xxl_config(**overrides) -> T5Config:
    """T5-v1.1-XXL encoder (Pixart / SD3 text encoder 3)."""
    return T5Config(**overrides)


def _t5_rel_bucket(rel_pos: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing, in the JAX package's
    fp32 arithmetic (``text_encoders.py::_t5_rel_bucket``)."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).long()
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5's RMS norm: fp32 statistics and scale, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


class _T5Norm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        return _rms(x, self.weight, self.eps)


class _T5Attention(nn.Module):
    """Unscaled multi-head self-attention (the scale is folded into T5's
    initialization); block 0 also holds the shared relative-position bias."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q, self.k = nn.Linear(cfg.d_model, inner, bias=False), nn.Linear(cfg.d_model, inner, bias=False)
        self.v, self.o = nn.Linear(cfg.d_model, inner, bias=False), nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_buckets, cfg.num_heads)

    def forward(self, x, bias):
        b, s, _ = x.shape
        split = lambda t: t.reshape(b, s, self.heads, self.d_kv)
        out = dot_product_attention(split(self.q(x)), split(self.k(x)), split(self.v(x)), bias=bias, scale=1.0)
        return self.o(out.reshape(b, s, self.heads * self.d_kv))


class _T5SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, has_bias)
        self.layer_norm = _T5Norm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class _T5GatedGelu(nn.Module):
    """T5 v1.1 feed-forward: tanh-gelu(wi_0·x) ∘ (wi_1·x), then wo."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _T5FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5GatedGelu(cfg)
        self.layer_norm = _T5Norm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5SelfAttentionLayer(cfg, has_bias), _T5FFLayer(cfg)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = _T5Norm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """T5 encoder: token ids [B, S] (and the padding mask [B, S], > 0 where
    valid) → the final RMS-normed hidden states [B, S, d_model]. The
    relative-position buckets are computed on the CPU (one [S, S] table), so
    they do not depend on the device's log."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)  # N(0, 1), the JAX initializer
        self.encoder = _T5Stack(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        cfg = self.config
        s = input_ids.shape[1]
        x = self.shared(input_ids)
        pos = torch.arange(s)
        buckets = _t5_rel_bucket(pos[None, :] - pos[:, None], cfg.relative_buckets, cfg.relative_max_distance)
        rel_emb = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = rel_emb[buckets.to(rel_emb.device)].permute(2, 0, 1)[None].float()  # [1, H, S, S]
        if attention_mask is not None:
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
