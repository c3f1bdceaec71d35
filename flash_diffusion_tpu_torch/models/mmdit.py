"""SD3 MMDiT denoiser (joint dual-stream transformer) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/mmdit.py`` with diffusers
``SD3Transformer2DModel`` module names (``pos_embed.proj``,
``time_text_embed.{timestep,text}_embedder``, ``context_embedder``,
``transformer_blocks.<i>.{norm1,norm1_context}.linear``, ``….attn.{to_q,
to_k, to_v, to_out.0, add_q_proj, add_k_proj, add_v_proj, to_add_out,
norm_q, norm_k}``, ``….ff.net``, ``….ff_context.net``, ``norm_out.linear``,
``proj_out``), so that ``utils/hf.py::import_sd3_mmdit`` reads a port
``state_dict()``.

``forward(sample [B, H, W, C], timestep [B], conditioning)`` returns the
fp32 velocity [B, H, W, C] (the predicted channels cropped to the input's,
as the reference wrapper's ``.sample[:, :sample_channels]``). The compute
dtype is the parameters'. Conditioning: ``crossattn`` (the context token
stream, ``joint_attention_dim`` wide), ``vector`` (the pooled projections,
summed into the timestep embedding) and ``concat`` (channel-concatenated to
the latents before the patchify; the patch convolution needs its width up
front: ``config.concat_channels``).

As in JAX:

- the sin-cos table is built once over ``pos_embed_max_size`` with
  ``base_size = sample_size // patch_size`` and centre-cropped to the grid;
- ``norm1`` chunks its modulation as (shift, scale, gate) for the attention
  and the feed-forward; the final block's ``norm1_context`` and
  ``norm_out`` take (scale, shift);
- the two streams are concatenated on [B, S, C] before the heads reshape;
- the joint sequence is 128-aligned once, by zero rows appended to the
  context stream, which attention masks with ``kv_valid`` (the flash
  kernels' key mask); the output head reads only the image rows;
- the final block (``context_pre_only``) updates no context and has no
  ``to_add_out`` or ``ff_context``;
- the feed-forwards use tanh-gelu; ``qk_norm`` is SD3.5's per-head RMSNorm
  of q and k.

The attention goes to ``ops.dot_product_attention`` (the streaming flash
kernel at 1024², 4250 of 4352 keys valid; the one-shot kernel at small
sizes), the affine-free LayerNorms to the LayerNorm kernel. For training
(the next slice): ``config.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant) whenever autograd records;
``return_features`` (True, or JAX's ``"post_mid"``) also returns the
latent stream after the middle block through the shared output head (the
discriminator's tap: a distillation step asks any denoiser for its own
tap with ``return_features=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import BaseConfig
from ..ops import dot_product_attention, layer_norm, modulate
from .dit import _FeedForward, get_2d_sincos_pos_embed
from .layers import LoraLinear, TimestepEmbedMLP, timestep_embedding


@dataclasses.dataclass
class MMDiTConfig(BaseConfig):
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 1536
    depth: int = 24
    num_heads: int = 24
    joint_attention_dim: int = 4096  # context token width (CLIP padded, T5)
    pooled_projection_dim: int = 2048  # CLIP-L + CLIP-G pooled
    mlp_ratio: float = 4.0
    qk_norm: bool = False
    pos_embed_max_size: int = 192
    remat: bool = False  # recompute each block in the backward (training)
    sample_size: int = 128
    concat_channels: int = 0  # channels of a ``concat`` conditioning


def sd3_medium_config(**overrides) -> MMDiTConfig:
    return MMDiTConfig(**overrides)


class _AdaLinear(nn.Module):
    """diffusers ``AdaLayerNormZero``/``AdaLayerNormContinuous``: the
    modulation ``linear`` of SiLU(temb); the norms themselves are affine-free."""

    def __init__(self, d: int, out: int):
        super().__init__()
        self.linear = nn.Linear(d, out)

    def forward(self, temb_act: torch.Tensor, chunks: int):
        return self.linear(temb_act).reshape(temb_act.shape[0], chunks, -1).unbind(1)


class _HeadRMSNorm(nn.Module):
    """Per-head RMSNorm of q or k over the head dim (eps 1e-6), in fp32."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(head_dim))

    def forward(self, t):
        tf = t.float()
        var = tf.pow(2).mean(dim=-1, keepdim=True)
        return (tf * torch.rsqrt(var + 1e-6) * self.weight.float()).to(t.dtype)


class JointAttention(nn.Module):
    """The joint attention's projections: the image stream's ``to_q``…
    ``to_out.0``, the context stream's ``add_*_proj`` and ``to_add_out``."""

    def __init__(self, d: int, context_pre_only: bool, qk_norm: bool, head_dim: int):
        super().__init__()
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, LoraLinear(d, d))
        self.to_out = nn.ModuleList([LoraLinear(d, d)])
        if not context_pre_only:
            self.to_add_out = LoraLinear(d, d)
        if qk_norm:
            self.norm_q, self.norm_k = _HeadRMSNorm(head_dim), _HeadRMSNorm(head_dim)


class JointBlock(nn.Module):
    """Dual-stream block with joint attention (AdaLayerNormZero on both
    streams; the final block's context stream is only read)."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: float = 4.0, context_pre_only: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        self.num_heads, self.context_pre_only, self.qk_norm = num_heads, context_pre_only, qk_norm
        inner = int(d * mlp_ratio)
        self.norm1 = _AdaLinear(d, 6 * d)
        self.norm1_context = _AdaLinear(d, (2 if context_pre_only else 6) * d)
        self.attn = JointAttention(d, context_pre_only, qk_norm, d // num_heads)
        self.ff = _FeedForward(d, inner)
        if not context_pre_only:
            self.ff_context = _FeedForward(d, inner)

    def forward(self, x, c, temb, kv_valid: Optional[int] = None):
        b, sx, d = x.shape
        s = sx + c.shape[1]
        h = self.num_heads
        act = F.silu(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = self.norm1(act, 6)
        if self.context_pre_only:  # AdaLayerNormContinuous: (scale, shift)
            csc_msa, csh_msa = self.norm1_context(act, 2)
        else:
            csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = self.norm1_context(act, 6)
        xn = modulate(layer_norm(x, eps=1e-6), sh_msa, sc_msa)
        cn = modulate(layer_norm(c, eps=1e-6), csh_msa, csc_msa)

        a = self.attn
        # the streams joined on [B, S, C], then the heads reshape
        joint = lambda px, pc: torch.cat([px(xn), pc(cn)], dim=1).reshape(b, s, h, d // h)
        q, k, v = joint(a.to_q, a.add_q_proj), joint(a.to_k, a.add_k_proj), joint(a.to_v, a.add_v_proj)
        if self.qk_norm:
            q, k = a.norm_q(q), a.norm_k(k)
        attn = dot_product_attention(q, k, v, kv_valid=kv_valid).reshape(b, s, d)
        ax, ac = attn[:, :sx], attn[:, sx:]

        x = x + g_msa[:, None] * a.to_out[0](ax)
        x = x + g_mlp[:, None] * self.ff(modulate(layer_norm(x, eps=1e-6), sh_mlp, sc_mlp))
        if self.context_pre_only:
            return x, None
        c = c + cg_msa[:, None] * a.to_add_out(ac)
        c = c + cg_mlp[:, None] * self.ff_context(modulate(layer_norm(c, eps=1e-6), csh_mlp, csc_mlp))
        return x, c


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, d: int, p: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, d, p, stride=p)


class _TimeTextEmbed(nn.Module):
    """diffusers ``CombinedTimestepTextProjEmbeddings``: the timestep MLP
    over 256 sinusoidal channels and the pooled-text MLP, summed."""

    def __init__(self, d: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedMLP(256, d)
        self.text_embedder = TimestepEmbedMLP(pooled_dim, d)


class MMDiT(nn.Module):
    """SD3 denoiser: ``forward(sample, timestep, conditioning)`` → v-prediction."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = cfg = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.pos_embed = _PatchEmbed(cfg.in_channels + cfg.concat_channels, d, p)
        self.time_text_embed = _TimeTextEmbed(d, cfg.pooled_projection_dim)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList([
            JointBlock(d, cfg.num_heads, cfg.mlp_ratio, context_pre_only=(i == cfg.depth - 1), qk_norm=cfg.qk_norm)
            for i in range(cfg.depth)])
        self.norm_out = _AdaLinear(d, 2 * d)
        self.proj_out = nn.Linear(d, p * p * cfg.out_channels)
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    def _pos(self, gh: int, gw: int, like: torch.Tensor) -> torch.Tensor:
        """The sin-cos table over the max grid, centre-cropped to gh × gw."""
        key = (gh, gw, like.device, like.dtype)
        if key not in self._pos_cache:
            cfg = self.config
            m, d = cfg.pos_embed_max_size, cfg.hidden_size
            pos = get_2d_sincos_pos_embed(d, m, m, base_size=cfg.sample_size // cfg.patch_size)
            top, left = (m - gh) // 2, (m - gw) // 2
            pos = pos.reshape(m, m, d)[top: top + gh, left: left + gw].reshape(gh * gw, d)
            self._pos_cache[key] = torch.from_numpy(pos).to(like.device, like.dtype)
        return self._pos_cache[key]

    def forward(
        self,
        sample: torch.Tensor,
        timestep: torch.Tensor,
        conditioning: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        return_features=False,
    ):
        """fp32 [B, H, W, out]; with ``return_features`` (True or
        ``"post_mid"``) also the latent stream after block depth // 2 − 1
        through the output head."""
        cfg = self.config
        dtype = self.proj_out.weight.dtype
        cond = (conditioning or {}).get("cond", {})
        context, pooled, concat = cond.get("crossattn"), cond.get("vector"), cond.get("concat")
        if concat is not None:
            sample = torch.cat([sample, concat.to(sample.dtype)], dim=-1)
        b, hh, ww, in_ch = sample.shape
        p, d = cfg.patch_size, cfg.hidden_size
        gh, gw = hh // p, ww // p
        x = self.pos_embed.proj(sample.to(dtype).permute(0, 3, 1, 2))  # [B, d, gh, gw]
        x = x.flatten(2).transpose(1, 2) + self._pos(gh, gw, x)[None]  # h-major tokens

        timestep = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        emb = self.time_text_embed
        temb = emb.timestep_embedder(timestep_embedding(timestep, 256).to(dtype))
        if pooled is not None:
            temb = temb + emb.text_embedder(pooled.to(dtype))
        if context is None:
            context = torch.zeros(b, 1, cfg.joint_attention_dim, device=sample.device, dtype=dtype)
        c = self.context_embedder(context.to(dtype))

        # the joint sequence 128-aligned once: zero context rows, masked by kv_valid
        joint = gh * gw + c.shape[1]
        align_pad = (-joint) % 128
        kv_valid = joint if align_pad else None
        if align_pad:
            c = F.pad(c, (0, 0, 0, align_pad))

        def head(tokens):
            scale, shift = self.norm_out(F.silu(temb), 2)
            t = self.proj_out(modulate(layer_norm(tokens, eps=1e-6), shift, scale))
            t = t.reshape(b, gh, gw, p, p, cfg.out_channels)
            return torch.einsum("bhwpqc->bhpwqc", t).reshape(b, hh, ww, cfg.out_channels).float()

        features = None
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.transformer_blocks):
            if remat:
                x, c = checkpoint(block, x, c, temb, kv_valid, use_reentrant=False)
            else:
                x, c = block(x, c, temb, kv_valid)
            if return_features and i == cfg.depth // 2 - 1:
                features = head(x)[..., : cfg.in_channels]
        out = head(x)[..., : min(in_ch, cfg.out_channels)]
        return (out, features) if return_features else out
