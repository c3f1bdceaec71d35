"""JAX parameter trees → port state dicts.

Each converter takes the JAX package's param tree (nested dicts of numpy
arrays, with or without the outer ``{"params": ...}``) and returns a port
``state_dict`` of torch tensors. Each is the exact inverse of the JAX
package's importer from diffusers/transformers names
(``flash_diffusion_tpu/utils/hf.py``: ``import_unet``, ``import_vae``,
``import_clip_text``, ``import_t5_encoder``, ``import_pixart_dit``), whose
layout rules it undoes:

- flax Dense kernel [in, out] → torch Linear weight [out, in];
- flax Conv kernel [kh, kw, I, O] → torch Conv2d weight [O, I, kh, kw];
- norm ``scale`` → ``weight``;
- ``proj_in``/``proj_out`` Dense [C, C] → 1×1 conv [C, C, 1, 1] (SD1.5) or
  Linear [C, C] (SDXL, ``use_linear_projection``);
- the UNet's ``class_embedding`` → ``add_embedding`` (SDXL's diffusers name).

They cover the SD1.5 and SDXL UNets, the Pixart DiT (its per-chunk vector
MLPs as ``adaln_single.emb.vector_embedders.<i>``), the SD VAE, the CLIP-L,
OpenCLIP-bigG and T5 text towers, and for training the LoRA tree, the conv
discriminator and LPIPS (whose JAX param names are the port's).

Imports no JAX: the tree arrives as numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(sd: StateDict, key: str, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, key: str, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, key: str, p) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _proj_in_out(sd: StateDict, key: str, p, linear: bool) -> None:
    """``proj_in``/``proj_out`` from a JAX Dense: a Linear, or SD1.5's 1×1 conv."""
    _lin(sd, key, p)
    if not linear:
        sd[f"{key}.weight"] = sd[f"{key}.weight"][:, :, None, None]


def _resnet(sd: StateDict, key: str, p) -> None:
    _norm(sd, f"{key}.norm1", p["norm1"])
    _conv(sd, f"{key}.conv1", p["conv1"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _conv(sd, f"{key}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _lin(sd, f"{key}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(sd, f"{key}.conv_shortcut", p["conv_shortcut"])


def _attention(sd: StateDict, key: str, p) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{key}.{name}", p[name])
    _lin(sd, f"{key}.to_out.0", p["to_out"])


def _spatial_transformer(sd: StateDict, key: str, p, linear: bool) -> None:
    _norm(sd, f"{key}.norm", p["norm"])
    _proj_in_out(sd, f"{key}.proj_in", p["proj_in"], linear)
    _proj_in_out(sd, f"{key}.proj_out", p["proj_out"], linear)
    depth = sum(1 for name in p if name.startswith("blocks_"))
    for k in range(depth):
        blk, tkey = p[f"blocks_{k}"], f"{key}.transformer_blocks.{k}"
        for i in ("1", "2"):
            _norm(sd, f"{tkey}.norm{i}", blk[f"norm{i}"])
            _attention(sd, f"{tkey}.attn{i}", blk[f"attn{i}"])
        _norm(sd, f"{tkey}.norm3", blk["norm3"])
        _lin(sd, f"{tkey}.ff.net.0.proj", blk["ff"]["proj_in"])
        _lin(sd, f"{tkey}.ff.net.2", blk["ff"]["proj_out"])


def unet_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``UNet2DCondition`` params → port ``UNet2DCondition`` state dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    _lin(sd, "time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _lin(sd, "time_embedding.linear_2", p["time_embedding"]["linear_2"])
    if "class_embedding" in p:
        _lin(sd, "add_embedding.linear_1", p["class_embedding"]["linear_1"])
        _lin(sd, "add_embedding.linear_2", p["class_embedding"]["linear_2"])
    linear = config.use_linear_projection
    n = len(config.block_out_channels)
    for lvl in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f"down_blocks.{lvl}.resnets.{j}", p[f"down_{lvl}_resnet_{j}"])
            if f"down_{lvl}_attn_{j}" in p:
                _spatial_transformer(
                    sd, f"down_blocks.{lvl}.attentions.{j}", p[f"down_{lvl}_attn_{j}"], linear
                )
        if lvl < n - 1:
            _conv(sd, f"down_blocks.{lvl}.downsamplers.0.conv", p[f"down_{lvl}_downsample"]["conv"])
    _resnet(sd, "mid_block.resnets.0", p["mid_resnet_0"])
    _resnet(sd, "mid_block.resnets.1", p["mid_resnet_1"])
    _spatial_transformer(sd, "mid_block.attentions.0", p["mid_attn"], linear)
    for ui, lvl in enumerate(reversed(range(n))):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{ui}.resnets.{j}", p[f"up_{lvl}_resnet_{j}"])
            if f"up_{lvl}_attn_{j}" in p:
                _spatial_transformer(
                    sd, f"up_blocks.{ui}.attentions.{j}", p[f"up_{lvl}_attn_{j}"], linear
                )
        if lvl > 0:
            _conv(sd, f"up_blocks.{ui}.upsamplers.0.conv", p[f"up_{lvl}_upsample"]["conv"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def _vae_mid(sd: StateDict, key: str, p) -> None:
    _resnet(sd, f"{key}.mid_block.resnets.0", p["mid_resnet_0"])
    _resnet(sd, f"{key}.mid_block.resnets.1", p["mid_resnet_1"])
    _norm(sd, f"{key}.mid_block.attentions.0.group_norm", p["mid_attn"]["group_norm"])
    _attention(sd, f"{key}.mid_block.attentions.0", p["mid_attn"]["attention"])


def vae_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``AutoencoderKL`` params → port ``AutoencoderKL`` state dict."""
    p = _unwrap(params)
    enc, dec = p["encoder"], p["decoder"]
    sd: StateDict = {}
    n = len(config.block_out_channels)
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for lvl in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{lvl}.resnets.{j}", enc[f"down_{lvl}_resnet_{j}"])
        if lvl < n - 1:
            _conv(sd, f"encoder.down_blocks.{lvl}.downsamplers.0.conv", enc[f"down_{lvl}_downsample"])
    _vae_mid(sd, "encoder", enc)
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder", dec)
    for ui, lvl in enumerate(reversed(range(n))):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{ui}.resnets.{j}", dec[f"up_{lvl}_resnet_{j}"])
        if ui < n - 1:
            _conv(sd, f"decoder.up_blocks.{ui}.upsamplers.0.conv", dec[f"up_{lvl}_upsample"])
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def clip_text_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``CLIPTextModel`` params → port ``CLIPTextModel`` state dict."""
    p = _unwrap(params)
    sd: StateDict = {
        "text_model.embeddings.token_embedding.weight": _t(p["token_embedding"]),
        "text_model.embeddings.position_embedding.weight": _t(p["position_embedding"]),
        "text_model.final_layer_norm.weight": _t(p["final_ln_scale"]),
        "text_model.final_layer_norm.bias": _t(p["final_ln_bias"]),
    }
    for i in range(config.num_layers):
        lp, k = p[f"layer_{i}"], f"text_model.encoder.layers.{i}"
        for ln in ("1", "2"):
            sd[f"{k}.layer_norm{ln}.weight"] = _t(lp[f"ln{ln}_scale"])
            sd[f"{k}.layer_norm{ln}.bias"] = _t(lp[f"ln{ln}_bias"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{k}.self_attn.{name}", lp[name])
        _lin(sd, f"{k}.mlp.fc1", lp["fc1"])
        _lin(sd, f"{k}.mlp.fc2", lp["fc2"])
    if "text_projection" in p:
        _lin(sd, "text_projection", p["text_projection"])
    return sd


def t5_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``T5Encoder`` params → port ``T5Encoder`` state dict."""
    p = _unwrap(params)
    sd: StateDict = {
        "shared.weight": _t(p["token_embedding"]),
        "encoder.final_layer_norm.weight": _t(p["final_ln_scale"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": _t(p["relative_attention_bias"]),
    }
    for i in range(config.num_layers):
        lp, k = p[f"layer_{i}"], f"encoder.block.{i}.layer"
        sd[f"{k}.0.layer_norm.weight"] = _t(lp["ln1_scale"])
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{k}.0.SelfAttention.{name}", lp[name])
        sd[f"{k}.1.layer_norm.weight"] = _t(lp["ln2_scale"])
        for name in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{k}.1.DenseReluDense.{name}", lp[name])
    return sd


def dit_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``DiT`` params → port ``DiT`` state dict."""
    p = _unwrap(params)
    sd: StateDict = {"scale_shift_table": _t(p["scale_shift_table_out"])}
    _conv(sd, "pos_embed.proj", p["pos_embed_proj"])
    _lin(sd, "proj_out", p["proj_out"])
    for i in ("1", "2"):
        _lin(sd, f"caption_projection.linear_{i}", p[f"caption_projection_{i}"])
    ada = p["adaln_single"]
    for i in ("1", "2"):
        _lin(sd, f"adaln_single.emb.timestep_embedder.linear_{i}", ada["timestep_embedder"][f"linear_{i}"])
    _lin(sd, "adaln_single.linear", ada["linear"])
    for j in range(config.num_vector_embeds):
        for i in ("1", "2"):
            _lin(sd, f"adaln_single.emb.vector_embedders.{j}.linear_{i}", ada[f"vector_embedder_{j}"][f"linear_{i}"])
    for b in range(config.depth):
        bp, k = p[f"block_{b}"], f"transformer_blocks.{b}"
        sd[f"{k}.scale_shift_table"] = _t(bp["scale_shift_table"])
        _attention(sd, f"{k}.attn1", bp["attn1"])
        _attention(sd, f"{k}.attn2", bp["attn2"])
        _lin(sd, f"{k}.ff.net.0.proj", bp["ff_in"])
        _lin(sd, f"{k}.ff.net.2", bp["ff_out"])
    return sd


# JAX module scopes inside a spatial transformer → the port's module names
_LORA_LEAVES = {"to_out": "to_out.0", "ff/proj_in": "ff.net.0.proj", "ff/proj_out": "ff.net.2"}


def lora_path_to_port(path: str, config) -> str:
    """A JAX ``lora_paths`` entry of the UNet (``[params/]down_0_attn_0/
    blocks_0/attn1/to_q/kernel``) → the port module name
    (``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``)."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] != "kernel":
        raise ValueError(f"not a kernel path: {path}")
    top, rest = parts[0], parts[1:-1]
    n = len(config.block_out_channels)
    m = re.fullmatch(r"(down|up)_(\d+)_attn_(\d+)", top)
    if m:
        lvl, j = int(m.group(2)), int(m.group(3))
        block = f"down_blocks.{lvl}" if m.group(1) == "down" else f"up_blocks.{n - 1 - lvl}"
        prefix = f"{block}.attentions.{j}"
    elif top == "mid_attn":
        prefix = "mid_block.attentions.0"
    else:
        raise ValueError(f"no LoRA target in {path}")
    if rest[0].startswith("blocks_"):
        inner = "/".join(rest[1:])
        for jax_name, name in _LORA_LEAVES.items():
            if inner == jax_name or inner.endswith("/" + jax_name):
                inner = inner[: -len(jax_name)] + name
        return f"{prefix}.transformer_blocks.{rest[0][len('blocks_'):]}.{inner.replace('/', '.')}"
    return f"{prefix}.{'.'.join(rest)}"


def lora_from_jax(lora: Dict[str, Any], config) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``init_lora`` tree of the UNet → the port's ``{module name:
    {"a": [in, r], "b": [r, out]}}`` (the same layouts)."""
    out = {}

    def walk(tree, path):
        if "a" in tree and "b" in tree and not isinstance(tree["a"], dict):
            out[lora_path_to_port("/".join(path), config)] = {"a": _t(tree["a"]), "b": _t(tree["b"])}
            return
        for k, v in tree.items():
            walk(v, path + [k])

    walk(lora, [])
    return out


def discriminator_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``ConvDiscriminator`` params → port state dict (bias-free convs)."""
    p = _unwrap(params)
    conv = lambda k: _t(np.asarray(p[k]["kernel"]).transpose(3, 2, 0, 1))
    sd: StateDict = {"conv_out.weight": conv("conv_out")}
    for i in range(config.num_stages):
        sd[f"conv_{i}.weight"] = conv(f"conv_{i}")
        if i > 0:
            sd[f"gn_{i}_scale"] = _t(p[f"gn_{i}_scale"])
            sd[f"gn_{i}_bias"] = _t(p[f"gn_{i}_bias"])
    return sd


def lpips_from_jax(params: Dict[str, Any]) -> StateDict:
    """JAX ``LPIPS`` params → port state dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    for name, conv in p["vgg"].items():
        _conv(sd, f"vgg.{name}", conv)
    for name, lin in p.items():
        if name.startswith("lin_"):
            sd[f"{name}.weight"] = _t(np.asarray(lin["kernel"]).transpose(3, 2, 0, 1))
    return sd
