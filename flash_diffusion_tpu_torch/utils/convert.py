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
MLPs as ``adaln_single.emb.vector_embedders.<i>``), the SD3 MMDiT (the
inverse of ``import_sd3_mmdit``), the SD VAE and SD3's (no quant convs), the CLIP-L,
OpenCLIP-bigG and T5 text towers, and for training the LoRA tree, the conv
discriminator and LPIPS (whose JAX param names are the port's); the
T2I-Adapter (JAX's names), ``ModuleEmbedder``'s layers, and the DPT (JAX
names → MiDaS's, its ConvTranspose kernels flipped: flax's does not flip,
torch's does); the CLIP vision tower (transformers' names) and
InceptionV3 (torchvision's names, its folded BatchNorms as BatchNorms that
apply the fold).

Imports no JAX: the tree arrives as numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

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
    if "bias" in p:
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
        for i in ("1", "2") if "attn2" in blk else ("1",):  # no attn2: a self-only block
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
    if config.mid_block_attn:
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


def _vae_mid(sd: StateDict, key: str, p, attn: bool) -> None:
    _resnet(sd, f"{key}.mid_block.resnets.0", p["mid_resnet_0"])
    _resnet(sd, f"{key}.mid_block.resnets.1", p["mid_resnet_1"])
    if attn:
        _norm(sd, f"{key}.mid_block.attentions.0.group_norm", p["mid_attn"]["group_norm"])
        _attention(sd, f"{key}.mid_block.attentions.0", p["mid_attn"]["attention"])


def vae_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``AutoencoderKL`` params → port ``AutoencoderKL`` state dict (the
    quant convs where the tree has them)."""
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
    _vae_mid(sd, "encoder", enc, config.mid_block_attn)
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    if "quant_conv" in p:  # SD3's VAE has no quant convs
        _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder", dec, config.mid_block_attn)
    for ui, lvl in enumerate(reversed(range(n))):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{ui}.resnets.{j}", dec[f"up_{lvl}_resnet_{j}"])
        if ui < n - 1:
            _conv(sd, f"decoder.up_blocks.{ui}.upsamplers.0.conv", dec[f"up_{lvl}_upsample"])
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    if "post_quant_conv" in p:
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


# JAX scopes inside an MMDiT block (``block_<i>``) → the port's names under
# ``transformer_blocks.<i>``
_MMDIT_BLOCK = {
    "norm1_linear": "norm1.linear", "norm1_context_linear": "norm1_context.linear",
    "to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v", "to_out": "attn.to_out.0",
    "add_q_proj": "attn.add_q_proj", "add_k_proj": "attn.add_k_proj", "add_v_proj": "attn.add_v_proj",
    "to_add_out": "attn.to_add_out", "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2",
    "ff_context_in": "ff_context.net.0.proj", "ff_context_out": "ff_context.net.2",
}


def mmdit_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``MMDiT`` params → port ``MMDiT`` state dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    _conv(sd, "pos_embed.proj", p["pos_embed_proj"])
    _lin(sd, "context_embedder", p["context_embedder"])
    for emb in ("timestep_embedder", "text_embedder"):
        for i in ("1", "2"):
            _lin(sd, f"time_text_embed.{emb}.linear_{i}", p[emb][f"linear_{i}"])
    _lin(sd, "norm_out.linear", p["norm_out_linear"])
    _lin(sd, "proj_out", p["proj_out"])
    for b in range(config.depth):
        bp, k = p[f"block_{b}"], f"transformer_blocks.{b}"
        for jax_name, name in _MMDIT_BLOCK.items():
            if jax_name in bp:
                _lin(sd, f"{k}.{name}", bp[jax_name])
        for q in ("q", "k"):
            if f"norm_{q}_scale" in bp:
                sd[f"{k}.attn.norm_{q}.weight"] = _t(bp[f"norm_{q}_scale"])
    return sd


# JAX module scopes inside a spatial transformer → the port's module names
_LORA_LEAVES = {"to_out": "to_out.0", "ff/proj_in": "ff.net.0.proj", "ff/proj_out": "ff.net.2"}
# JAX scopes inside a DiT block (``block_<i>``) → the port's names under
# ``transformer_blocks.<i>``
_DIT_LORA_LEAVES = {"to_out": "to_out.0", "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2"}
# The DiT's and the MMDiT's root head: JAX ``lora_paths`` gives it a pair,
# but it is a plain ``nn.Dense`` that never reads one (no effect on the
# output, a zero gradient), so the port's tree leaves it out
DIT_INERT_LORA = "proj_out"


def lora_path_to_port(path: str, config) -> Optional[str]:
    """A JAX ``lora_paths`` entry → the port module name: of the UNet
    (``[params/]down_0_attn_0/blocks_0/attn1/to_q/kernel`` →
    ``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``), of
    the DiT (``block_3/attn2/to_out/kernel`` →
    ``transformer_blocks.3.attn2.to_out.0``, ``block_3/ff_in/kernel`` →
    ``transformer_blocks.3.ff.net.0.proj``) or, for an MMDiT ``config``
    (one with ``joint_attention_dim``), of the MMDiT (``block_3/to_q/kernel``
    → ``transformer_blocks.3.attn.to_q``, ``block_3/ff_context_out/kernel``
    → ``transformer_blocks.3.ff_context.net.2``); a UNet's convolutions
    too, for conv pairs (``up_1_resnet_2/conv1/kernel`` →
    ``up_blocks.0.resnets.2.conv1`` in a 2-level UNet,
    ``down_0_downsample/conv/kernel`` → ``down_blocks.0.downsamplers.0.conv``,
    ``mid_resnet_1/conv2/kernel``, ``conv_in/kernel``); None for the DiT's
    or the MMDiT's inert root ``proj_out``."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] != "kernel":
        raise ValueError(f"not a kernel path: {path}")
    top, rest = parts[0], parts[1:-1]
    if top == DIT_INERT_LORA and not rest:
        return None
    m = re.fullmatch(r"block_(\d+)", top)
    if m and hasattr(config, "joint_attention_dim"):
        return f"transformer_blocks.{m.group(1)}.{_MMDIT_BLOCK[rest[-1]]}"
    if m:
        leaf = _DIT_LORA_LEAVES.get(rest[-1], rest[-1])
        return ".".join(["transformer_blocks", m.group(1), *rest[:-1], leaf])
    n = len(config.block_out_channels)
    if top in ("conv_in", "conv_out") and not rest:
        return top
    m = re.fullmatch(r"(down|up)_(\d+)_(resnet_(\d+)|downsample|upsample)", top) or re.fullmatch(
        r"mid_(resnet)_(\d+)", top)
    if m:  # the convolutions (and time_emb_proj) of a resnet, a down- or upsampler
        if top.startswith("mid_"):
            return f"mid_block.resnets.{m.group(2)}.{'.'.join(rest)}"
        lvl = int(m.group(2))
        block = f"down_blocks.{lvl}" if m.group(1) == "down" else f"up_blocks.{n - 1 - lvl}"
        if m.group(4) is not None:
            return f"{block}.resnets.{m.group(4)}.{'.'.join(rest)}"
        return f"{block}.{m.group(3)}rs.0.{'.'.join(rest)}"
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
    """JAX ``init_lora`` tree of the UNet, the DiT or the MMDiT → the port's
    ``{module name: {"a": [in, r], "b": [r, out]}}`` (the same layouts; a
    conv pair's ``a`` [kh, kw, in, r]), without the inert root pair
    (``DIT_INERT_LORA``)."""
    out = {}

    def walk(tree, path):
        if "a" in tree and "b" in tree and not isinstance(tree["a"], dict):
            name = lora_path_to_port("/".join(path), config)
            if name is not None:
                out[name] = {"a": _t(tree["a"]), "b": _t(tree["b"])}
            return
        for k, v in tree.items():
            walk(v, path + [k])

    walk(lora, [])
    return out


def lora_to_jax(lora: Dict[str, Dict[str, torch.Tensor]], config, paths) -> Dict[str, Any]:
    """``lora_from_jax``'s inverse: a port LoRA tree → the JAX ``init_lora``
    tree (nested dicts of numpy arrays, the same layouts), over ``paths``,
    JAX ``lora_paths`` of the same model (each mapped by
    ``lora_path_to_port``); every pair of ``lora`` must have its path."""
    by_name = {lora_path_to_port(p, config): p for p in paths}
    missing = sorted(set(lora) - set(by_name))
    if missing:
        raise KeyError(f"no JAX path for the port's LoRA pairs {missing}")
    out: Dict[str, Any] = {}
    for name, ab in lora.items():
        node = out
        for part in by_name[name].split("/"):
            node = node.setdefault(part, {})
        for k in ("a", "b"):
            node[k] = ab[k].detach().float().cpu().numpy()
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


def adapter_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``T2IAdapter`` params → port ``T2IAdapter`` state dict (the same
    names: ``conv_in``, ``down_{lvl}``, ``res_{lvl}_{j}.block1/2``)."""
    p = _unwrap(params)
    sd: StateDict = {}
    for lvl in range(len(config.channels)):
        name = "conv_in" if lvl == 0 else f"down_{lvl}"
        _conv(sd, name, p[name])
        for j in range(config.num_res_blocks):
            for blk in ("block1", "block2"):
                _conv(sd, f"res_{lvl}_{j}.{blk}", p[f"res_{lvl}_{j}"][blk])
    return sd


def module_embedder_from_jax(params: Dict[str, Any]) -> StateDict:
    """JAX ``ModuleEmbedder`` params (``layer_{i}`` of its ``_Stack``) → the
    port's: a Conv's kernel [*k, I, O] → ``layers.layer_{i}.conv.weight``
    [O, I, *k], a Dense's → ``layers.layer_{i}.weight``."""
    p = _unwrap(params)
    sd: StateDict = {}
    for name, layer in p.items():
        kernel = np.asarray(layer["kernel"])
        key = f"layers.{name}" if kernel.ndim == 2 else f"layers.{name}.conv"
        sd[f"{key}.weight"] = _t(kernel.T if kernel.ndim == 2 else kernel.transpose(
            kernel.ndim - 1, kernel.ndim - 2, *range(kernel.ndim - 2)))
        if "bias" in layer:
            sd[f"{key}.bias"] = _t(layer["bias"])
    return sd


def dpt_from_jax(params: Dict[str, Any], depth: int) -> StateDict:
    """JAX ``DPTDepth`` params → port ``DPTDepth`` state dict (MiDaS names).
    ``up_0``/``up_1``: a flax ``ConvTranspose`` kernel [kh, kw, I, O] is
    applied unflipped, so the torch weight [I, O, kh, kw] is its spatial
    flip; the port then computes what JAX computes."""
    p = _unwrap(params)
    sd: StateDict = {}
    bb, post = "pretrained.model", "pretrained.act_postprocess"
    _conv(sd, f"{bb}.patch_embed.proj", p["patch_embed"])
    sd[f"{bb}.cls_token"], sd[f"{bb}.pos_embed"] = _t(p["cls_token"]), _t(p["pos_embed"])
    for i in range(depth):
        blk, key = p[f"block_{i}"], f"{bb}.blocks.{i}"
        for jax_name, name in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _lin(sd, f"{key}.{name}", blk[jax_name])
        _norm(sd, f"{key}.norm1", blk["norm1"])
        _norm(sd, f"{key}.norm2", blk["norm2"])
    for lvl in range(4):
        _lin(sd, f"{post}{lvl + 1}.0.project.0", p[f"readout_{lvl}"])
        _conv(sd, f"{post}{lvl + 1}.3", p[f"proj_{lvl}"])
    for lvl in range(2):
        up = p[f"up_{lvl}"]
        sd[f"{post}{lvl + 1}.4.weight"] = _t(np.asarray(up["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        sd[f"{post}{lvl + 1}.4.bias"] = _t(up["bias"])
    _conv(sd, f"{post}4.4", p["down_3"])
    for i in range(1, 5):
        _conv(sd, f"scratch.layer{i}_rn", p[f"layer{i}_rn"])
        fusion = p[f"refinenet{i}"]
        _conv(sd, f"scratch.refinenet{i}.out_conv", fusion["out_conv"])
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in fusion:
                for c in ("conv1", "conv2"):
                    _conv(sd, f"scratch.refinenet{i}.{unit}.{c}", fusion[unit][c])
    for jax_name, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_conv3", 4)):
        _conv(sd, f"scratch.output_conv.{idx}", p[jax_name])
    return sd


def vision_from_jax(params: Dict[str, Any], config) -> StateDict:
    """JAX ``CLIPVisionModel`` params → port ``CLIPVisionModel`` state dict
    (transformers' names; the inverse of JAX ``import_clip_vision``)."""
    p = _unwrap(params)
    vm = "vision_model"
    sd: StateDict = {
        f"{vm}.embeddings.class_embedding": _t(p["class_embedding"]),
        f"{vm}.embeddings.position_embedding.weight": _t(p["position_embedding"]),
        f"{vm}.pre_layrnorm.weight": _t(p["pre_ln_scale"]),
        f"{vm}.pre_layrnorm.bias": _t(p["pre_ln_bias"]),
        f"{vm}.post_layernorm.weight": _t(p["post_ln_scale"]),
        f"{vm}.post_layernorm.bias": _t(p["post_ln_bias"]),
    }
    _conv(sd, f"{vm}.embeddings.patch_embedding", p["patch_embedding"])
    for i in range(config.num_layers):
        lp, k = p[f"layer_{i}"], f"{vm}.encoder.layers.{i}"
        for ln in ("1", "2"):
            sd[f"{k}.layer_norm{ln}.weight"] = _t(lp[f"ln{ln}_scale"])
            sd[f"{k}.layer_norm{ln}.bias"] = _t(lp[f"ln{ln}_bias"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{k}.self_attn.{name}", lp[name])
        _lin(sd, f"{k}.mlp.fc1", lp["fc1"])
        _lin(sd, f"{k}.mlp.fc2", lp["fc2"])
    if "visual_projection" in p:
        _lin(sd, "visual_projection", p["visual_projection"])
    return sd


def inception_from_jax(params: Dict[str, Any], eps: float = 1e-3) -> StateDict:
    """JAX ``InceptionV3Pool3`` params (each BatchNorm folded into a
    per-channel scale and bias) → port ``InceptionV3Pool3`` state dict
    (torchvision's names): the conv kernels, and a BatchNorm that applies
    the fold, weight = scale, bias = bias, mean 0 and variance 1 − eps."""
    sd: StateDict = {}

    def walk(node, prefix):
        if "conv" in node and "scale" in node:
            _conv(sd, f"{prefix}.conv", node["conv"])
            sd[f"{prefix}.bn.weight"], sd[f"{prefix}.bn.bias"] = _t(node["scale"]), _t(node["bias"])
            sd[f"{prefix}.bn.running_mean"] = torch.zeros(len(node["scale"]))
            sd[f"{prefix}.bn.running_var"] = torch.full((len(node["scale"]),), 1.0 - eps)
            sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
            return
        for name, child in node.items():
            walk(child, f"{prefix}.{name}" if prefix else name)

    walk(_unwrap(params), "")
    return sd
