"""Text conditioners of the PyTorch port: CLIP and T5.

Port of ``flash_diffusion_tpu/models/embedders/text.py::ClipEmbedder`` and
``T5TextEmbedder``. Tokenization stays host-side: an embedder reads integer
token ids from ``batch[f"{input_key}_ids"]`` (and T5 its padding mask from
``batch[f"{input_key}_mask"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..text_encoders import CLIPTextConfig, CLIPTextModel, T5Config, T5Encoder
from .base import BaseConditionerConfig, Conditioner


@dataclasses.dataclass
class ClipEmbedderConfig(BaseConditionerConfig):
    text_embedder_config: Optional[dict] = None  # CLIPTextConfig kwargs
    layer: str = "last"  # last | pooled | hidden
    layer_idx: Optional[int] = None  # for layer == "hidden" (e.g. -2 = penultimate)
    always_return_pooled: bool = False
    use_projection: bool = False  # SDXL text_encoder_2: project the pooled output

    def __post_init__(self):
        super().__post_init__()
        if self.layer not in ("last", "pooled", "hidden"):
            raise ValueError(f"layer {self.layer!r}: last, pooled or hidden")
        if self.layer == "hidden" and self.layer_idx is None:
            raise ValueError("layer_idx required for the hidden selection")


class ClipEmbedder(Conditioner):
    """CLIP text conditioner. crossattn ← the selected state: the final-LN'd
    last one (``last``), the pooled one as a 1-token sequence (``pooled``),
    or ``hidden_states[layer_idx]`` (``hidden``; -2 is the output of the
    penultimate layer, without the final LN). vector ← the pooled output
    (its projection with ``use_projection``) when ``always_return_pooled``."""

    def __init__(self, config: ClipEmbedderConfig):
        super().__init__(config)
        enc_cfg = CLIPTextConfig(**(config.text_embedder_config or {}))
        if config.use_projection and enc_cfg.projection_dim is None:
            enc_cfg.projection_dim = enc_cfg.hidden_size
        self.encoder_config = enc_cfg
        self.module = CLIPTextModel(enc_cfg)
        self.ids_key = f"{config.input_key}_ids"

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        cfg = self.config
        device = self.module.text_model.final_layer_norm.weight.device
        ids = torch.as_tensor(batch[self.ids_key], dtype=torch.long, device=device)
        out = self.module(ids)
        if cfg.layer == "last":
            hidden = out["last_hidden_state"]
        elif cfg.layer == "pooled":
            hidden = out["pooled_output"][:, None, :]
        else:
            hidden = out["hidden_states"][cfg.layer_idx]
        result = {"crossattn": hidden}
        if cfg.always_return_pooled:
            result["vector"] = out["text_embeds"] if cfg.use_projection else out["pooled_output"]
        return result


@dataclasses.dataclass
class T5TextEmbedderConfig(BaseConditionerConfig):
    text_embedder_config: Optional[dict] = None  # T5Config kwargs
    max_length: int = 120  # Pixart uses 120 T5 tokens
    return_attention_mask: bool = True


class T5TextEmbedder(Conditioner):
    """T5 conditioner: crossattn ← the encoder's output; it also surfaces the
    padding mask (all ones when the batch has none) as the
    ``attention_mask`` conditioning, which Pixart's cross-attention reads.
    ``force_zero`` zeroes the embedding but never the mask."""

    def __init__(self, config: T5TextEmbedderConfig):
        super().__init__(config)
        self.encoder_config = T5Config(**(config.text_embedder_config or {}))
        self.module = T5Encoder(self.encoder_config)
        self.ids_key = f"{config.input_key}_ids"
        self.mask_key = f"{config.input_key}_mask"

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        device = self.module.shared.weight.device
        ids = torch.as_tensor(batch[self.ids_key], dtype=torch.long, device=device)
        mask = batch.get(self.mask_key)
        mask = torch.ones_like(ids) if mask is None else torch.as_tensor(mask, device=device)
        out = {"crossattn": self.module(ids, mask)}
        if self.config.return_attention_mask:
            out["attention_mask"] = mask
        return out

    def forward(self, batch: Dict[str, Any], force_zero: float = 0.0) -> Dict[str, torch.Tensor]:
        out = self.embed(batch)
        out["crossattn"] = out["crossattn"] * (1.0 - float(force_zero))
        return out
