"""CLIP text conditioner of the PyTorch port.

Port of ``flash_diffusion_tpu/models/embedders/text.py::ClipEmbedder``.
Tokenization stays host-side: the embedder reads integer token ids from
``batch[f"{input_key}_ids"]``. The T5 embedder is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..text_encoders import CLIPTextConfig, CLIPTextModel
from .base import BaseConditionerConfig, Conditioner


@dataclasses.dataclass
class ClipEmbedderConfig(BaseConditionerConfig):
    text_embedder_config: Optional[dict] = None  # CLIPTextConfig kwargs


class ClipEmbedder(Conditioner):
    """crossattn ← the last hidden state (the JAX ``layer="last"`` selection,
    SD1.5's). The penultimate-layer and pooled selections SDXL uses are not
    ported yet."""

    def __init__(self, config: ClipEmbedderConfig):
        super().__init__(config)
        self.encoder_config = CLIPTextConfig(**(config.text_embedder_config or {}))
        self.module = CLIPTextModel(self.encoder_config)
        self.ids_key = f"{config.input_key}_ids"

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        device = self.module.text_model.final_layer_norm.weight.device
        ids = torch.as_tensor(batch[self.ids_key], dtype=torch.long, device=device)
        return {"crossattn": self.module(ids)["last_hidden_state"]}
