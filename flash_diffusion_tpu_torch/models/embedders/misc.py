"""Scalar-metadata conditioner of the PyTorch port.

Port of ``flash_diffusion_tpu/models/embedders/misc.py::TimestepsEmbedder``:
a sinusoidal embedding of scalar metadata columns (SDXL's
``original_size_as_tuple``, ``crop_coords_top_left`` and
``target_size_as_tuple``) as "vector" conditioning. ``ModuleEmbedder`` and
``RawVectorEmbedder`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..layers import timestep_embedding
from .base import BaseConditionerConfig, Conditioner


@dataclasses.dataclass
class TimestepsEmbedderConfig(BaseConditionerConfig):
    num_channels: int = 256  # sinusoidal width per scalar
    flip_sin_to_cos: bool = True
    downscale_freq_shift: float = 0.0


class TimestepsEmbedder(Conditioner):
    """[B, k] scalars → [B, k·num_channels] fp32 "vector" conditioning. It
    has no parameters; an empty buffer follows ``.to`` and says which device
    the embedding is made on."""

    def __init__(self, config: TimestepsEmbedderConfig):
        super().__init__(config)
        self.register_buffer("_device_anchor", torch.empty(0), persistent=False)

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        cfg = self.config
        x = torch.as_tensor(batch[self.input_key], dtype=torch.float32,
                            device=self._device_anchor.device)
        if x.dim() == 1:
            x = x[:, None]
        b, k = x.shape
        emb = timestep_embedding(
            x.reshape(-1), cfg.num_channels,
            flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.downscale_freq_shift,
        )
        return {"vector": emb.reshape(b, k * cfg.num_channels)}
