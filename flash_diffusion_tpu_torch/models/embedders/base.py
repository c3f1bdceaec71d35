"""Conditioner base (conditioning by type, ucg dropout) of the PyTorch port.

Port of ``flash_diffusion_tpu/models/embedders/base.py``: each conditioner
consumes one batch key and emits a dict of conditioning tensors by type
("crossattn" for CLIP). Classifier-free dropout ("ucg") multiplies a
conditioner's whole output by (1 − force_zero).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn as nn

from ...config import BaseConfig

# the conditioning type of an output by its rank (JAX ``embedders/base.py``)
DIM2CONDITIONING = {2: "vector", 3: "crossattn", 4: "concat"}


@dataclasses.dataclass
class BaseConditionerConfig(BaseConfig):
    input_key: str = "text"
    ucg_rate: float = 0.0


class Conditioner(nn.Module):
    """Base class. Subclasses own their encoder and implement ``embed``.

    ``forward(batch, force_zero)`` returns {conditioning_type: tensor};
    ``force_zero`` in [0, 1] is multiplied into every output (1 → unconditional).
    """

    def __init__(self, config: BaseConditionerConfig):
        super().__init__()
        self.config = config
        self.input_key = config.input_key
        self.ucg_rate = config.ucg_rate

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, batch: Dict[str, Any], force_zero: float = 0.0) -> Dict[str, torch.Tensor]:
        keep = 1.0 - float(force_zero)
        return {k: v * keep for k, v in self.embed(batch).items()}
