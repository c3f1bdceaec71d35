"""ConditionerWrapper of the PyTorch port: run all conditioners, merge by type.

Port of ``flash_diffusion_tpu/models/embedders/wrapper.py``. Each
conditioner's ucg decision is forced through ``ucg_keys`` or drawn with
probability ``ucg_rate`` from an explicit ``torch.Generator`` (disabled by
``set_ucg_rate_zero``); outputs of one type concatenate on the last axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from .base import Conditioner

KEY2CATDIM = {"vector": -1, "crossattn": -1, "concat": -1, "attention_mask": -1}


class ConditionerWrapper(nn.Module):
    def __init__(self, conditioners: Sequence[Conditioner]):
        super().__init__()
        self.conditioners = nn.ModuleList(conditioners)

    def input_keys(self) -> List[str]:
        return [c.input_key for c in self.conditioners]

    def forward(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        ucg_keys: Optional[List[str]] = None,
        set_ucg_rate_zero: bool = False,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        ucg_keys = ucg_keys or []
        out: Dict[str, torch.Tensor] = {}
        for cond in self.conditioners:
            if cond.input_key in ucg_keys:
                force_zero = 1.0
            elif cond.ucg_rate > 0 and not set_ucg_rate_zero and generator is not None:
                draw = torch.rand((), generator=generator, device=generator.device)
                force_zero = float(draw.item() < cond.ucg_rate)
            else:
                force_zero = 0.0
            for k, v in cond(batch, force_zero).items():
                out[k] = torch.cat([out[k], v], dim=KEY2CATDIM[k]) if k in out else v
        return {"cond": out}
