"""SD3's triple-text-encoder conditioning of the PyTorch port.

Port of ``flash_diffusion_tpu/models/embedders/sd3.py``: CLIP-L and CLIP-G
(their penultimate hidden states and projected pooled outputs) and, where
present, T5, packed to SD3's context layout:

    crossattn = [ zero-pad(clipL_hidden ⊕ clipG_hidden → t5_dim) ; t5_tokens ]
    vector    = [ clipL_pooled_proj ; clipG_pooled_proj ]          (2048)

Without a T5 tower (diffusers' ``text_encoder_3=None``) the T5 tokens are
``t5_fallback_len`` zero rows, 77 by default: the MMDiT was trained on the
77 + 77 = 154-token context, and its predictions move if they are dropped.
The T5 padding mask is not passed on: the joint attention is unmasked.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .text import T5TextEmbedder
from .wrapper import ConditionerWrapper


class T5AsSD3Embedder(T5TextEmbedder):
    """A T5 conditioner that emits its tokens as ``t5_crossattn``, apart from
    the CLIP streams, for ``SD3Conditioner`` to pack."""

    def forward(self, batch: Dict[str, Any], force_zero: float = 0.0) -> Dict[str, torch.Tensor]:
        out = super().forward(batch, force_zero)
        renamed = {"t5_crossattn": out["crossattn"]}
        if "attention_mask" in out:
            renamed["attention_mask"] = out["attention_mask"]
        return renamed


class SD3Conditioner(ConditionerWrapper):
    """``ConditionerWrapper`` over [clip_l, clip_g, (T5AsSD3Embedder)] whose
    output is packed to the SD3 layout. ``t5_dim`` is the joint width the
    CLIP stream is padded to (4096); without T5 tokens, ``t5_fallback_len``
    zero tokens of that width follow the CLIP tokens."""

    def __init__(self, conditioners, t5_dim: Optional[int] = None, t5_fallback_len: int = 77):
        super().__init__(conditioners)
        self.t5_dim, self.t5_fallback_len = t5_dim, t5_fallback_len

    def forward(self, batch, generator=None, ucg_keys=None, set_ucg_rate_zero=False):
        out = super().forward(batch, generator, ucg_keys, set_ucg_rate_zero)
        cond = out["cond"]
        clip_tokens = cond.get("crossattn")
        t5_tokens = cond.pop("t5_crossattn", None)
        if t5_tokens is not None and clip_tokens is not None:
            pad = t5_tokens.shape[-1] - clip_tokens.shape[-1]
            if pad > 0:
                clip_tokens = F.pad(clip_tokens, (0, pad))
            cond["crossattn"] = torch.cat([clip_tokens, t5_tokens.to(clip_tokens.dtype)], dim=1)
        elif t5_tokens is not None:
            cond["crossattn"] = t5_tokens
        elif clip_tokens is not None and self.t5_dim:
            pad = self.t5_dim - clip_tokens.shape[-1]
            if pad > 0:
                clip_tokens = F.pad(clip_tokens, (0, pad))
            zeros_t5 = clip_tokens.new_zeros(clip_tokens.shape[0], self.t5_fallback_len, self.t5_dim)
            cond["crossattn"] = torch.cat([clip_tokens, zeros_t5], dim=1)
        cond.pop("attention_mask", None)
        return out
