"""EMA (exponential moving average) of a LoRA tree.

Port of ``flash_diffusion_tpu/utils/ema.py:18-40``: the EMA student is the
sampling and export target. Trees are dicts of tensors, nested to any depth
(the port's LoRA tree is ``{module: {"a": A, "b": B}}``).
"""

from __future__ import annotations

from typing import Any

import torch


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_ema(params: Any) -> Any:
    """The EMA starts as a copy of the tracked tree (its own storage, no
    autograd history)."""
    return _map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def update_ema(ema: Any, params: Any, decay: float = 0.9999) -> Any:
    """ema ← decay·ema + (1 − decay)·params, leaf by leaf in the EMA's
    dtype, in place; returns ``ema``."""

    def upd(e, p):
        e.copy_((e * decay + p.detach().to(e.dtype) * (1.0 - decay)).to(e.dtype))
        return e

    return _map(upd, ema, params)


def ema_warmup_decay(step, max_decay: float = 0.9999, gamma: float = 1.0, power: float = 0.6667) -> torch.Tensor:
    """The inverse-gamma warmup of the decay: 1 − (1 + step/γ)^−power,
    clipped to [0, max_decay], from step 1, in fp32."""
    step = torch.clamp(torch.as_tensor(step, dtype=torch.int32), min=1)
    value = 1.0 - (1.0 + step.float() / gamma) ** (-power)
    return torch.clamp(value, 0.0, max_decay)
