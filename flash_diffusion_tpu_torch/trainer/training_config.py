"""Training configuration and the optimizer of the port.

Port of ``flash_diffusion_tpu/trainer/training_config.py``: two optimizer
groups, generator (LoRA) and discriminator, each with its name, learning
rate and keyword arguments. ``build_optimizer`` gives optax's Adam/AdamW,
not torch's: ``weight_decay`` 1e-4 by default, the first moment stored in
``adam_mu_dtype`` (bf16 by default), an optional global-norm clip.
Learning-rate schedules, gradient accumulation, EMA and validation wait.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Iterable, List, Optional

import torch

from ..config import BaseConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


class AdamW:
    """``optax.chain(clip_by_global_norm?, adamw(lr, b1, b2, eps, eps_root,
    mu_dtype, weight_decay))`` on a list of tensors, in place.

    Rounding as optax does it: the new first moment is (1 − b1)·g + b1·μ with
    b1·μ in μ's dtype (b1 itself rounded to it), used unrounded for this
    step's update and stored in ``mu_dtype``; the bias corrections are
    1 − b^count in fp32; update = μ̂ / (sqrt(ν̂ + eps_root) + eps) +
    weight_decay·p, times −lr, added to p in p's dtype."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4, mu_dtype: Optional[torch.dtype] = None,
                 clip_norm: Optional[float] = None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.eps_root = lr, b1, b2, eps, eps_root
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            if norm >= self.clip_norm:
                grads = [g / norm.to(g.dtype) * self.clip_norm for g in grads]
        self.count += 1
        count = torch.tensor(self.count, dtype=torch.float32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        consts = {}  # b1 in μ's dtype and the corrections, copied once per (device, dtype)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            key = (g.device, self.mu[i].dtype)
            if key not in consts:
                consts[key] = (torch.tensor(self.b1, dtype=key[1], device=key[0]), bc1.to(key[0]), bc2.to(key[0]))
            b1, c1, c2 = consts[key]
            mu = (1 - self.b1) * g + self.mu[i] * b1
            self.nu[i] = (1 - self.b2) * g * g + self.b2 * self.nu[i]
            update = (mu / c1) / (torch.sqrt(self.nu[i] / c2 + self.eps_root) + self.eps)
            update = update + self.weight_decay * p
            p.add_((-self.lr * update).to(p.dtype))
            self.mu[i] = mu.to(self.mu[i].dtype)


@dataclasses.dataclass
class TrainingConfig(BaseConfig):
    # one entry per optimizer: [generator, discriminator]
    optimizers_name: List[str] = field(default_factory=lambda: ["AdamW", "AdamW"])
    learning_rates: List[float] = field(default_factory=lambda: [1e-5, 1e-5])
    optimizers_kwargs: List[dict] = field(default_factory=lambda: [{}, {}])
    gradient_clip_norm: Optional[float] = None
    adam_mu_dtype: Optional[str] = "bfloat16"
    log_every_n_steps: int = 50
    max_steps: Optional[int] = None
    seed: int = 0
    wgan_clip: float = 0.01

    def __post_init__(self):
        super().__post_init__()
        n = len(self.optimizers_name)
        if len(self.learning_rates) != n:
            raise ValueError("one learning rate per optimizer")
        self.optimizers_kwargs = list(self.optimizers_kwargs) + [{}] * (n - len(self.optimizers_kwargs))

    def build_optimizer(self, index: int, params: Iterable[torch.Tensor]) -> AdamW:
        name = self.optimizers_name[index]
        kwargs = dict(self.optimizers_kwargs[index] or {})
        if name == "Adam":
            kwargs.setdefault("weight_decay", 0.0)
        elif name != "AdamW":
            raise ValueError(f"optimizer {name!r} is not ported yet (Adam, AdamW)")
        if "mu_dtype" in kwargs:
            kwargs["mu_dtype"] = _DTYPES[kwargs["mu_dtype"]]
        elif self.adam_mu_dtype:
            kwargs["mu_dtype"] = _DTYPES[self.adam_mu_dtype]
        return AdamW(params, self.learning_rates[index], clip_norm=self.gradient_clip_norm, **kwargs)
