"""Training configuration and the optimizers of the port.

Port of ``flash_diffusion_tpu/trainer/training_config.py:20-111``: two
optimizer groups, generator (LoRA) and discriminator, each with its name,
learning rate, keyword arguments and optional learning-rate schedule.
``build_optimizer`` gives optax's update rules, not torch's: Adam and AdamW
(``weight_decay`` 1e-4 by default, the first moment stored in
``adam_mu_dtype``, bf16 by default), Adadelta, Adagrad, RMSprop and SGD,
each with optax's defaults; an optional global-norm clip before the rule;
the schedule indexed by the count of applied updates, as optax's
``scale_by_schedule`` counts them; and ``gradient_accumulation_steps`` with
``optax.MultiSteps`` semantics: the gradients of k micro-steps are
averaged, and the clip, the rule, its count and its weight decay act only
on the k-th.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import BaseConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
OPTIMIZERS = ("Adam", "AdamW", "Adadelta", "Adagrad", "RMSprop", "SGD")

_f32 = np.float32


def _cosine(lr: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    def schedule(count):
        count = _f32(min(count, decay_steps))
        decayed = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * count / _f32(decay_steps)))
        return float(_f32(lr) * (_f32(1.0 - alpha) * decayed + _f32(alpha)))

    return schedule


def _exponential(lr: float, transition_steps: int = 10_000, decay_rate: float = 0.99, **kw):
    def schedule(count):
        if count <= 0:
            return lr
        return float(_f32(lr) * np.power(_f32(decay_rate), _f32(count) / _f32(transition_steps)))

    return schedule


def _warmup_cosine(lr: float, warmup_steps: int = 1_000, decay_steps: int = 100_000, **kw):
    cosine = _cosine(lr, decay_steps - warmup_steps)

    def schedule(count):
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = _f32(1.0) - _f32(min(max(count, 0), warmup_steps)) / _f32(warmup_steps)
        return float(_f32(-lr) * frac + _f32(lr))

    return schedule


# ``lr_schedulers_name`` → schedule of the count of applied updates, fp32, as
# JAX's ``_SCHEDULES`` builds them from optax
SCHEDULES = {
    "constant": lambda lr, **kw: (lambda count: lr),
    "cosine": lambda lr, decay_steps=100_000, **kw: _cosine(lr, decay_steps),
    "exponential": _exponential,
    "warmup_cosine": _warmup_cosine,
}


def _zeros(params, dtype=None):
    return [torch.zeros_like(p, dtype=dtype or p.dtype) for p in params]


class Optimizer:
    """One optax optimizer over a list of tensors, in place:
    ``MultiSteps(chain(clip_by_global_norm?, <rule>, scale_by_learning_rate))``.

    ``step`` reads each tensor's ``.grad`` (zeros where None); with
    ``accumulation_steps`` k > 1 it averages them into ``acc`` as optax does
    (acc + (g − acc)/(n + 1)) and updates the tensors on every k-th call
    only. ``count`` is the number of applied updates, the schedule's index;
    ``mini_step`` the position inside the accumulation. Slots are lists of
    tensors beside the parameters (``mu``, ``nu`` for Adam; ``e_g``, ``e_x``
    for Adadelta; ``sum_sq`` for Adagrad; ``nu`` (and ``mu`` centered,
    ``trace`` with momentum) for RMSprop; ``trace`` for SGD with momentum).
    Rounding as the JAX trainer's compiled step gives it: Adam's new first
    moment is (1 − b1)·g + b1·μ in fp32, with b1 rounded to μ's dtype (XLA
    fuses the product and the sum without rounding b1·μ to it), used
    unrounded for this step and stored in ``mu_dtype``; its bias
    corrections are 1 − b^count in fp32."""

    def __init__(self, params: Iterable[torch.Tensor], name: str = "AdamW", lr: float = 1e-5,
                 schedule: Optional[Callable[[int], float]] = None, clip_norm: Optional[float] = None,
                 accumulation_steps: int = 1, **kwargs):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r} (one of {OPTIMIZERS})")
        self.params = list(params)
        self.name, self.lr, self.schedule, self.clip_norm = name, lr, schedule, clip_norm
        self.accumulation_steps = int(accumulation_steps)
        self.count = self.mini_step = 0
        self.acc = _zeros(self.params) if self.accumulation_steps > 1 else []
        self.weight_decay = 0.0
        self._init_rule(name, dict(kwargs))

    def _init_rule(self, name: str, kw: Dict[str, Any]) -> None:
        take = lambda key, default: kw.pop(key, default)
        p = self.params
        if name in ("Adam", "AdamW"):
            self.b1, self.b2 = take("b1", 0.9), take("b2", 0.999)
            self.eps, self.eps_root = take("eps", 1e-8), take("eps_root", 0.0)
            self.weight_decay = take("weight_decay", 1e-4 if name == "AdamW" else 0.0)
            mu_dtype = take("mu_dtype", None)
            mu_dtype = _DTYPES[mu_dtype] if isinstance(mu_dtype, str) else mu_dtype
            self.mu, self.nu = _zeros(p, mu_dtype), _zeros(p)
            self.slots = ("mu", "nu")
        elif name == "Adadelta":
            self.rho, self.eps = take("rho", 0.9), take("eps", 1e-6)
            self.weight_decay = take("weight_decay", 0.0)
            self.e_g, self.e_x = _zeros(p), _zeros(p)
            self.slots = ("e_g", "e_x")
        elif name == "Adagrad":
            init, self.eps = take("initial_accumulator_value", 0.1), take("eps", 1e-7)
            self.sum_sq = [torch.full_like(t, init) for t in p]
            self.slots = ("sum_sq",)
        elif name == "RMSprop":
            self.decay, self.eps = take("decay", 0.9), take("eps", 1e-8)
            init = take("initial_scale", 0.0)
            self.eps_in_sqrt, self.centered = take("eps_in_sqrt", True), take("centered", False)
            self.momentum, self.nesterov = take("momentum", None), take("nesterov", False)
            self.nu = [torch.full_like(t, init) for t in p]
            self.slots = ("nu",)
            if self.centered:
                self.mu, self.slots = _zeros(p), ("mu", "nu")
            if self.momentum is not None:
                self.trace, self.slots = _zeros(p), self.slots + ("trace",)
        else:  # SGD
            self.momentum, self.nesterov = take("momentum", None), take("nesterov", False)
            acc_dtype = take("accumulator_dtype", None)
            acc_dtype = _DTYPES[acc_dtype] if isinstance(acc_dtype, str) else acc_dtype
            self.slots = ()
            if self.momentum is not None:
                self.trace, self.slots = _zeros(p, acc_dtype), ("trace",)
        if kw:
            raise ValueError(f"{name}: keyword arguments not ported: {sorted(kw)}")

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Take this micro-step's gradients; True when it applied an update."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accumulation_steps > 1:
            n = self.mini_step
            self.acc = [a + (g - a) / float(n + 1) for a, g in zip(self.acc, grads)]
            self.mini_step = (n + 1) % self.accumulation_steps
            if self.mini_step:
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            if not norm < self.clip_norm:
                grads = [g / norm.to(g.dtype) * self.clip_norm for g in grads]
        updates = self._rule(grads)
        scale = -(self.schedule(self.count) if self.schedule is not None else self.lr)
        if self.name == "RMSprop" and self.momentum is not None:  # optax traces after the scaling
            updates = self._trace([u * scale for u in updates])
            scale = None
        for p, u in zip(self.params, updates):
            p.add_((u * scale if scale is not None else u).to(p.dtype))
        self.count += 1
        return True

    def _trace(self, updates: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i, g in enumerate(updates):
            t = g + self.momentum * self.trace[i]
            out.append(g + self.momentum * t if self.nesterov else t)
            self.trace[i] = t.to(self.trace[i].dtype)
        return out

    def _rule(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        name, ps = self.name, self.params
        if name in ("Adam", "AdamW"):
            count = torch.tensor(self.count + 1, dtype=torch.float32)
            bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
            bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
            consts, out = {}, []  # b1 rounded to μ's dtype and the corrections, once per (device, dtype)
            for i, (p, g) in enumerate(zip(ps, grads)):
                key = (g.device, self.mu[i].dtype)
                if key not in consts:
                    consts[key] = (float(torch.tensor(self.b1, dtype=key[1])), bc1.to(key[0]), bc2.to(key[0]))
                b1, c1, c2 = consts[key]
                mu = (1 - self.b1) * g + self.mu[i].float() * b1
                self.nu[i] = (1 - self.b2) * g * g + self.b2 * self.nu[i]
                u = (mu / c1) / (torch.sqrt(self.nu[i] / c2 + self.eps_root) + self.eps)
                out.append(u + self.weight_decay * p if self.weight_decay else u)
                self.mu[i] = mu.to(self.mu[i].dtype)
            return out
        if name == "Adadelta":
            out = []
            for i, (p, g) in enumerate(zip(ps, grads)):
                g = g + self.weight_decay * p
                self.e_g[i] = (1 - self.rho) * g ** 2 + self.rho * self.e_g[i]
                u = torch.sqrt(self.e_x[i] + self.eps) / torch.sqrt(self.e_g[i] + self.eps) * g
                self.e_x[i] = (1 - self.rho) * u ** 2 + self.rho * self.e_x[i]
                out.append(u)
            return out
        if name == "Adagrad":
            out = []
            for i, g in enumerate(grads):
                s = g * g + self.sum_sq[i]
                self.sum_sq[i] = s
                out.append(torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s)) * g)
            return out
        if name == "RMSprop":
            out = []
            for i, g in enumerate(grads):
                self.nu[i] = (1 - self.decay) * g ** 2 + self.decay * self.nu[i]
                var = self.nu[i]
                if self.centered:
                    self.mu[i] = (1 - self.decay) * g + self.decay * self.mu[i]
                    var = var - self.mu[i] * self.mu[i]
                s = torch.rsqrt(var + self.eps) if self.eps_in_sqrt else 1 / (torch.sqrt(var) + self.eps)
                out.append(s * g)
            return out
        return self._trace(grads) if self.momentum is not None else grads  # SGD

    def state_dict(self) -> Dict[str, Any]:
        """The moments, counts and accumulators (tensors referenced, not
        copied)."""
        return {"name": self.name, "count": self.count, "mini_step": self.mini_step, "acc": list(self.acc),
                "slots": {k: list(getattr(self, k)) for k in self.slots}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state["name"] != self.name or set(state["slots"]) != set(self.slots):
            raise ValueError(f"optimizer state of {state['name']} {sorted(state['slots'])} does not fit "
                             f"{self.name} {sorted(self.slots)}")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.acc = [t.to(p.device, p.dtype).clone() for t, p in zip(state["acc"], self.params)]
        for k in self.slots:
            own = getattr(self, k)
            setattr(self, k, [t.to(o.device, o.dtype).clone() for t, o in zip(state["slots"][k], own)])


@dataclasses.dataclass
class TrainingConfig(BaseConfig):
    # one entry per optimizer: [generator, discriminator]
    optimizers_name: List[str] = field(default_factory=lambda: ["AdamW", "AdamW"])
    learning_rates: List[float] = field(default_factory=lambda: [1e-5, 1e-5])
    optimizers_kwargs: List[dict] = field(default_factory=lambda: [{}, {}])
    lr_schedulers_name: Optional[List[Optional[str]]] = None
    lr_schedulers_kwargs: Optional[List[Optional[dict]]] = None
    gradient_clip_norm: Optional[float] = None
    # k micro-steps average into one update (optax.MultiSteps); max_steps and
    # the stage boundaries count micro-steps
    gradient_accumulation_steps: int = 1
    adam_mu_dtype: Optional[str] = "bfloat16"
    log_keys: List[str] = field(default_factory=lambda: ["text"])
    log_samples_model_kwargs: Dict[str, Any] = field(
        default_factory=lambda: dict(num_steps=[1, 2, 4], guidance_scale=1.0))
    log_every_n_steps: int = 50
    sample_every_n_steps: int = 200
    checkpoint_every_n_steps: int = 5000
    checkpoint_dir: str = "checkpoints"
    max_steps: Optional[int] = None
    seed: int = 0
    wgan_clip: float = 0.01
    ema_decay: Optional[float] = None  # the EMA student; None: not tracked
    val_every_n_steps: Optional[int] = None  # validation cadence; None: none
    val_batches: int = 8

    def __post_init__(self):
        super().__post_init__()
        n = len(self.optimizers_name)
        if len(self.learning_rates) != n:
            raise ValueError("one learning rate per optimizer")
        if self.lr_schedulers_name is not None and len(self.lr_schedulers_name) != n:
            raise ValueError("one learning-rate schedule (or None) per optimizer")
        self.optimizers_kwargs = list(self.optimizers_kwargs) + [{}] * (n - len(self.optimizers_kwargs))

    def build_optimizer(self, index: int, params: Iterable[torch.Tensor]) -> Optimizer:
        name = self.optimizers_name[index]
        lr = self.learning_rates[index]
        kwargs = dict(self.optimizers_kwargs[index] or {})
        schedule = None
        if self.lr_schedulers_name and self.lr_schedulers_name[index]:
            sched_kwargs = (self.lr_schedulers_kwargs or [{}] * len(self.optimizers_name))[index] or {}
            schedule = SCHEDULES[self.lr_schedulers_name[index]](lr, **sched_kwargs)
        if name in ("Adam", "AdamW") and "mu_dtype" not in kwargs and self.adam_mu_dtype:
            kwargs["mu_dtype"] = self.adam_mu_dtype
        return Optimizer(params, name, lr, schedule=schedule, clip_norm=self.gradient_clip_norm,
                         accumulation_steps=self.gradient_accumulation_steps, **kwargs)
