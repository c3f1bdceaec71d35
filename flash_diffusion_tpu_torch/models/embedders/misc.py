"""Scalar-metadata conditioners of the PyTorch port.

Port of ``flash_diffusion_tpu/models/embedders/misc.py::TimestepsEmbedder``:
a sinusoidal embedding of scalar metadata columns (SDXL's
``original_size_as_tuple``, ``crop_coords_top_left`` and
``target_size_as_tuple``) as "vector" conditioning; and
``RawVectorEmbedder``: scalar metadata passed through as the "vector"
conditioning (Pixart's resolution and aspect ratio, which its DiT embeds);
and ``ModuleEmbedder``: a stack of layers built from flax-style specs over
one batch key (``embedders/misc.py:56-125``), its output's conditioning type
from its rank unless the config names one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import timestep_embedding
from .base import DIM2CONDITIONING, BaseConditionerConfig, Conditioner


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


@dataclasses.dataclass
class RawVectorEmbedderConfig(BaseConditionerConfig):
    """Scalar metadata passed straight through as "vector" conditioning."""


class RawVectorEmbedder(Conditioner):
    """[B, k] (or [B]) scalars → [B, k] fp32 "vector" conditioning, on the
    device of an empty buffer that follows ``.to``; no parameters."""

    def __init__(self, config: RawVectorEmbedderConfig):
        super().__init__(config)
        self.register_buffer("_device_anchor", torch.empty(0), persistent=False)

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(batch[self.input_key], dtype=torch.float32, device=self._device_anchor.device)
        return {"vector": x[:, None] if x.dim() == 1 else x}


# flax's activations: ``nn.gelu`` is the tanh approximation by default
_ACTIVATIONS = {"silu": F.silu, "relu": F.relu, "gelu": functools.partial(F.gelu, approximate="tanh")}
_CONV_ARGS = {"features", "kernel_size", "strides", "padding", "use_bias"}
_DENSE_ARGS = {"features", "use_bias"}


def _pairs(padding, kernel: Sequence[int], strides: Sequence[int], size: Sequence[int]) -> List[Tuple[int, int]]:
    """flax's padding of a convolution as (low, high) per spatial axis:
    "SAME" (out = ⌈in / stride⌉, the extra row at the high end), "VALID",
    an int on both ends of every axis, or one int or (low, high) an axis."""
    if padding == "SAME":
        out = []
        for n, k, s in zip(size, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if padding == "VALID":
        return [(0, 0)] * len(kernel)
    if isinstance(padding, int):
        return [(padding, padding)] * len(kernel)
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


class _FlaxConv(nn.Module):
    """flax ``nn.Conv`` over [B, *spatial, C] (1 or 2 spatial axes, channels
    last), its arguments and defaults: ``features``, ``kernel_size``,
    ``strides`` (1), ``padding`` ("SAME"), ``use_bias`` (True)."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=1, padding="SAME", use_bias=True):
        super().__init__()
        self.kernel = (kernel_size,) if isinstance(kernel_size, int) else tuple(kernel_size)
        n = len(self.kernel)
        self.strides = (strides,) * n if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        conv = {1: nn.Conv1d, 2: nn.Conv2d}.get(n)
        if conv is None:
            raise ValueError(f"Conv over {n} spatial axes is not ported (1 or 2)")
        self.conv = conv(in_channels, features, self.kernel, stride=self.strides, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.kernel)
        pads = _pairs(self.padding, self.kernel, self.strides, x.shape[1:1 + n])
        x = x.movedim(-1, 1)
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])  # F.pad takes the last axis first
        return self.conv(x).movedim(1, -1)


class _FlaxDense(nn.Linear):
    """flax ``nn.Dense``: ``features``, ``use_bias`` (True)."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = True):
        super().__init__(in_channels, features, bias=use_bias)


def _build_stack(specs: Sequence[dict], in_channels: int) -> nn.ModuleDict:
    """The parametrized layers of ``specs`` (``{"layer": "Conv" | "Dense" |
    "silu" | "relu" | "gelu", ...flax arguments}``) on ``in_channels``
    input channels: each Conv or Dense under ``layer_{i}`` (its index in the
    specs, JAX's name); the activations have no module and are applied by
    name (``_ACTIVATIONS``)."""
    layers = nn.ModuleDict()
    ch = in_channels
    for i, spec in enumerate(specs):
        spec = dict(spec)
        kind = spec.pop("layer")
        if kind in ("Conv", "Dense"):
            allowed = _CONV_ARGS if kind == "Conv" else _DENSE_ARGS
            if set(spec) - allowed:
                raise ValueError(f"{kind} arguments not ported: {sorted(set(spec) - allowed)}")
            layers[f"layer_{i}"] = (_FlaxConv if kind == "Conv" else _FlaxDense)(ch, **spec)
            ch = spec["features"]
        elif kind not in _ACTIVATIONS or spec:
            raise ValueError(f"layer {kind!r} {spec}: Conv, Dense, silu, relu or gelu")
    return layers


@dataclasses.dataclass
class ModuleEmbedderConfig(BaseConditionerConfig):
    # e.g. [{"layer": "Conv", "features": 4, "kernel_size": [3, 3]}, {"layer": "silu"}]
    layers: Optional[List[dict]] = None
    conditioning_type: Optional[str] = None  # default: from the output's rank
    in_channels: Optional[int] = None  # the input's channels; None: from the first batch


class ModuleEmbedder(Conditioner):
    """A stack of flax-style layers over ``batch[input_key]`` (channels
    last, as JAX), e.g. a conv over a low-resolution image for ``concat``
    conditioning. Its layers are built in ``__init__`` when the config gives
    ``in_channels``, else at the first batch (``build``), on the device of
    an empty buffer that follows ``.to``."""

    def __init__(self, config: ModuleEmbedderConfig):
        super().__init__(config)
        self.register_buffer("_device_anchor", torch.empty(0), persistent=False)
        self.specs = [dict(s) for s in (config.layers or ())]
        self.layers = None
        if config.in_channels is not None:
            self.build(config.in_channels)

    def build(self, in_channels: int) -> None:
        """The layers over ``in_channels`` input channels (once)."""
        if self.layers is None:
            self.layers = _build_stack(self.specs, in_channels).to(self._device_anchor.device)

    def embed(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(batch[self.input_key], dtype=torch.float32, device=self._device_anchor.device)
        self.build(x.shape[-1])
        for i, spec in enumerate(self.specs):
            name = f"layer_{i}"
            x = self.layers[name](x) if name in self.layers else _ACTIVATIONS[spec["layer"]](x)
        return {self.config.conditioning_type or DIM2CONDITIONING[x.dim()]: x}
