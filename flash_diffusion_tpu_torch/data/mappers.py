"""Sample mappers: host-side transforms of the streaming pipeline.

Port of ``flash_diffusion_tpu/data/mappers.py:26-313``: key renaming
(with a condition and an else map), image transforms on PIL/numpy (NHWC
float outputs), [0, 1] → [-1, 1], JSON key extraction, key select, remove
and set; the Canny edge map (numpy: 5×5 Gaussian, Sobel, non-maximum
suppression, hysteresis) and the depth map of an injected ``depth_fn``
(``models/depth.py make_depth_fn``), both as 3-channel [0, 1] images.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import BaseConfig


@dataclasses.dataclass
class BaseMapperConfig(BaseConfig):
    key: str = "image"


class BaseMapper:
    def __init__(self, config: Optional[BaseMapperConfig] = None):
        self.config = config

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class MapperWrapper:
    """Mappers applied in order."""

    def __init__(self, mappers):
        self.mappers = list(mappers)

    def __call__(self, sample):
        for m in self.mappers:
            sample = m(sample)
        return sample


@dataclasses.dataclass
class KeyRenameMapperConfig(BaseMapperConfig):
    key_map: Dict[str, str] = field(default_factory=dict)
    condition_key: Optional[str] = None
    condition_fn_key: Optional[str] = None  # unused, kept for the config surface
    else_key_map: Optional[Dict[str, str]] = None


class KeyRenameMapper(BaseMapper):
    """Rename keys; with a condition key, ``key_map`` when
    ``condition(sample[condition_key])`` holds, else ``else_key_map``."""

    def __init__(self, config: KeyRenameMapperConfig, condition: Optional[Callable] = None):
        super().__init__(config)
        self.condition = condition

    def __call__(self, sample):
        cfg = self.config
        key_map = cfg.key_map
        if cfg.condition_key is not None and self.condition is not None:
            if not self.condition(sample.get(cfg.condition_key)):
                key_map = cfg.else_key_map or {}
        out = dict(sample)
        for old, new in key_map.items():
            if old in out:
                out[new] = out.pop(old)
        return out


def _to_pil(x):
    from PIL import Image

    if isinstance(x, Image.Image):
        return x
    if isinstance(x, np.ndarray):
        return Image.fromarray(x)
    raise TypeError(type(x))


def center_crop(img, size: Tuple[int, int]):
    w, h = img.size
    tw, th = size[1], size[0]
    left, top = (w - tw) // 2, (h - th) // 2
    return img.crop((left, top, left + tw, top + th))


def _square(size):
    return size if isinstance(size, (list, tuple)) else (size, size)


_TRANSFORMS = {
    "Resize": lambda img, size, **kw: img.resize((_square(size)[1], _square(size)[0])),
    "CenterCrop": lambda img, size, **kw: center_crop(img, _square(size)),
    "RandomHorizontalFlip": lambda img, p=0.5, rng=None, **kw: (
        img.transpose(0) if (rng or np.random.default_rng()).random() < p else img),
    "ToTensor": lambda img, **kw: np.asarray(img, np.float32) / 255.0,  # HWC in [0, 1]
}


@dataclasses.dataclass
class ImageTransformMapperConfig(BaseMapperConfig):
    # [{"name": "Resize", "size": [512, 512]}, {"name": "CenterCrop", ...},
    #  {"name": "ToTensor"}]
    transforms: List[dict] = field(default_factory=list)
    output_key: Optional[str] = None
    seed: Optional[int] = None


class ImageTransformMapper(BaseMapper):
    def __init__(self, config: ImageTransformMapperConfig):
        super().__init__(config)
        self.rng = np.random.default_rng(config.seed)

    def __call__(self, sample):
        x = sample[self.config.key]
        for spec in self.config.transforms:
            spec = dict(spec)
            name = spec.pop("name")
            if name != "ToTensor" and not hasattr(x, "size"):
                x = _to_pil(x)
            x = _TRANSFORMS[name](x, rng=self.rng, **spec)
        out = dict(sample)
        out[self.config.output_key or self.config.key] = x
        return out


@dataclasses.dataclass
class RescaleMapperConfig(BaseMapperConfig):
    pass


class RescaleMapper(BaseMapper):
    """[0, 1] → [-1, 1]."""

    def __call__(self, sample):
        out = dict(sample)
        out[self.config.key] = np.asarray(out[self.config.key], np.float32) * 2.0 - 1.0
        return out


@dataclasses.dataclass
class KeysFromJSONMapperConfig(BaseMapperConfig):
    key: str = "json"
    keys_to_extract: List[str] = field(default_factory=list)
    remove_original: bool = False
    strict: bool = True


class KeysFromJSONMapper(BaseMapper):
    def __call__(self, sample):
        cfg = self.config
        out = dict(sample)
        payload = out[cfg.key]
        if isinstance(payload, (bytes, str)):
            payload = json.loads(payload)
        for k in cfg.keys_to_extract:
            if k in payload:
                out[k] = payload[k]
            elif cfg.strict:
                raise KeyError(f"{k} missing from json payload")
        if cfg.remove_original:
            out.pop(cfg.key, None)
        return out


@dataclasses.dataclass
class SelectKeysMapperConfig(BaseMapperConfig):
    keys: List[str] = field(default_factory=list)


class SelectKeysMapper(BaseMapper):
    def __call__(self, sample):
        return {k: sample[k] for k in self.config.keys if k in sample}


@dataclasses.dataclass
class RemoveKeysMapperConfig(BaseMapperConfig):
    keys: List[str] = field(default_factory=list)


class RemoveKeysMapper(BaseMapper):
    def __call__(self, sample):
        return {k: v for k, v in sample.items() if k not in self.config.keys}


@dataclasses.dataclass
class SetValueMapperConfig(BaseMapperConfig):
    key: str = "value"
    value: Any = None


class SetValueMapper(BaseMapper):
    def __call__(self, sample):
        out = dict(sample)
        out[self.config.key] = self.config.value
        return out


# --------------------------------------------------------------------------
@dataclasses.dataclass
class CannyEdgeMapperConfig(BaseMapperConfig):
    key: str = "image"
    output_key: str = "edge"
    low_threshold: float = 0.1
    high_threshold: float = 0.2


class CannyEdgeMapper(BaseMapper):
    """Canny edges of ``sample[key]`` (HWC or HW; values above 1.5 read as
    0–255) as a 3-channel {0, 1} float32 map under ``output_key``: grey
    (BT.601), 5×5 binomial blur, Sobel, magnitude over its max, non-maximum
    suppression in 4 directions, hysteresis between the two thresholds
    (8 growth rounds), as JAX's."""

    def __call__(self, sample):
        cfg = self.config
        img = np.asarray(sample[cfg.key], np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32) if img.ndim == 3 else img
        k = np.array([1, 4, 6, 4, 1], np.float32)
        g = _conv2(gray, np.outer(k, k) / 256.0)
        gx = _conv2(g, np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32))
        gy = _conv2(g, np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32))
        mag = np.hypot(gx, gy)
        mag = mag / (mag.max() + 1e-8)
        ang = np.rad2deg(np.arctan2(gy, gx)) % 180
        nms = _nms(mag, ang)
        strong = nms >= cfg.high_threshold
        weak = (nms >= cfg.low_threshold) & ~strong
        out = dict(sample)
        out[cfg.output_key] = np.repeat(_hysteresis(strong, weak)[..., None].astype(np.float32), 3, axis=-1)
        return out


def _conv2(x, k):
    """Correlation of a 2-D array with ``k``, edge-padded to its size."""
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    windows = np.lib.stride_tricks.sliding_window_view(np.pad(x, ((ph, ph), (pw, pw)), mode="edge"), k.shape)
    return np.einsum("ijkl,kl->ij", windows, k)


def _nms(mag, ang):
    """Non-maximum suppression along the gradient, its angle in 45° buckets
    (neighbours by wrap-around roll, as JAX's)."""
    out = np.zeros_like(mag)
    shifted = {
        0: (np.roll(mag, 1, 1), np.roll(mag, -1, 1)),
        45: (np.roll(np.roll(mag, 1, 0), -1, 1), np.roll(np.roll(mag, -1, 0), 1, 1)),
        90: (np.roll(mag, 1, 0), np.roll(mag, -1, 0)),
        135: (np.roll(np.roll(mag, 1, 0), 1, 1), np.roll(np.roll(mag, -1, 0), -1, 1)),
    }
    bucket = (np.round(ang / 45.0) % 4) * 45
    for b, (a, c) in shifted.items():
        m = bucket == b
        out[m] = np.where((mag[m] >= a[m]) & (mag[m] >= c[m]), mag[m], 0.0)
    return out


def _hysteresis(strong, weak, iters: int = 8):
    """Strong edges grown into 8-connected weak ones, ``iters`` rounds at most."""
    edges = strong.copy()
    for _ in range(iters):
        grown = edges.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                grown |= np.roll(np.roll(edges, dy, 0), dx, 1)
        new = grown & weak & ~edges
        if not new.any():
            break
        edges |= new
    return edges


@dataclasses.dataclass
class DepthMapperConfig(BaseMapperConfig):
    key: str = "image"
    output_key: str = "depth"


class DepthMapper(BaseMapper):
    """Depth conditioning: ``depth_fn(image HWC float32) → HW`` (e.g.
    ``models/depth.py make_depth_fn``, the DPT) repeated to 3 channels
    under ``output_key``."""

    def __init__(self, config: DepthMapperConfig, depth_fn: Callable[[np.ndarray], np.ndarray]):
        super().__init__(config)
        self.depth_fn = depth_fn

    def __call__(self, sample):
        out = dict(sample)
        d = self.depth_fn(np.asarray(sample[self.config.key], np.float32))
        out[self.config.output_key] = np.repeat(d[..., None], 3, axis=-1)
        return out
