"""Sample mappers: host-side transforms of the streaming pipeline.

Port of ``flash_diffusion_tpu/data/mappers.py:26-216``: key renaming
(with a condition and an else map), image transforms on PIL/numpy (NHWC
float outputs), [0, 1] → [-1, 1], JSON key extraction, key select, remove
and set. The Canny and depth mappers wait for the adapters.
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
