"""Serializable dataclass configs with json/yaml round-trip.

Same contract as ``flash_diffusion_tpu/config.py``: every component owns a
sibling ``*Config``; configs stamp their class name into a ``name`` entry on
save and warn (not fail) when a config is loaded into a differently-named
class. Built on the standard library's ``dataclasses`` so the port needs no
validation package; ``yaml`` is imported only by the yaml methods.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BaseConfig:
    """Base class for all configs. Subclasses are ``dataclasses.dataclass``es."""

    def __post_init__(self):
        self.name = self.__class__.__name__

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "BaseConfig":
        config_dict = dict(config_dict)
        name = config_dict.pop("name", None)
        if name is not None and name != cls.__name__:
            logger.warning("Loading config named %r into class %s", name, cls.__name__)
        return cls(**config_dict)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["name"] = self.__class__.__name__
        return out

    # --- json ---------------------------------------------------------
    @classmethod
    def from_json(cls, path: str) -> "BaseConfig":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save_json(self, path: str) -> str:
        if os.path.isdir(path):
            path = os.path.join(path, f"{self.__class__.__name__}.json")
        with open(path, "w") as f:
            f.write(self.to_json_string())
        return path

    # --- yaml ---------------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str) -> "BaseConfig":
        import yaml

        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))

    def save_yaml(self, path: str) -> str:
        import yaml

        if os.path.isdir(path):
            path = os.path.join(path, f"{self.__class__.__name__}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f)
        return path
