"""Sample filters of the streaming pipeline: predicates over sample dicts.

Port of ``flash_diffusion_tpu/data/filters.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Any, Callable, Dict, List, Optional

from ..config import BaseConfig


@dataclasses.dataclass
class BaseFilterConfig(BaseConfig):
    verbose: bool = False


class BaseFilter:
    def __init__(self, config: Optional[BaseFilterConfig] = None):
        self.config = config or BaseFilterConfig()

    def __call__(self, sample: Dict[str, Any]) -> bool:
        raise NotImplementedError


@dataclasses.dataclass
class KeyFilterConfig(BaseFilterConfig):
    keys: List[str] = field(default_factory=lambda: ["jpg", "txt"])


class KeyFilter(BaseFilter):
    """Keep the samples that have all the configured keys."""

    def __init__(self, config: KeyFilterConfig):
        super().__init__(config)
        self.keys = set(config.keys)

    def __call__(self, sample):
        return self.keys.issubset(sample.keys())


@dataclasses.dataclass
class FilterOnConditionConfig(BaseFilterConfig):
    condition_key: str = "aesthetic_score"
    strict: bool = True  # a sample without the key: dropped (True) or kept


class FilterOnCondition(BaseFilter):
    """Keep the samples where ``predicate(sample[condition_key])`` holds."""

    def __init__(self, config: FilterOnConditionConfig, predicate: Callable[[Any], bool]):
        super().__init__(config)
        self.predicate = predicate

    def __call__(self, sample):
        key = self.config.condition_key
        if key not in sample:
            return not self.config.strict
        return bool(self.predicate(sample[key]))


class FilterWrapper:
    """The AND of filters."""

    def __init__(self, filters):
        self.filters = list(filters)

    def __call__(self, sample):
        return all(f(sample) for f in self.filters)
