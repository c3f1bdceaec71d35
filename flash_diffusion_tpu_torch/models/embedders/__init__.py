"""Conditioners of the PyTorch port (CLIP text so far)."""

from .base import BaseConditionerConfig, Conditioner
from .text import ClipEmbedder, ClipEmbedderConfig
from .wrapper import KEY2CATDIM, ConditionerWrapper

__all__ = [
    "KEY2CATDIM",
    "BaseConditionerConfig",
    "ClipEmbedder",
    "ClipEmbedderConfig",
    "Conditioner",
    "ConditionerWrapper",
]
