"""Conditioners of the PyTorch port: CLIP text and SDXL's size embeddings."""

from .base import BaseConditionerConfig, Conditioner
from .misc import TimestepsEmbedder, TimestepsEmbedderConfig
from .text import ClipEmbedder, ClipEmbedderConfig
from .wrapper import KEY2CATDIM, ConditionerWrapper

__all__ = [
    "KEY2CATDIM",
    "BaseConditionerConfig",
    "ClipEmbedder",
    "ClipEmbedderConfig",
    "Conditioner",
    "ConditionerWrapper",
    "TimestepsEmbedder",
    "TimestepsEmbedderConfig",
]
