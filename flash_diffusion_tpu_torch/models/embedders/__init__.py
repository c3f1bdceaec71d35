"""Conditioners of the PyTorch port: CLIP and T5 text, SDXL's size embeddings, raw vectors, SD3's packing."""

from .base import BaseConditionerConfig, Conditioner
from .misc import RawVectorEmbedder, RawVectorEmbedderConfig, TimestepsEmbedder, TimestepsEmbedderConfig
from .sd3 import SD3Conditioner, T5AsSD3Embedder
from .text import ClipEmbedder, ClipEmbedderConfig, T5TextEmbedder, T5TextEmbedderConfig
from .wrapper import KEY2CATDIM, ConditionerWrapper

__all__ = [
    "KEY2CATDIM",
    "BaseConditionerConfig",
    "ClipEmbedder",
    "ClipEmbedderConfig",
    "Conditioner",
    "ConditionerWrapper",
    "RawVectorEmbedder",
    "RawVectorEmbedderConfig",
    "SD3Conditioner",
    "T5AsSD3Embedder",
    "T5TextEmbedder",
    "T5TextEmbedderConfig",
    "TimestepsEmbedder",
    "TimestepsEmbedderConfig",
]
