"""Conditioners of the PyTorch port: CLIP and T5 text, SDXL's size embeddings, raw vectors, config-built modules, SD3's packing."""

from .base import DIM2CONDITIONING, BaseConditionerConfig, Conditioner
from .misc import (
    ModuleEmbedder,
    ModuleEmbedderConfig,
    RawVectorEmbedder,
    RawVectorEmbedderConfig,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from .sd3 import SD3Conditioner, T5AsSD3Embedder
from .text import ClipEmbedder, ClipEmbedderConfig, T5TextEmbedder, T5TextEmbedderConfig
from .wrapper import KEY2CATDIM, ConditionerWrapper

__all__ = [
    "DIM2CONDITIONING",
    "KEY2CATDIM",
    "BaseConditionerConfig",
    "ClipEmbedder",
    "ClipEmbedderConfig",
    "Conditioner",
    "ConditionerWrapper",
    "ModuleEmbedder",
    "ModuleEmbedderConfig",
    "RawVectorEmbedder",
    "RawVectorEmbedderConfig",
    "SD3Conditioner",
    "T5AsSD3Embedder",
    "T5TextEmbedder",
    "T5TextEmbedderConfig",
    "TimestepsEmbedder",
    "TimestepsEmbedderConfig",
]
