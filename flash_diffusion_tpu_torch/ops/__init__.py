"""Ops of the PyTorch port: attention and normalization with their kernels."""

from .attention import dot_product_attention, flash_attention_bhsd, flash_attention_packed
from .norms import group_norm, layer_norm

__all__ = [
    "dot_product_attention",
    "flash_attention_bhsd",
    "flash_attention_packed",
    "group_norm",
    "layer_norm",
]
