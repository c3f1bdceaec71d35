"""Ops of the PyTorch port: attention, normalization and the int8 GEMM with their kernels."""

from .attention import dot_product_attention, flash_attention_bhsd, flash_attention_packed
from .gemm import int8_gemm
from .norms import group_norm, layer_norm, modulate

__all__ = [
    "dot_product_attention",
    "flash_attention_bhsd",
    "flash_attention_packed",
    "group_norm",
    "int8_gemm",
    "layer_norm",
    "modulate",
]
