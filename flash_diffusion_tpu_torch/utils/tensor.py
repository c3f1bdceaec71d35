"""Tensor helpers of the PyTorch port.

Port of ``flash_diffusion_tpu/utils/tensor.py``: the gather-and-broadcast
of per-timestep coefficients, trailing-dim expansion and padding up to a
multiple, with JAX's default axes (the last two: H and W of NCHW, W and C
of NHWC).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def extract_into_tensor(arr: torch.Tensor, indices: torch.Tensor, broadcast_ndim: int) -> torch.Tensor:
    """``arr[indices]`` (a 1-D table, e.g. ``sqrt_alphas_cumprod`` [T], at
    integer indices [B]) as [B, 1, ..., 1] of rank ``broadcast_ndim``."""
    return append_dims(arr.index_select(0, indices.long().reshape(-1)), broadcast_ndim)


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append singleton trailing dims until ``x.dim() == target_ndim``."""
    dims_to_append = target_ndim - x.dim()
    if dims_to_append < 0:
        raise ValueError(f"x.ndim={x.dim()} already exceeds target {target_ndim}")
    return x.reshape(*x.shape, *(1,) * dims_to_append)


def pad_to_multiple(x: torch.Tensor, multiple: int, axes: Sequence[int] = (-2, -1),
                    mode: str = "constant") -> Tuple[torch.Tensor, torch.Size]:
    """Pad ``axes`` of ``x`` at their high end up to the next multiple of
    ``multiple``; returns (padded, original shape) so that a caller can
    crop back. ``mode`` as ``F.pad``'s (``"constant"`` pads zeros)."""
    axes = sorted({a % x.dim() for a in axes})
    pad = [0] * (2 * x.dim())  # F.pad's order: the last axis first, (low, high) each
    for a in axes:
        pad[2 * (x.dim() - 1 - a) + 1] = -x.shape[a] % multiple
    while pad and pad[-2:] == [0, 0]:  # F.pad takes the trailing axes' pairs only
        del pad[-2:]
    if not pad:
        return x, x.shape
    return F.pad(x, pad, mode=mode), x.shape
