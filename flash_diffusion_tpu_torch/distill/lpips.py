"""LPIPS perceptual distance on a VGG16 trunk.

Port of ``flash_diffusion_tpu/distill/lpips.py:18-72``: the VGG16 feature
stages (features tapped after each stage's last ReLU, before pooling), unit
channel-normalized, squared differences calibrated by 1×1 ``lin_{i}`` convs
and averaged spatially, summed over the five taps. NHWC inputs in [-1, 1].
Weights are random (from the caller's seed) until the pretrained VGG/LPIPS
weights are in the repository. Computes in its parameters' dtype.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

# (channels, convs) per stage
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# ImageNet normalization for [-1, 1] inputs (the lpips ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        ch = in_channels
        for si, (out, n) in enumerate(_VGG_STAGES):
            for ci in range(n):
                setattr(self, f"conv{si}_{ci}", nn.Conv2d(ch, out, 3, padding=1))
                ch = out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, 3, H, W] → the five taps, channel-first."""
        feats = []
        for si, (_, n) in enumerate(_VGG_STAGES):
            for ci in range(n):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            feats.append(x)
            if si < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    """lpips(a, b) → [B]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_STAGES):
            setattr(self, f"lin_{i}", nn.Conv2d(ch, 1, 1, bias=False))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.shape[1] < 16 or a.shape[2] < 16:
            raise ValueError(
                f"LPIPS input {a.shape[1]}x{a.shape[2]} too small: VGG16's four max-pools "
                f"need >= 16x16 (empty feature maps yield NaN)")
        dtype = self.lin_0.weight.dtype
        shift = torch.tensor(_SHIFT, device=a.device, dtype=dtype)
        scale = torch.tensor(_SCALE, device=a.device, dtype=dtype)
        norm = lambda x: ((x.to(dtype) - shift) / scale).permute(0, 3, 1, 2)
        total = 0.0
        for i, (fa, fb) in enumerate(zip(self.vgg(norm(a)), self.vgg(norm(b)))):
            na = fa / (torch.linalg.vector_norm(fa, dim=1, keepdim=True) + 1e-10)
            nb = fb / (torch.linalg.vector_norm(fb, dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin_{i}")(torch.square(na - nb)).mean(dim=(1, 2, 3))
        return total
