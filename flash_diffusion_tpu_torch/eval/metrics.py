"""Quality metrics of the PyTorch port: FID statistics and distance, CLIP score.

Port of ``flash_diffusion_tpu/eval/metrics.py``: ``FIDStats`` streams the
mean and covariance of feature batches in float64 on the host;
``frechet_distance`` is |μ1 − μ2|² + Tr(Σ1 + Σ2 − 2·(Σ2^½ Σ1 Σ2^½)^½) with
the symmetrized eigh square roots; ``clip_score`` is the mean of
max(0, cos(image, text))·100 over matched pairs; ``clip_preprocess`` maps
[-1, 1] NHWC images to CLIP's normalized 224² input. Its resize is
``jax.image.resize(..., "bilinear")``'s, which antialiases when it shrinks
(``models/depth.py resize_like_jax``): a plain ``F.interpolate`` of a 512²
image to 224² samples it and gives other features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.depth import resize_like_jax


@dataclasses.dataclass
class FIDStats:
    """Streaming mean/covariance accumulator over feature batches (float64)."""

    n: int = 0
    sum: Optional[np.ndarray] = None
    outer: Optional[np.ndarray] = None

    def update(self, feats) -> "FIDStats":
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().double().numpy()
        feats = np.asarray(feats, np.float64)
        if self.sum is None:
            self.sum = np.zeros(feats.shape[-1])
            self.outer = np.zeros((feats.shape[-1], feats.shape[-1]))
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats
        return self

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (nearly) PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID = |μ1−μ2|² + Tr(Σ1 + Σ2 − 2·(Σ2^½ Σ1 Σ2^½)^½), in float64."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    s2 = _sqrtm_psd(cov2)
    cross = _sqrtm_psd(s2 @ cov1 @ s2)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(cross))


def fid_from_features(real_feats, fake_feats) -> float:
    mu1, cov1 = FIDStats().update(real_feats).finalize()
    mu2, cov2 = FIDStats().update(fake_feats).finalize()
    return frechet_distance(mu1, cov1, mu2, cov2)


def clip_score(image_embeds: torch.Tensor, text_embeds: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """Mean max(0, cos(img, text))·scale over matched pairs, in fp32."""
    img, txt = image_embeds.float(), text_embeds.float().to(image_embeds.device)
    img = img / (img.norm(dim=-1, keepdim=True) + 1e-8)
    txt = txt / (txt.norm(dim=-1, keepdim=True) + 1e-8)
    return (img * txt).sum(-1).clamp(min=0.0).mean() * scale


# CLIP preprocessing constants (for images in [-1, 1] NHWC)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC → CLIP-normalized fp32 NHWC at ``size``², resized as
    ``jax.image.resize`` (antialiased when it shrinks)."""
    x = (torch.as_tensor(images).float() + 1.0) / 2.0
    if tuple(x.shape[1:3]) != (size, size):
        x = resize_like_jax(x.permute(0, 3, 1, 2), (size, size)).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
