"""Quality evaluation of the PyTorch port: FID, CLIP-FID and CLIPScore."""

from .harness import clip_embed_fn, evaluate, inception_embed_fn
from .metrics import (
    FIDStats,
    clip_preprocess,
    clip_score,
    fid_from_features,
    frechet_distance,
)

__all__ = [
    "FIDStats",
    "clip_embed_fn",
    "clip_preprocess",
    "clip_score",
    "evaluate",
    "fid_from_features",
    "frechet_distance",
    "inception_embed_fn",
]
