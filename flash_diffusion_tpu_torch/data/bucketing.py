"""Aspect-ratio bucketed training data (port of ``flash_diffusion_tpu/data/bucketing.py``).

SDXL-style aspect bucketing: a ladder of (h, w) resolutions with h·w at
most base², each sample routed to the bucket nearest its aspect ratio and
batches formed per bucket, so that every batch has one shape. Dims stay
multiples of ``stride`` (64: the VAE's 8× and the UNet's 8× together).

- ``make_buckets``: the ladder, sorted by aspect, the square always in it.
- ``BucketAssignMapper``: a sample's bucket, its image cover-resized and
  cropped (center, or at a position from a numpy ``default_rng(seed)``, as
  JAX draws it) to the bucket, and the SDXL size tuples of the real
  geometry (``original_size_as_tuple`` from the file before a draft decode,
  ``crop_coords_top_left`` in the resized frame, ``target_size_as_tuple``)
  and ``__bucket__``.
- ``bucket_batches``: a ``__bucket__``-tagged sample stream grouped into
  batches of one bucket each (``DataPipeline.batches`` when
  ``aspect_bucketing`` is set); past ``max_pending`` waiting samples the
  fullest bucket is flushed, padded by repetition under ``drop_last``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .collation import custom_collation_fn
from .mappers import BaseMapper, BaseMapperConfig, _to_pil

logger = logging.getLogger(__name__)


def make_buckets(base_size: int = 1024, stride: int = 64, max_aspect: float = 2.0) -> List[Tuple[int, int]]:
    """(h, w) pairs, multiples of ``stride``, h·w ≤ base_size², aspect in
    [1/max_aspect, max_aspect], sorted by w/h; (base, base) always in."""
    if base_size % stride:
        raise ValueError(f"base_size {base_size} not divisible by stride {stride}")
    budget = base_size * base_size
    buckets = {(base_size, base_size)}
    w = stride
    while True:
        h = (budget // w) // stride * stride
        if h < stride:
            break
        if 1.0 / max_aspect <= w / h <= max_aspect:
            buckets.add((h, w))
            buckets.add((w, h))
        if w > base_size * max_aspect:
            break
        w += stride
    return sorted(buckets, key=lambda hw: hw[1] / hw[0])


def assign_bucket(buckets: Sequence[Tuple[int, int]], height: int, width: int) -> int:
    """The index of the bucket nearest in log-aspect (symmetric in h and w)."""
    a = math.log(width / height)
    return min(range(len(buckets)), key=lambda i: abs(math.log(buckets[i][1] / buckets[i][0]) - a))


@dataclasses.dataclass
class BucketAssignMapperConfig(BaseMapperConfig):
    buckets: Optional[List[Tuple[int, int]]] = None  # else the ladder of the next three
    base_size: int = 1024
    stride: int = 64
    max_aspect: float = 2.0
    crop: str = "center"  # center | random
    to_tensor: bool = True  # float32 [0, 1] HWC, else the PIL image
    emit_micro_conds: bool = True  # SDXL's original / crop / target size keys
    seed: Optional[int] = None


class BucketAssignMapper(BaseMapper):
    """A sample routed to its aspect bucket, its image cover-resized (both
    dims at least the bucket's) and cropped to the bucket, with
    ``__bucket__`` (the index) and, by default, the SDXL size tuples of the
    real geometry."""

    def __init__(self, config: BucketAssignMapperConfig):
        super().__init__(config)
        self.buckets = ([tuple(b) for b in config.buckets] if config.buckets
                        else make_buckets(config.base_size, config.stride, config.max_aspect))
        self.rng = np.random.default_rng(config.seed)

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        img = _to_pil(sample[cfg.key])
        w0, h0 = img.size  # after a draft decode
        oh, ow = img.info.get("original_size", (h0, w0))  # the file's, when the decoder kept it
        idx = assign_bucket(self.buckets, h0, w0)
        th, tw = self.buckets[idx]
        scale = max(th / h0, tw / w0)
        rw, rh = max(tw, round(w0 * scale)), max(th, round(h0 * scale))
        img = img.resize((rw, rh))
        if cfg.crop == "random":
            left = int(self.rng.integers(0, rw - tw + 1))
            top = int(self.rng.integers(0, rh - th + 1))
        else:
            left, top = (rw - tw) // 2, (rh - th) // 2
        img = img.crop((left, top, left + tw, top + th))
        out = dict(sample)
        out[cfg.key] = np.asarray(img, np.float32) / 255.0 if cfg.to_tensor else img
        out["__bucket__"] = idx
        if cfg.emit_micro_conds:
            out["original_size_as_tuple"] = np.asarray([oh, ow], np.float32)
            # (top, left) after the resize, before the crop: diffusers'
            # train_text_to_image_sdxl convention
            out["crop_coords_top_left"] = np.asarray([top, left], np.float32)
            out["target_size_as_tuple"] = np.asarray([th, tw], np.float32)
        return out


def bucket_batches(samples: Iterator[Dict[str, Any]], batch_size: int, drop_last: bool = True,
                   collate: Callable = custom_collation_fn, max_pending: int = 1024) -> Iterator[Dict[str, Any]]:
    """Batches of one bucket each from a ``__bucket__``-tagged stream: a
    bucket's batch goes out as soon as it holds ``batch_size`` samples.
    Past ``max_pending`` waiting samples the fullest bucket is flushed
    short, or under ``drop_last`` padded to ``batch_size`` by repeating its
    samples; at the end the partial buckets are flushed unless
    ``drop_last``."""
    pending: Dict[int, List[Dict[str, Any]]] = {}
    n_pending = 0
    for s in samples:
        if "__bucket__" not in s:
            raise ValueError("bucket_batches needs __bucket__-tagged samples: put a BucketAssignMapper in the "
                             "chain when aspect_bucketing is set")
        b = int(s.pop("__bucket__"))
        pending.setdefault(b, []).append(s)
        n_pending += 1
        if len(pending[b]) == batch_size:
            yield collate(pending.pop(b))
            n_pending -= batch_size
        elif n_pending >= max_pending:
            fullest = max(pending, key=lambda k: len(pending[k]))
            batch = pending.pop(fullest)
            n_pending -= len(batch)
            if drop_last:
                logger.warning("bucket backlog > %d: flushing bucket %d padded %d→%d", max_pending, fullest,
                               len(batch), batch_size)
                yield collate([batch[i % len(batch)] for i in range(batch_size)])
            else:
                yield collate(batch)
    if not drop_last:
        for batch in pending.values():
            if batch:
                yield collate(batch)
