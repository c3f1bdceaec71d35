"""COCO-style FID / CLIP-FID / CLIPScore evaluation loop of the PyTorch port.

Port of ``flash_diffusion_tpu/eval/harness.py``: stream a captioned image
dataset (shards through ``data.DataPipeline``), generate few-step samples
for each caption batch with a ``FlashPipeline`` (seed ``seed + i`` for
batch i), embed the real and generated images with the CLIP vision tower
and/or InceptionV3-pool3, and report the Fréchet distances and CLIPScore.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterator, Optional

import torch

from ..models.inception import preprocess as inception_preprocess
from .metrics import FIDStats, clip_preprocess, clip_score, frechet_distance

logger = logging.getLogger(__name__)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def clip_embed_fn(vision_module: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """[-1, 1] NHWC images → the vision tower's fp32 ``image_embeds``."""
    dev = _device(vision_module)

    @torch.inference_mode()
    def embed(images):
        return vision_module(clip_preprocess(torch.as_tensor(images, device=dev)))["image_embeds"].float()

    return embed


def inception_embed_fn(inception_module: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """[-1, 1] NHWC images → fp32 pool3 features [B, 2048]."""
    dev = _device(inception_module)

    @torch.inference_mode()
    def embed(images):
        return inception_module(inception_preprocess(torch.as_tensor(images, device=dev))).float()

    return embed


def evaluate(
    pipeline,  # FlashPipeline
    data: Iterator[Dict],
    vision_module: Optional[torch.nn.Module] = None,
    text_embed_fn: Optional[Callable[[Dict], torch.Tensor]] = None,
    num_inference_steps: int = 4,
    guidance_scale: float = 0.0,
    max_batches: Optional[int] = None,
    seed: int = 0,
    inception_module: Optional[torch.nn.Module] = None,
) -> Dict[str, float]:
    """Returns {"fid", "clip_fid", "clip_score", "num_samples"}, each where
    its extractor was given.

    ``data`` yields batches with "image" ([-1, 1] NHWC) and "text" (the
    captions ``pipeline.generate`` is prompted with). ``text_embed_fn`` maps
    a batch to CLIP text embeds for CLIPScore (skipped when None).
    ``inception_module`` (``models.inception.load_inception_v3``, its
    ``fid_variant`` set for the pt_inception checkpoint) gives "fid"; the
    CLIP ``vision_module`` gives "clip_fid" and "clip_score". At least one
    extractor must be given."""
    if vision_module is None and inception_module is None:
        raise ValueError("provide vision_module (CLIP) and/or inception_module")
    embed = clip_embed_fn(vision_module) if vision_module is not None else None
    embed_incep = inception_embed_fn(inception_module) if inception_module is not None else None

    real_stats, fake_stats = FIDStats(), FIDStats()
    real_i, fake_i = FIDStats(), FIDStats()
    scores = []
    n = 0
    for i, batch in enumerate(data):
        if max_batches is not None and i >= max_batches:
            break
        images = batch["image"]
        count = images.shape[0]
        fake = pipeline.generate(
            list(batch.get("text", [])) or [""] * count,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            seed=seed + i,
        )
        if embed is not None:
            fake_emb = embed(fake)
            real_stats.update(embed(images))
            fake_stats.update(fake_emb)
            if text_embed_fn is not None:
                scores.append(float(clip_score(fake_emb, text_embed_fn(batch))))
        if embed_incep is not None:
            real_i.update(embed_incep(images))
            fake_i.update(embed_incep(fake))
        n += count
        if i % 10 == 0:
            logger.info("eval batch %d (%d samples)", i, n)

    out: Dict[str, float] = {"num_samples": n}
    if embed is not None:
        out["clip_fid"] = frechet_distance(*real_stats.finalize(), *fake_stats.finalize())
    if embed_incep is not None:
        out["fid"] = frechet_distance(*real_i.finalize(), *fake_i.finalize())
    if scores:
        out["clip_score"] = sum(scores) / len(scores)
    return out
