"""Sample, metric and checkpoint callbacks of ``TrainingPipeline.fit``.

Port of ``flash_diffusion_tpu/trainer/loggers.py:29-126``, ``:207-236``:
every N steps, few-step samples of the student (the EMA student when it is
tracked) and optionally of the teacher, as image grids ([-1, 1] → uint8,
4 a row) written to PNG files through the port's stdlib encoder
(``sample.png_bytes``), beside the input grid and the captions; scalar
metrics to the ``logging`` module; checkpoints through ``save_state``. A
callback is called as ``callback(pipeline, aux, step)`` after every step
(``step`` counts micro-steps from 1). ``QualityValidator``
(``loggers.py:128-200``): every N steps, few-step samples of held-out
batches against their images, the Fréchet distance of an embedding of both
and optionally CLIPScore. Not ported: wandb.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import save_state

logger = logging.getLogger(__name__)


def make_grid(images, nrow: int = 4) -> np.ndarray:
    """[-1, 1] NHWC float batch → one HWC uint8 grid, ``nrow`` images a row."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.clip((np.asarray(images) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    b, h, w, c = images.shape
    nrows = -(-b // nrow)
    pad = nrows * nrow - b
    if pad:
        images = np.concatenate([images, np.zeros((pad, h, w, c), np.uint8)])
    return images.reshape(nrows, nrow, h, w, c).transpose(0, 2, 1, 3, 4).reshape(nrows * h, nrow * w, c)


def save_png(path: str, array: np.ndarray) -> None:
    """An HWC uint8 RGB array as a PNG file (the directory made as needed)."""
    from ..sample import png_bytes

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(array)))


class SampleLogger:
    """Every ``every_n_steps``: ``model.log_samples`` of the conditioning
    batch ``batch_provider()`` gives (host arrays; ``text`` captions and an
    ``image`` input are written beside), under ``pipeline.sampling_frozen()``
    so that offloaded text towers are placed for the call, with a generator
    seeded by the step; the grids go to ``out_dir/step<step>/``. ``written``
    lists the files of the last call, ``nonfinite`` the names of its sample
    sets with a value that is not finite (logged as a warning)."""

    def __init__(
        self,
        batch_provider: Callable[[], Dict],
        input_shape: Sequence[int],  # latent (h, w, C)
        out_dir: str = "samples",
        every_n_steps: int = 200,
        num_steps=(1, 2, 4),
        guidance_scale: float = 1.0,
        log_teacher_samples: bool = False,
        teacher_guidance_scale: float = 5.0,
        use_ema: bool = True,
    ):
        self.batch_provider = batch_provider
        self.input_shape = tuple(input_shape)
        self.out_dir, self.every_n_steps = out_dir, every_n_steps
        self.num_steps, self.guidance_scale = num_steps, guidance_scale
        self.log_teacher_samples, self.teacher_guidance_scale = log_teacher_samples, teacher_guidance_scale
        self.use_ema = use_ema
        self.written: List[str] = []
        self.nonfinite: List[str] = []

    def __call__(self, pipeline, aux, step: int) -> None:
        if step % self.every_n_steps:
            return
        batch = self.batch_provider()
        lora = pipeline.ema if self.use_ema and pipeline.ema is not None else pipeline.lora
        step_dir = os.path.join(self.out_dir, f"step{step:08d}")
        self.written = []
        if hasattr(batch.get("image"), "shape"):
            path = os.path.join(step_dir, "inputs.png")
            save_png(path, make_grid(batch["image"]))
            self.written.append(path)
        texts = batch.get("text")
        if isinstance(texts, (list, tuple)) and texts:
            os.makedirs(step_dir, exist_ok=True)
            path = os.path.join(step_dir, "text.txt")
            with open(path, "w") as f:
                f.write("\n".join(str(t) for t in texts))
            self.written.append(path)
        cond_batch = {k: v for k, v in pipeline.to_device(batch).items()
                      if isinstance(v, torch.Tensor) and k != "image"}
        generator = torch.Generator(device=pipeline.device).manual_seed(step)
        with pipeline.sampling_frozen():
            logs = pipeline.model.log_samples(
                lora, cond_batch, self.input_shape, num_steps=self.num_steps, guidance_scale=self.guidance_scale,
                log_teacher_samples=self.log_teacher_samples, teacher_guidance_scale=self.teacher_guidance_scale,
                generator=generator)
        self.nonfinite = [name for name, images in logs.items() if not bool(torch.isfinite(images).all())]
        if self.nonfinite:
            logger.warning("step %d: samples with values that are not finite: %s", step, self.nonfinite)
        for name, images in logs.items():
            path = os.path.join(step_dir, name.replace("/", "_") + ".png")
            save_png(path, make_grid(images))
            self.written.append(path)
        logger.info("step %d: wrote %d sample grids to %s", step, len(logs), step_dir)


class QualityValidator:
    """Every ``every_n_steps``: for each of the first ``num_batches``
    batches of ``batch_provider()`` (held out, with "image" [-1, 1] NHWC),
    the student's (the EMA student's with ``use_ema``, where it is tracked)
    few-step samples from latents of ``input_shape`` drawn from a generator
    seeded by (step, i), and the Fréchet distance between ``embed_fn`` of
    the reals and of the samples (``val/feature_fd``), plus CLIPScore
    (``val/clip_score``) against ``text_embed_fn(batch)`` when given.
    ``embed_fn``: [-1, 1] NHWC images → [B, D] features (``eval.
    clip_embed_fn`` of the CLIP vision tower, ``eval.inception_embed_fn``,
    or any cheap feature net). Metrics go to the log and to ``history``
    [(step, {name: value})]."""

    def __init__(
        self,
        batch_provider: Callable[[], Iterator[Dict]],
        input_shape: Sequence[int],  # latent (h, w, C)
        embed_fn: Callable,
        every_n_steps: int = 1000,
        num_batches: int = 4,
        num_steps: int = 4,
        guidance_scale: float = 1.0,
        text_embed_fn: Optional[Callable] = None,
        use_ema: bool = True,
    ):
        self.batch_provider, self.input_shape, self.embed_fn = batch_provider, tuple(input_shape), embed_fn
        self.every_n_steps, self.num_batches = every_n_steps, num_batches
        self.num_steps, self.guidance_scale = num_steps, guidance_scale
        self.text_embed_fn, self.use_ema = text_embed_fn, use_ema
        self.history: List[Tuple[int, Dict[str, float]]] = []

    @staticmethod
    def seed(step: int, i: int) -> int:
        """The latents' seed of batch ``i`` at ``step``."""
        return int(np.random.SeedSequence([step, i]).generate_state(1)[0])

    def __call__(self, pipeline, aux, step: int) -> None:
        if step % self.every_n_steps:
            return
        from ..eval.metrics import FIDStats, clip_score, frechet_distance

        lora = pipeline.ema if self.use_ema and pipeline.ema is not None else pipeline.lora
        real_s, fake_s = FIDStats(), FIDStats()
        scores = []
        with pipeline.sampling_frozen():
            for i, batch in enumerate(self.batch_provider()):
                if i >= self.num_batches:
                    break
                n = batch["image"].shape[0]
                cond_batch = {k: v for k, v in pipeline.to_device(batch).items()
                              if isinstance(v, torch.Tensor) and k != "image"}
                z = torch.randn((n, *self.input_shape), device=pipeline.device,
                                generator=torch.Generator(device=pipeline.device).manual_seed(self.seed(step, i)))
                fake = pipeline.model.sample(
                    lora, z, cond_batch, num_steps=self.num_steps, guidance_scale=self.guidance_scale,
                    generator=torch.Generator(device=pipeline.device).manual_seed(i))
                real_emb, fake_emb = self.embed_fn(batch["image"]), self.embed_fn(fake)
                real_s.update(real_emb)
                fake_s.update(fake_emb)
                if self.text_embed_fn is not None:
                    scores.append(float(clip_score(fake_emb, self.text_embed_fn(batch))))
        metrics = {"val/feature_fd": frechet_distance(*real_s.finalize(), *fake_s.finalize())}
        if scores:
            metrics["val/clip_score"] = float(np.mean(scores))
        self.history.append((step, metrics))
        logger.info("step %d quality %s", step, metrics)


class MetricLogger:
    """Every ``every_n_steps``: the step's scalar metrics to the log and to
    ``history`` [(step, {name: value})]."""

    def __init__(self, every_n_steps: int = 50):
        self.every_n_steps = every_n_steps
        self.history: List[Tuple[int, Dict[str, float]]] = []

    def __call__(self, pipeline, aux, step: int) -> None:
        if step % self.every_n_steps:
            return
        scalars = {k: float(v) for k, v in aux.items() if np.ndim(v) == 0}
        self.history.append((step, scalars))
        logger.info("step %d %s", step, scalars)


class CheckpointCallback:
    """Every ``every_n_steps``: ``save_state`` of ``pipeline.state_dict()``
    under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, every_n_steps: int = 5000, keep: Optional[int] = None):
        self.directory, self.every_n_steps, self.keep = directory, every_n_steps, keep

    def __call__(self, pipeline, aux, step: int) -> None:
        if step % self.every_n_steps:
            return
        path = save_state(self.directory, step, pipeline.state_dict(), keep=self.keep)
        logger.info("step %d: checkpoint saved to %s", step, path)
