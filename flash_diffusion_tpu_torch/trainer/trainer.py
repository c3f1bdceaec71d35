"""Training pipeline of the port: the simultaneous Flash step, two optimizers.

Port of ``flash_diffusion_tpu/trainer/trainer.py`` (``__init__``, the
simultaneous branch of ``_build_step`` and ``fit``, ``trainer.py:85-99``,
``:163-245``, ``:404-491``):

- the frozen modules (teacher UNet, DiT or MMDiT, VAE, text conditioner,
  LPIPS) are stored in ``frozen_dtype`` (bf16); the denoiser and the VAE
  compute in it, as their JAX modules do (dtype=bf16); CLIP, T5 and LPIPS
  are fp32 flax modules in JAX that promote the bf16-stored weights at use,
  so here their weights are rounded through ``frozen_dtype`` and kept in
  fp32, the same numbers (SD3's CLIP-L, CLIP-G and T5-XXL inside its
  ``SD3Conditioner`` too; a param-less conditioner, Pixart's
  ``RawVectorEmbedder``, passes through). A parity trap: T5-XXL's weights are bf16-rounded in
  training but fp32 as loaded in sampling (``sample.build_pipeline``), so
  the two give different text states from one checkpoint;
- the LoRA factors, the discriminator and the optimizer state stay fp32
  (AdamW's first moment in ``adam_mu_dtype``);
- per step: the conditioning and the VAE encode are staged under
  ``no_grad`` (the JAX ``__conds``/``__z``), then one ``losses``, one
  backward of loss_G + loss_D, the generator and the discriminator updates.

The step runs eagerly; the stages are ``record_function`` spans
(``fdt.train.encode``/``.backward``/``.optimizer`` here, the loss stages in
``distill/flash.py``), read by ``profiling.py --train``. Not ported yet: EMA, gradient accumulation, the
alternating GAN mode, ``switch_teacher``, text-encoder offload, checkpoints,
loggers, validation.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..distill.losses import clip_disc_weights
from ..lora import LoraTree
from .training_config import TrainingConfig

logger = logging.getLogger(__name__)


class TrainingPipeline:
    """Drives a ``FlashDiffusion``. ``fit`` feeds batches and steps."""

    def __init__(
        self,
        model,
        config: TrainingConfig,
        lora: LoraTree,
        frozen_dtype: Optional[torch.dtype] = torch.bfloat16,
        device=None,
    ):
        self.model, self.config = model, config
        self.device = torch.device(device) if device is not None else next(
            model.teacher_module.parameters()).device
        for m in (model.teacher_module, model.vae, model.conditioner, model.lpips):
            if m is not None:
                m.requires_grad_(False).eval()
        if frozen_dtype is not None:
            model.teacher_module.to(frozen_dtype)
            if model.vae is not None:
                model.vae.to(frozen_dtype)
            with torch.no_grad():  # fp32 modules over bf16-rounded weights
                for m in (model.conditioner, model.lpips):
                    for p in (m.parameters() if m is not None else ()):
                        p.copy_(p.to(frozen_dtype))
        self.lora = {name: {k: t.detach().to(self.device, torch.float32).requires_grad_()
                            for k, t in ab.items()} for name, ab in lora.items()}
        model.attach_lora(self.lora)
        lora_params = [t for ab in self.lora.values() for t in ab.values()]
        self.opt_g = config.build_optimizer(0, lora_params)
        disc = model.discriminator
        self.opt_d = None
        if disc is not None:
            disc.float().requires_grad_(True).train()
            self.opt_d = config.build_optimizer(1, list(disc.parameters()))
        self.is_wgan = model.config.gan_loss_type == "wgan"
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = torch.as_tensor(v, device=self.device)
                out[k] = v.float() if v.is_floating_point() else v.long()
            else:
                out[k] = v
        return out

    def stage_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch on the device with ``__conds`` and ``__z`` staged."""
        model = self.model
        batch = self._to_device(batch)
        with record_function("fdt.train.encode"), torch.no_grad():
            if model.conditioner is not None:
                batch["__conds"] = model._conditionings(batch, self.generator)
            if model.vae is not None:
                x = batch[model.config.input_key]
                vcfg = model.vae.config
                f = 2 ** (len(vcfg.block_out_channels) - 1)
                noise = torch.randn((x.shape[0], x.shape[1] // f, x.shape[2] // f, vcfg.latent_channels),
                                    generator=self.generator, device=self.device)
                batch["__z"] = model._encode(batch, noise)
        return batch

    def train_step(self, batch: Dict[str, Any], stage: int) -> Dict[str, Any]:
        """One simultaneous step on a staged batch: losses, one backward of
        loss_G + loss_D, both updates."""
        model = self.model
        draws = model.draw(self.generator, stage, batch["__z"])
        self.opt_g.zero_grad()
        if self.opt_d is not None:
            self.opt_d.zero_grad()
        total, aux = model.losses(batch, draws, stage)
        with record_function("fdt.train.backward"):
            total.backward()
        with record_function("fdt.train.optimizer"):
            self.opt_g.step()
            if self.opt_d is not None:
                self.opt_d.step()
                if self.is_wgan:
                    clip_disc_weights(model.discriminator, self.config.wgan_clip)
        self.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}

    def fit(self, data: Iterable[Dict[str, Any]], max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Train on ``data`` (dicts with ``image`` [B, H, W, 3] in [-1, 1] and
        ``text_ids``) until ``max_steps``; returns the last step's aux."""
        cfg = self.config
        max_steps = max_steps or cfg.max_steps or sum(self.model.config.num_iterations_per_K)
        aux: Dict[str, Any] = {}
        t0 = time.perf_counter()
        batches = iter(data)
        while self.step < max_steps:
            batch = next(batches, None)
            if batch is None:
                break
            stage = self.model.stage_for_iteration(self.step + 1)
            aux = self.train_step(self.stage_batch(batch), stage)
            if self.step % cfg.log_every_n_steps == 0:
                metrics = {k: float(v) for k, v in aux.items()}
                logger.info("step %d stage %d %.3f s/step %s", self.step, stage,
                            (time.perf_counter() - t0) / cfg.log_every_n_steps, metrics)
                t0 = time.perf_counter()
        return aux
