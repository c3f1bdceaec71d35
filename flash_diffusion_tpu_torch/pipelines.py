"""FlashPipeline of the PyTorch port: few-step text → image.

Port of ``flash_diffusion_tpu/pipelines.py::FlashPipeline`` (``generate``):
host-side tokenization → conditioner → K-step LCM sampling → VAE decode,
returning images in [-1, 1], NHWC, fp32. The published 4-NFE setting is the
default: 4 steps, guidance 0 (no CFG doubling). Randomness comes from an
explicit ``torch.Generator`` seeded by ``seed``; tests inject ``latents``
and the per-step ``noise`` instead. The stages run in ``record_function`` spans
(``fdt.encode``, ``fdt.denoise``, ``fdt.decode``) that ``profiling.py``
reads. ``size_cond_fn`` (SDXL) adds the size conditions of a batch to the
conditioner's inputs, for the negative prompts too. Not ported yet: LoRA
loading, int8 quantization, tensor-parallel placement, ``decode_chunk``,
per-sample seeds and pre-tokenized batches as prompts.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .schedulers import SchedulerConfig, lcm
from .schedulers import step_noise as draw_step_noise


class FlashPipeline:
    """Few-step text-to-image pipeline with the LCM sampler.

    Args:
      denoiser: ``UNet2DCondition`` (NHWC in, fp32 NHWC out); its device is
        where latents and noise are drawn.
      conditioner: ``ConditionerWrapper``.
      vae: ``AutoencoderKL`` (``decode_latents``).
      tokenizer_fn: callable(list[str]) -> dict of id arrays (host-side).
      latent_shape: (H, W, C) latent dims of the default resolution.

    Attribute ``size_cond_fn``: None, or callable(n, height_px, width_px) ->
    dict of [n, k] arrays that ``generate`` adds to the conditioner's inputs
    (SDXL's original size, crop and target size).
    """

    def __init__(
        self,
        denoiser,
        conditioner,
        vae,
        tokenizer_fn: Callable[[List[str]], Dict[str, np.ndarray]],
        latent_shape: Tuple[int, int, int] = (64, 64, 4),
        vae_scale_factor: int = 8,
    ):
        self.denoiser = denoiser
        self.conditioner = conditioner
        self.vae = vae
        self.tokenizer_fn = tokenizer_fn
        self.sched_config = SchedulerConfig()
        self.latent_shape = tuple(latent_shape)
        self.vae_scale_factor = vae_scale_factor
        self.size_cond_fn = None
        self.device = next(denoiser.parameters()).device

    def _embed(self, batch_inputs, ucg_keys=None):
        return self.conditioner(batch_inputs, ucg_keys=ucg_keys, set_ucg_rate_zero=True)

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[str],
        num_inference_steps: int = 4,
        guidance_scale: float = 0.0,
        negative_prompts: Optional[Sequence[str]] = None,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
    ) -> torch.Tensor:
        """Images in [-1, 1], NHWC fp32.

        ``latents`` ([B, H, W, C]) and ``noise`` (one [B, H, W, C] tensor per
        step) replace the draws from ``seed``. ``height``/``width`` (pixels,
        both or neither, multiples of 8·vae_scale_factor) override the
        default resolution."""
        batch_inputs = dict(self.tokenizer_fn(list(prompts)))
        batch = len(prompts)
        if (height is None) != (width is None):
            raise ValueError("pass both height and width, or neither")
        lshape = self.latent_shape
        if height is not None:
            f = self.vae_scale_factor
            align = 8 * f
            if height <= 0 or width <= 0 or height % align or width % align:
                raise ValueError(f"height/width must be positive multiples of {align}")
            lshape = (height // f, width // f, self.latent_shape[-1])
        h_px, w_px = lshape[0] * self.vae_scale_factor, lshape[1] * self.vae_scale_factor
        if self.size_cond_fn is not None:
            batch_inputs.update(self.size_cond_fn(batch, h_px, w_px))

        do_cfg = guidance_scale not in (0.0, 1.0)
        with record_function("fdt.encode"):
            cond = self._embed(batch_inputs)
            if do_cfg:
                if negative_prompts is not None:
                    neg = dict(self.tokenizer_fn(list(negative_prompts)))
                    if self.size_cond_fn is not None:  # ucg drops text, not geometry
                        neg.update(self.size_cond_fn(len(negative_prompts), h_px, w_px))
                    uncond = self._embed(neg)
                else:  # every conditioner zeroed, the size embeddings included
                    uncond = self._embed(batch_inputs, ucg_keys=self.conditioner.input_keys())
                cond = {"cond": {
                    k: torch.cat([v, uncond["cond"][k]]) for k, v in cond["cond"].items()
                }}

        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        if latents is None:
            latents = torch.randn((batch, *lshape), generator=generator, device=self.device)
        sched = lcm.set_timesteps(self.sched_config, num_inference_steps)
        sample = latents.to(self.device, torch.float32) * sched.init_noise_sigma

        with record_function("fdt.denoise"):
            for i, t in enumerate(sched.timesteps):
                inp = lcm.scale_model_input(sched, sample, i)
                if do_cfg:
                    t2 = torch.full((2 * batch,), t, device=self.device)
                    pc, pu = self.denoiser(torch.cat([inp, inp]), t2, cond).chunk(2)
                    pred = guidance_scale * pc + (1.0 - guidance_scale) * pu
                else:
                    pred = self.denoiser(inp, torch.full((batch,), t, device=self.device), cond)
                if i == sched.num_inference_steps - 1:
                    step_noise = None  # the final step returns the denoised sample
                elif noise is not None:
                    step_noise = noise[i].to(self.device)
                else:
                    step_noise = draw_step_noise(sample, generator)
                sample = lcm.step(sched, pred, i, sample, noise=step_noise)

        with record_function("fdt.decode"):
            return self.vae.decode_latents(sample)
