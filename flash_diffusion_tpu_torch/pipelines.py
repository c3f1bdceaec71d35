"""FlashPipeline of the PyTorch port: few-step text → image.

Port of ``flash_diffusion_tpu/pipelines.py::FlashPipeline``: host-side
tokenization → conditioner → K-step sampling (LCM by default; the
scheduler is picked by name from ``schedulers.REGISTRY``, SD3's is the
Flash flow-match one) → VAE decode, returning images in [-1, 1], NHWC,
fp32. The stochastic schedulers (LCM, Flash flow-match, DDPM, Euler
ancestral) take fresh
noise at every step but the last, which returns the denoised sample. The
published 4-NFE setting is the default: 4 steps, guidance 0 (no CFG
doubling). Randomness comes from explicit
``torch.Generator``s: one seeded by a scalar ``seed``, or one per sample for
a sequence of seeds (then sample j's latent and step noise depend on
``seed[j]`` alone, whatever its slot or the batch size); tests inject
``latents`` and the per-step ``noise`` instead. The stages run in
``record_function`` spans (``fdt.encode``, ``fdt.denoise``, ``fdt.decode``)
that ``profiling.py`` and ``trace_top.py`` read. ``size_cond_fn`` (SDXL)
adds the size conditions of a batch of prompts to the conditioner's
inputs, for the negative prompts too; ``decode_chunk`` decodes the batch
in serial chunks. ``generate`` also takes a pre-tokenized batch: a dict of
the conditioners' inputs (token ids, masks, vectors), used as it is.

LoRA and quantization (``pipelines.py:66-129``, ``:165-172``): the UNet's
float weights stay resident as ``base_state``; ``load_lora``,
``set_adapter_scale`` and ``unload_lora`` rebuild the served weights
(``state``) by merging every adapter at full precision
(``lora.merge_lora``), then, in int8 mode (``quantize("int8")``),
quantizing the merged weights (``quant.quantize_dense``). A rebuild is
computed aside and swapped in whole under a lock that ``generate`` holds
for its whole call: a generate in flight (the serving batcher's thread)
finishes with the weights it started with, and none ever sees a half-merged
or half-quantized set.

Tensor-parallel serving (``shard_tp``, JAX ``pipelines.py:131-162``): each
rank of a ``torch.distributed`` group keeps its Megatron shard of the
denoiser's (and by default the text towers') attention and feed-forward
weights (``parallel/tp.py``); the VAE stays whole. ``base_state`` becomes
the rank's shard, and a rebuild merges each adapter's matching part
(``parallel/tp.py shard_lora``) at full precision into it, so that a rank
holds its shard of the merged set; int8 quantizes the shards, a
row-parallel weight with the group's per-channel amax. Every rank must
call ``generate``, ``load_lora``, ``quantize`` … in the same order with
the same arguments (``serving.TPChannel`` sees to it when serving); a
follower may skip the decode (``decode=False``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from .lora import LoraTree, load_peft_safetensors, merge_lora
from .parallel.tp import shard_lora
from .quant import apply_weights, quantize_dense
from .schedulers import REGISTRY, SchedulerConfig
from .schedulers import step_noise as draw_step_noise

# the schedulers whose step re-noises (JAX ``pipelines.py:210-215``)
STOCHASTIC = ("LCMScheduler", "FlashFlowMatchEulerDiscreteScheduler", "DDPMScheduler",
              "EulerAncestralDiscreteScheduler")


class FlashPipeline:
    """Few-step text-to-image pipeline.

    Args:
      denoiser: ``UNet2DCondition``, ``DiT`` or ``MMDiT`` (NHWC in, fp32
        NHWC out); its device is where latents and noise are drawn.
      conditioner: ``ConditionerWrapper``; every conditioning it returns
        (``crossattn``, ``vector``, Pixart's ``attention_mask``) reaches
        the denoiser.
      vae: ``AutoencoderKL`` (``decode_latents``).
      tokenizer_fn: callable(list[str]) -> dict of id arrays (host-side).
      latent_shape: (H, W, C) latent dims of the default resolution.
      scheduler_config: the schedule's ``SchedulerConfig`` (default: the
        SD family's scaled-linear betas; Pixart's are linear, SD3's shift 3).
      scheduler: the sampling scheduler's name in ``schedulers.REGISTRY``
        (default the published LCM setting; SD3:
        ``FlashFlowMatchEulerDiscreteScheduler``).

    Attributes: ``size_cond_fn``: None, or callable(n, height_px, width_px)
    -> dict of [n, k] arrays that ``generate`` adds to the conditioner's
    inputs (SDXL's original size, crop and target size).
    ``decode_chunk``: None, or decode in serial chunks of this many images
    when it divides the batch. ``lora_loader``: None, or callable(path) ->
    (LoRA tree, scaling), the serving ``/loras`` loader.
    """

    def __init__(
        self,
        denoiser,
        conditioner,
        vae,
        tokenizer_fn: Callable[[List[str]], Dict[str, np.ndarray]],
        latent_shape: Tuple[int, int, int] = (64, 64, 4),
        vae_scale_factor: int = 8,
        scheduler_config: Optional[SchedulerConfig] = None,
        scheduler: str = "LCMScheduler",
    ):
        self.denoiser = denoiser
        self.scheduler_name = scheduler
        self.sched_mod = REGISTRY[scheduler]
        self.conditioner = conditioner
        self.vae = vae
        self.tokenizer_fn = tokenizer_fn
        self.sched_config = scheduler_config or SchedulerConfig()
        self.latent_shape = tuple(latent_shape)
        self.vae_scale_factor = vae_scale_factor
        self.size_cond_fn = None
        self.decode_chunk: Optional[int] = None
        self.lora_loader: Optional[Callable[[str], Tuple[LoraTree, float]]] = None
        self.device = next(denoiser.parameters()).device
        self.base_state: Dict[str, torch.Tensor] = dict(denoiser.state_dict())
        self.state = self.base_state  # the weights the denoiser serves
        self._adapters: Dict[str, Tuple[LoraTree, float]] = {}
        self._quant: Tuple[Optional[str], int] = (None, 256)  # (mode, min_dim)
        self._weights_lock = threading.Lock()  # held by generate; a swap waits for it
        self._refresh_lock = threading.Lock()  # one rebuild at a time
        self._tp = None  # (group, plan, rank, world size) once shard_tp ran

    # -- LoRA and quantization --------------------------------------------
    @property
    def adapters(self) -> Dict[str, float]:
        """Loaded adapter names → scaling."""
        return {n: s for n, (_, s) in self._adapters.items()}

    def load_lora(self, lora: LoraTree, scaling: float = 1.0, name: str = "default"):
        """Add (or replace) an adapter, e.g. from ``lora.load_peft_safetensors``,
        and serve the base weights with every adapter merged."""
        lora = {k: {n: t.to(self.device) for n, t in ab.items()} for k, ab in lora.items()}
        self._refresh(lambda a: {**a, name: (lora, scaling)})

    def set_adapter_scale(self, name: str, scaling: float):
        self._refresh(lambda a: {**a, name: (a[name][0], scaling)})

    def unload_lora(self, name: str = "default"):
        self._refresh(lambda a: {k: v for k, v in a.items() if k != name})

    def load_lora_file(self, path: str, scale: float = 1.0, name: str = "default"):
        """``load_lora`` of an adapter file read by ``lora_loader`` (PEFT
        safetensors by default), at its own scaling times ``scale``."""
        tree, scaling = (self.lora_loader or load_peft_safetensors)(path)
        self.load_lora(tree, scaling * scale, name)

    def shard_tp(self, group=None, shard_conditioners: bool = True):
        """Tensor-parallel placement over ``group`` (the default group when
        None): the denoiser's, and with ``shard_conditioners`` the text
        towers', attention and feed-forward weights keep this rank's
        Megatron shard (``parallel/tp.py shard_params_tp``; raises when a
        head count or width does not divide), the VAE stays whole, and the
        served weights are rebuilt from the sharded base with the current
        adapters and quantization. Every rank of the group calls it."""
        from .parallel import rank, shard_params_tp, world_size

        with self._refresh_lock:
            with self._weights_lock:
                apply_weights(self.denoiser, self.base_state)  # the float base back in the modules
                plan = shard_params_tp(self.denoiser, group)
                if shard_conditioners and self.conditioner is not None:
                    shard_params_tp(self.conditioner, group)
                self.base_state = dict(self.denoiser.state_dict())
                self.state = self.base_state
                self._tp = (group, plan, rank(group), world_size(group))
        self._refresh(lambda a: a)

    def quantize(self, mode: str = "int8", min_dim: int = 256):
        """W8A8 int8 serving mode (``quant.py``), or back to float with
        ``"none"``. Adapters merge at full precision first; the merged
        weights are re-quantized on every adapter change."""
        if mode not in ("int8", "none"):
            raise ValueError(mode)
        self._refresh(lambda a: a, (None if mode == "none" else mode, min_dim))

    def _refresh(self, update, quant: Optional[Tuple[Optional[str], int]] = None):
        """Build the served weights from ``base_state``, the adapters that
        ``update`` makes of the current ones and the quantization settings
        (``quant``, or the current ones), then swap them in. Nothing changes
        if the build raises (an unknown adapter, a LoRA layer the UNet
        lacks, int8 matching no layer)."""
        with self._refresh_lock:
            adapters = update(self._adapters)
            mode, min_dim = quant or self._quant
            state = self.base_state
            for lora, scaling in adapters.values():
                if self._tp is not None:  # the rank's part of each pair, merged into its shard
                    lora = shard_lora(lora, self._tp[1], self._tp[2], self._tp[3])
                state = merge_lora(state, lora, scaling)
            if mode == "int8":
                state, n = quantize_dense(state, min_dim=min_dim, tp=self._quant_tp())
                if n == 0:
                    raise ValueError("int8 quantization matched no dense layer")
            with self._weights_lock:
                apply_weights(self.denoiser, state)
                self.state, self._adapters, self._quant = state, adapters, (mode, min_dim)

    def _quant_tp(self):
        """``quantize_dense``'s ``tp`` for the sharded state: {layer: (split
        dim, world size, the group of a row-parallel layer)}, or None."""
        if self._tp is None:
            return None
        group, plan, _, n = self._tp
        group = group if group is not None else dist.group.WORLD
        return {name: (0, n, None) if s.kind == "column" else (1, n, group)
                for name, s in plan.items() if s.kind != "table"}

    # -- generation ---------------------------------------------------------
    def _embed(self, batch_inputs, ucg_keys=None):
        return self.conditioner(batch_inputs, ucg_keys=ucg_keys, set_ucg_rate_zero=True)

    def _latent_shape(self, height: Optional[int], width: Optional[int]) -> Tuple[int, int, int]:
        if (height is None) != (width is None):
            raise ValueError("pass both height and width, or neither")
        if height is None:
            return self.latent_shape
        f = self.vae_scale_factor
        align = 8 * f
        if height <= 0 or width <= 0 or height % align or width % align:
            raise ValueError(f"height/width must be positive multiples of {align}")
        return (height // f, width // f, self.latent_shape[-1])

    def encode_prompts(self, prompts: Sequence[str], height: Optional[int] = None,
                       width: Optional[int] = None) -> Dict[str, Any]:
        """The pre-tokenized batch that ``generate`` makes of ``prompts`` at
        that size (the token ids and, with ``size_cond_fn``, the size
        conditions): ``generate`` of it gives the images of ``prompts``."""
        lshape = self._latent_shape(height, width)
        batch_inputs = dict(self.tokenizer_fn(list(prompts)))
        if self.size_cond_fn is not None:
            f = self.vae_scale_factor
            batch_inputs.update(self.size_cond_fn(len(prompts), lshape[0] * f, lshape[1] * f))
        return batch_inputs

    def _decode(self, sample: torch.Tensor) -> torch.Tensor:
        dc, batch = self.decode_chunk, sample.shape[0]
        if dc and dc < batch and batch % dc == 0:  # temps scale with the chunk, not the batch
            return torch.cat([self.vae.decode_latents(c) for c in sample.split(dc)])
        return self.vae.decode_latents(sample)

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[str] | Dict[str, Any],
        num_inference_steps: int = 4,
        guidance_scale: float = 0.0,
        negative_prompts: Optional[Sequence[str]] = None,
        seed: int | Sequence[int] = 0,
        latents: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        decode: bool = True,
    ) -> torch.Tensor:
        """Images in [-1, 1], NHWC fp32 (the final latents with
        ``decode=False``).

        ``prompts`` is a list of strings, tokenized by ``tokenizer_fn``, or
        a pre-tokenized batch: a dict of the conditioners' inputs (token
        ids, masks, vectors; arrays, tensors or lists), whose batch is the
        length of its first list or tensor value. A dict is used as it is:
        ``size_cond_fn`` is not applied to it (the caller gives the size
        conditions), and the unconditional branch of guidance zeroes its
        conditioners (``ucg_keys``), as in JAX. ``seed`` is one seed, or
        one per sample. ``latents`` ([B, H, W, C])
        and ``noise`` (one [B, H, W, C] tensor per step) replace the draws.
        ``height``/``width`` (pixels, both or neither, multiples of
        8·vae_scale_factor) override the default resolution.

        Batch invariance, the port's contract. With per-sample seeds a
        sample's latent, its step noise and every op of the port's own
        (the GroupNorm, LayerNorm, attention, int8 GEMM and feed-forward
        GEMM kernels, the per-token int8 codes, the scheduler) give it the
        same bits at any batch size or slot. cuDNN's convolutions and
        cuBLAS's bf16 GEMMs
        pick their algorithms by batch size and so sum in another order:
        on an H100 (SDXL at 128², one request alone against slot 1 of a
        batch of 4) single ops differ by up to 3.6e-5 (convolutions: the
        UNet's ``conv_in``, the VAE decoder's ``conv_in`` and its
        128-channel convolutions at full resolution) and 2.1e-4 rel. L2
        (240 of 2804 bf16 projections), and the images by 9.2e-3 rel. L2
        in bf16 and 9.8e-3 in int8 (where 12.8% of the activation codes
        of step 1 flip under it), against 1.3 for another seed. The card's
        tests hold images to 1.5e-2."""
        with self._weights_lock:
            return self._generate(prompts, num_inference_steps, guidance_scale, negative_prompts,
                                  seed, latents, noise, height, width, decode)

    def _generate(self, prompts, num_inference_steps, guidance_scale, negative_prompts, seed,
                  latents, noise, height, width, decode=True):
        if isinstance(prompts, dict):  # pre-tokenized (JAX pipelines.py:295-300)
            batch_inputs = dict(prompts)
            batch = next(len(v) if isinstance(v, (list, tuple)) else v.shape[0]
                         for v in prompts.values() if isinstance(v, (list, tuple)) or hasattr(v, "shape"))
        else:
            batch_inputs = self.encode_prompts(prompts, height, width)
            batch = len(prompts)
        lshape = self._latent_shape(height, width)
        h_px, w_px = lshape[0] * self.vae_scale_factor, lshape[1] * self.vae_scale_factor

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

        if isinstance(seed, (list, tuple, np.ndarray)):
            if len(seed) != batch:
                raise ValueError(f"got {len(seed)} seeds for batch {batch}")
            generator = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seed]
            if latents is None:  # each sample's latent first, then its step noise
                latents = torch.stack([torch.randn(lshape, generator=g, device=self.device)
                                       for g in generator])
        else:
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
            if latents is None:
                latents = torch.randn((batch, *lshape), generator=generator, device=self.device)
        mod = self.sched_mod
        stochastic = self.scheduler_name in STOCHASTIC
        sched = mod.set_timesteps(self.sched_config, num_inference_steps)
        sample = latents.to(self.device, torch.float32) * sched.init_noise_sigma

        with record_function("fdt.denoise"):
            for i, t in enumerate(sched.timesteps):
                inp = mod.scale_model_input(sched, sample, i)
                if do_cfg:
                    t2 = torch.full((2 * batch,), t, device=self.device)
                    pc, pu = self.denoiser(torch.cat([inp, inp]), t2, cond).chunk(2)
                    pred = guidance_scale * pc + (1.0 - guidance_scale) * pu
                else:
                    pred = self.denoiser(inp, torch.full((batch,), t, device=self.device), cond)
                if not stochastic or i == sched.num_inference_steps - 1:
                    step_noise = None  # the final step returns the denoised sample
                elif noise is not None:
                    step_noise = noise[i].to(self.device)
                else:
                    step_noise = draw_step_noise(sample, generator)
                sample = mod.step(sched, pred, i, sample, noise=step_noise)

        if not decode:
            return sample
        with record_function("fdt.decode"):
            return self._decode(sample)
