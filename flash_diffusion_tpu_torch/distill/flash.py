"""FlashDiffusion — the distillation algorithm (ε-prediction family: SD1.5, SDXL, Pixart-α, T2I-Adapter).

Port of ``flash_diffusion_tpu/distill/flash.py:52-662`` (``losses`` and
its parts). One loss computation per step, as in JAX: the teacher's K-step
CFG rollout (cond and uncond folded into one 2B-batched forward per step)
from a host-side start index, the student's one-step prediction, the
distill loss (LPIPS through a checkpointed decode), DMD, and both GAN losses
from one shared computation, summed as loss_G + loss_D so that one backward
updates the LoRA factors and the discriminator (``distill/losses.py``).

The student is the teacher's modules plus the LoRA pairs
(``lora.shared_copy`` + ``lora.attach_lora``, built by ``attach_lora``
below), as JAX's ``_student_forward`` chooses (``flash.py:213-240``): with
``lora_mode="sidepath"`` (the default) a dense-only tree on the side path,
with no merged weights; with ``lora_mode="merge"``, or a tree with a conv
pair (a resnet convolution, say), on weights that read W + scaling·Δ(A, B)
at each use, JAX's merged-weights path. ``remat_student_merge`` then runs
the student's forward, the merges included, as one checkpointed segment
(JAX's ``jax.checkpoint(f)``), recomputed in the backward with its
forward's LoRA setting (``models/layers.py remat_call``). The teacher
rollout and the DMD forwards run under ``torch.no_grad()``.

Randomness: ``jax.random`` and ``torch.Generator`` never agree, so every
random draw of ``losses`` comes from one ``draws`` dict (``draw`` fills it
from a generator on the device; the tests fill it from JAX keys split as
``losses`` splits them):

- ``start_idx`` (host int), ``noise`` [B, h, w, C] and ``guidance`` (a
  uniform in [0, 1), scaled to the stage's guidance range);
- ``rollout_noise``: the DDPM posterior noise of each rollout step, in
  order from ``start_idx`` (none for a deterministic teacher: DPM);
- ``dmd_t`` [B], ``dmd_noise`` and ``dmd_guidance`` (uniform);
- ``gan_idx`` [B] (into ``gan_timesteps``) and ``gan_noise``.

The teacher is a UNet or a DiT: any denoiser ``(sample, t, conditioning,
return_features)`` whose conditioning dict (``crossattn``, ``vector``,
``attention_mask``, ``concat``) concatenates along the batch for the
2B-batched calls; the GAN's features are what ``return_features`` gives
(the UNet's mid block, the DiT's output latents).

Batch convention: ``image`` [B, H, W, 3] in [-1, 1] (NHWC, as JAX) and
``text_ids``; the pre-staged ``__z`` (the VAE encode) and ``__conds`` (the
three conditioner passes) entries are used when present, as in JAX.

Adapter (the Canny T2I-Adapter run): with an ``adapter`` module and
``config.adapter_input_key``, the frozen adapter runs without gradients on
``batch[adapter_input_key]`` (NHWC), each level's residual scaled by
``adapter_conditioning_scale``, and the residuals reach the student, the
teacher rollout, DMD's real and fake scores and the GAN's teacher pass; a
2B-batched call (CFG, the GAN's fake ⊕ real) gets them twice
(``distill/flash.py:261-289``, ``:335-403``).
``record_function`` spans (``fdt.train.*``) mark the stages.

Validation (``distill/flash.py:522-662``): ``sample`` runs the student (the
LoRA tree it is given, attached for the call: the EMA tree, say) or the
teacher, CFG as one 2B forward; the student's scheduler takes the
teacher's trailing timesteps and re-noises with injected noise (``noise``,
one tensor a step) or noise drawn from a generator, one draw a step as
JAX splits its key a step; the teacher samples deterministically with
``teacher_sampling_scheduler``, as JAX does (its step gets no key).
``log_samples`` draws the latents and samples 1, 2, 4 steps. For
``switch_teacher``, ``merge_lora_into_teacher`` merges the LoRA into the
teacher's weights in place, rounded back to their dtype, as JAX's
``_merged_teacher``; the student shares those weights, so after the switch
it is the merged teacher plus the same LoRA, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import BaseConfig
from ..lora import LoraTree, attach_lora, base_weight, lora_delta, lora_slot, shared_copy, uses_merge
from ..models.layers import remat_call
from ..schedulers import REGISTRY, SchedulerConfig, add_noise, training_tables
from .common import boundary_scalings, predicted_x0_eps, sample_start_index, stage_index, timestep_pdf
from .losses import center_crop, dmd_loss, gan_losses, huber_loss, l1_loss, l2_loss


@dataclasses.dataclass
class FlashDiffusionConfig(BaseConfig):
    """The JAX ``FlashDiffusionConfig`` fields that the training run reads;
    per-stage values broadcast from scalars."""

    input_key: str = "image"
    K: List[int] = field(default_factory=lambda: [32, 32, 32, 32])
    num_iterations_per_K: List[int] = field(default_factory=lambda: [5000] * 4)
    guidance_scale_min: Union[float, List[float]] = 3.0
    guidance_scale_max: Union[float, List[float]] = 7.0
    distill_loss_type: str = "l2"  # l2 | l1 | lpips | huber
    ucg_keys: List[str] = field(default_factory=lambda: ["text"])
    timestep_distribution: str = "mixture"  # gaussian | uniform | mixture
    mixture_num_components: Union[int, List[int]] = 4
    mixture_var: Union[float, List[float]] = 0.5
    adapter_conditioning_scale: float = 1.0
    adapter_input_key: Optional[str] = None
    use_dmd_loss: bool = False
    dmd_loss_scale: Union[float, List[float]] = 1.0
    distill_loss_scale: Union[float, List[float]] = 1.0
    adversarial_loss_scale: Union[float, List[float]] = 1.0
    gan_loss_type: str = "hinge"  # hinge | vanilla | non-saturating | wgan | lsgan
    mode_probs: Optional[List[List[float]]] = None
    use_teacher_as_real: bool = False
    use_empty_prompt: bool = False
    gan_timesteps: List[int] = field(default_factory=lambda: [10, 250, 500, 750])
    # "simultaneous": both updates each step from one backward;
    # "alternating": the generator on even steps, the discriminator on odd
    gan_update_mode: str = "simultaneous"
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    lpips_crop: int = 64
    # at a stage boundary where K changes, the teacher becomes the merged
    # student (the trainer does it between stages)
    switch_teacher: bool = False
    # "sidepath": a dense-only tree's pairs beside each layer's product;
    # "merge": the merged weights W + scaling·Δ (a conv pair forces them)
    lora_mode: str = "sidepath"
    # the merged student's forward as one checkpointed segment
    remat_student_merge: bool = False

    def __post_init__(self):
        super().__post_init__()
        n = len(self.K)
        bc = lambda v: [v] * n if isinstance(v, (int, float)) else list(v)
        self.guidance_scale_min = bc(self.guidance_scale_min)
        self.guidance_scale_max = bc(self.guidance_scale_max)
        self.mixture_num_components = bc(self.mixture_num_components)
        self.mixture_var = bc(self.mixture_var)
        self.distill_loss_scale = bc(self.distill_loss_scale)
        self.dmd_loss_scale = bc(self.dmd_loss_scale)
        self.adversarial_loss_scale = bc(self.adversarial_loss_scale)
        if self.mode_probs is None:
            self.mode_probs = [[1.0 / m] * m for m in self.mixture_num_components]
        if self.lora_mode not in ("sidepath", "merge"):
            raise ValueError(f"lora_mode {self.lora_mode!r}: sidepath or merge")
        if self.gan_update_mode not in ("simultaneous", "alternating"):
            raise ValueError(f"gan_update_mode {self.gan_update_mode!r}: simultaneous or alternating")
        if len(self.num_iterations_per_K) != n or len(self.mode_probs) != n:
            raise ValueError("num_iterations_per_K and mode_probs need one entry per stage")
        for i in range(n):
            if len(self.mode_probs[i]) != self.mixture_num_components[i]:
                raise ValueError(f"mode_probs[{i}] needs mixture_num_components[{i}] entries")


def _cat(a: Dict, b: Dict) -> Dict:
    return {"cond": {k: torch.cat([v, b["cond"][k]]) for k, v in a["cond"].items()}}


def _dup(res: Optional[List[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
    """Adapter residuals for a 2B-batched call."""
    return [torch.cat([r, r]) for r in res] if res else None


def _adapter_kw(res) -> Dict[str, Any]:
    """``adapter_residuals`` only when there are some: the DiT and the
    MMDiT take no such argument."""
    return {"adapter_residuals": res} if res else {}


class FlashDiffusion:
    """Holds the modules and the per-stage tables; ``losses`` is the step's
    loss computation. ``attach_lora`` makes the student."""

    def __init__(
        self,
        config: FlashDiffusionConfig,
        teacher_module,  # UNet2DCondition or DiT: (sample, t, cond, return_features)
        scheduler_config: Optional[SchedulerConfig] = None,
        teacher_scheduler: str = "DDPMScheduler",
        sampling_scheduler: str = "LCMScheduler",
        teacher_sampling_scheduler: str = "EulerDiscreteScheduler",
        vae=None,  # AutoencoderKL
        conditioner=None,  # ConditionerWrapper
        discriminator=None,  # ConvDiscriminator
        lpips=None,  # LPIPS
        lora_scaling: float = 1.0,
        adapter=None,  # T2IAdapter: NHWC control image → per-level residuals
    ):
        self.config = config
        self.adapter = adapter
        self.teacher_module = teacher_module
        self.student_module = None
        self.merged_student = False  # the student on merged weights (``attach_lora``)
        self.lora_scaling = lora_scaling
        self.vae, self.conditioner = vae, conditioner
        self.discriminator, self.lpips = discriminator, lpips
        self.use_adversarial_loss = discriminator is not None
        self.sched_config = scheduler_config or SchedulerConfig()
        self.teacher_sched_mod = REGISTRY[teacher_scheduler]
        self.sampling_sched_mod = REGISTRY[sampling_scheduler]
        self.teacher_sampling_sched_mod = REGISTRY[teacher_sampling_scheduler]
        self.sampling_scheduler_name = sampling_scheduler
        self._sched_stochastic = teacher_scheduler == "DDPMScheduler"
        self._sched_has_carry = hasattr(self.teacher_sched_mod, "init_state")
        acp, sqrt_acp, sqrt_1macp = training_tables(self.sched_config)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        self.alphas_cumprod, self.sqrt_acp, self.sqrt_1macp = f32(acp), f32(sqrt_acp), f32(sqrt_1macp)
        self.stage_schedules = [
            self.teacher_sched_mod.set_timesteps(self.sched_config, k) for k in config.K
        ]
        self.stage_pdfs = [
            timestep_pdf(config.timestep_distribution, config.K[s], config.mixture_num_components[s],
                         config.mixture_var[s], config.mode_probs[s])
            for s in range(len(config.K))
        ]

    def attach_lora(self, lora: LoraTree, module=None) -> None:
        """The student: ``module`` (by default a shared copy of the teacher's
        modules) with ``lora`` attached: a dense-only tree on the side path
        under ``lora_mode="sidepath"``, else merged weights W + scaling·Δ(A,
        B) (``lora.attach_lora``), as JAX's ``_student_forward`` chooses
        (``flash.py:213-240``)."""
        self.merged_student = uses_merge(lora, self.config.lora_mode == "merge")
        module = shared_copy(self.teacher_module) if module is None else module
        self.student_module = attach_lora(module, lora, self.lora_scaling, merge=self.merged_student)

    def stage_for_iteration(self, iter_step: int) -> int:
        return stage_index(iter_step, self.config.num_iterations_per_K)

    @torch.no_grad()
    def merge_lora_into_teacher(self, lora: LoraTree) -> None:
        """W ← W + scaling·(A·B)ᵀ on the teacher's targeted layers, in fp32,
        rounded back to W's dtype, in place (``switch_teacher``; JAX
        ``_merged_teacher``). The student shares the weights. A weight
        sharded by FSDP (a ``DTensor``) takes the delta's matching shards,
        as JAX re-shards the merged tree."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        for name, ab in lora.items():
            w = base_weight(self.teacher_module.get_submodule(name))
            delta = self.lora_scaling * lora_delta(ab["a"], ab["b"], w.shape)
            if isinstance(w, DTensor):
                delta = distribute_tensor(delta, w.device_mesh, w.placements)
            w.copy_((w.float() + delta).to(w.dtype))

    @contextlib.contextmanager
    def using_lora(self, lora: Optional[LoraTree]):
        """The student with ``lora``'s tensors in place of its pairs for the
        block (the EMA tree, say); the trained tree is back on exit."""
        prev = {}
        try:
            for name, ab in (lora or {}).items():
                slot = lora_slot(self.student_module, name)
                prev[name] = slot.lora
                slot.lora = (ab["a"], ab["b"], float(self.lora_scaling))
            yield
        finally:
            for name, v in prev.items():
                lora_slot(self.student_module, name).lora = v

    def _sample_loop(self, module, mod, sched, z, cond2, g_scale, do_cfg, stochastic, noise, generator,
                     adapter2=None):
        """The sampling steps: CFG as one 2B forward; a stochastic step takes
        ``noise[i]`` or a draw from ``generator`` (zeros when neither).
        ``adapter2``: the adapter residuals, already doubled under CFG."""
        b, dev = z.shape[0], z.device
        sample = z * sched.init_noise_sigma
        state = mod.init_state(sample) if hasattr(mod, "init_state") else None
        kw = _adapter_kw(adapter2)
        for i, t in enumerate(sched.timesteps):
            inp = mod.scale_model_input(sched, sample, i)
            if do_cfg:
                pc, pu = module(torch.cat([inp, inp]), torch.full((2 * b,), t, device=dev), cond2, **kw).chunk(2)
                pred = g_scale * pc + (1.0 - g_scale) * pu
            else:
                pred = module(inp, torch.full((b,), t, device=dev), cond2, **kw)
            if state is not None:
                sample, state = mod.step(sched, pred, i, sample, state)
                continue
            step_noise = None
            if stochastic and noise is not None:
                step_noise = noise[i].to(dev)
            elif stochastic and generator is not None:
                step_noise = torch.randn(sample.shape, generator=generator, device=dev, dtype=sample.dtype)
            sample = mod.step(sched, pred, i, sample, noise=step_noise)
        return sample

    def _sample_conds(self, batch, g_scale):
        """(cond, or under CFG the 2B cond ⊕ uncond with the ``ucg_keys``
        dropped; CFG on)."""
        do_cfg = g_scale != 1.0
        if self.conditioner is None:
            return None, do_cfg
        cond = self.conditioner(batch, set_ucg_rate_zero=True)
        if not do_cfg:
            return cond, do_cfg
        return _cat(cond, self.conditioner(batch, ucg_keys=self.config.ucg_keys)), do_cfg

    @torch.no_grad()
    def sample(
        self,
        lora: Optional[LoraTree],
        z: torch.Tensor,
        batch: Dict[str, Any],
        num_steps: int = 4,
        guidance_scale: float = 1.0,
        decode: bool = True,
        use_teacher: bool = False,
        teacher_guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        adapter_conditioning_scale: float = 1.0,
    ) -> torch.Tensor:
        """Few-step sampling from latents ``z`` [B, h, w, C] (JAX
        ``sample``): the student with ``lora`` (None: the teacher's weights)
        on the sampling scheduler over the teacher's trailing timesteps, or
        with ``use_teacher`` the teacher on ``teacher_sampling_scheduler``
        at ``teacher_guidance_scale``; a guidance of 1.0 skips the uncond
        forward. With an adapter and ``batch[adapter_input_key]``, its
        residuals scaled by ``adapter_conditioning_scale`` condition every
        step. Decoded to [B, H, W, 3] unless ``decode`` is False."""
        if use_teacher:
            mod, module, g_scale = self.teacher_sampling_sched_mod, self.teacher_module, teacher_guidance_scale
            sched = mod.set_timesteps(self.sched_config, num_steps)
            stochastic = False
        else:
            mod, g_scale = self.sampling_sched_mod, guidance_scale
            base = self.teacher_sched_mod.set_timesteps(self.sched_config, num_steps)
            try:
                sched = mod.set_timesteps(self.sched_config, timesteps=np.asarray(base.timesteps))
            except TypeError:
                sched = mod.set_timesteps(self.sched_config, num_steps)
            module = self.student_module if lora is not None else self.teacher_module
            stochastic = self.sampling_scheduler_name in (
                "LCMScheduler", "FlashFlowMatchEulerDiscreteScheduler", "DDPMScheduler",
                "EulerAncestralDiscreteScheduler")
        cond2, do_cfg = self._sample_conds(batch, g_scale)
        res = None
        if self.adapter is not None and self.config.adapter_input_key in batch:
            res = self._adapter_residuals(batch, adapter_conditioning_scale)
        with self.using_lora(None if use_teacher else lora):
            sample = self._sample_loop(module, mod, sched, z.float(), cond2, g_scale, do_cfg, stochastic,
                                       noise, generator, _dup(res) if do_cfg else res)
        if decode and self.vae is not None:
            return self.vae.decode_latents(sample)
        return sample

    def log_samples(
        self,
        lora: Optional[LoraTree],
        batch: Dict[str, Any],
        input_shape: Sequence[int],
        num_steps=(1, 2, 4),
        guidance_scale: float = 1.0,
        max_samples: int = 8,
        log_teacher_samples: bool = False,
        teacher_guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Sample grids (JAX ``log_samples``): for each step count, latents
        of ``input_shape`` (h, w, C) for the first ``max_samples`` of the
        batch, the student's samples and with ``log_teacher_samples`` the
        teacher's from the same latents; the draws from ``generator``. The
        batch's adapter input, where it has one, conditions both."""
        num_steps = [num_steps] if isinstance(num_steps, int) else list(num_steps)
        n = min(max_samples, next(iter(batch.values())).shape[0])
        small = {k: v[:n] for k, v in batch.items()}
        dev = next(self.teacher_module.parameters()).device
        logs = {}
        for steps in num_steps:
            z = torch.randn((n, *input_shape), generator=generator, device=dev)
            logs[f"samples_{steps}_steps/student"] = self.sample(
                lora, z, small, num_steps=steps, guidance_scale=guidance_scale, generator=generator)
            if log_teacher_samples:
                logs[f"samples_{steps}_steps/teacher"] = self.sample(
                    None, z, small, num_steps=steps, use_teacher=True,
                    teacher_guidance_scale=teacher_guidance_scale)
        return logs

    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator, stage: int, latent: torch.Tensor) -> Dict[str, Any]:
        """Every random draw of one ``losses`` call, from ``generator`` (on
        the latents' device), shaped after ``latent`` [B, h, w, C]."""
        dev, shape, b = latent.device, latent.shape, latent.shape[0]
        normal = lambda: torch.randn(shape, generator=generator, device=dev, dtype=latent.dtype)
        uniform = lambda: torch.rand((), generator=generator, device=dev)
        start = sample_start_index(self.stage_pdfs[stage], generator)
        draws = {"start_idx": start, "noise": normal(), "guidance": uniform()}
        n_roll = self.config.K[stage] - start if self._sched_stochastic else 0
        draws["rollout_noise"] = [normal() for _ in range(n_roll)]
        t = self.sched_config.num_train_timesteps
        draws.update(dmd_t=torch.randint(0, t, (b,), generator=generator, device=dev),
                     dmd_noise=normal(), dmd_guidance=uniform())
        draws.update(gan_idx=torch.randint(0, len(self.config.gan_timesteps), (b,),
                                           generator=generator, device=dev),
                     gan_noise=normal())
        return draws

    def _guidance(self, u: torch.Tensor, stage: int) -> torch.Tensor:
        cfg = self.config
        lo, hi = cfg.guidance_scale_min[stage], cfg.guidance_scale_max[stage]
        return u.float() * (hi - lo) + lo

    def _student_forward(self, x, t, cond, adapter_res=None):
        if self.merged_student and self.config.remat_student_merge and torch.is_grad_enabled():
            return remat_call(lambda x_, t_: self.student_module(x_, t_, cond, **_adapter_kw(adapter_res)), x, t)
        return self.student_module(x, t, cond, **_adapter_kw(adapter_res))

    @torch.no_grad()
    def _adapter_residuals(self, batch: Dict[str, Any], scale: Optional[float] = None):
        """The frozen adapter's residuals of ``batch[adapter_input_key]`` (on
        the adapter's device), each scaled by ``scale`` (the config's by
        default); None without an adapter or an input key."""
        key = self.config.adapter_input_key
        if self.adapter is None or key is None:
            return None
        scale = self.config.adapter_conditioning_scale if scale is None else scale
        x = torch.as_tensor(batch[key], device=next(self.adapter.parameters()).device)
        return [r * scale for r in self.adapter(x)]

    def _conditionings(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """(cond, student_cond, uncond), as the JAX ``_conditionings``."""
        if self.conditioner is None:
            return None, None, None
        cfg = self.config
        cond = self.conditioner(batch, set_ucg_rate_zero=True)
        student_cond = self.conditioner(batch, generator=generator)
        if cfg.use_empty_prompt and any(f"{k}_empty_ids" in batch for k in cfg.ucg_keys):
            ub = dict(batch)
            for k in cfg.ucg_keys:
                if f"{k}_empty_ids" in batch:
                    ub[f"{k}_ids"] = batch[f"{k}_empty_ids"]
            uncond = self.conditioner(ub, set_ucg_rate_zero=True)
        else:
            uncond = self.conditioner(batch, ucg_keys=cfg.ucg_keys)
        return cond, student_cond, uncond

    @torch.no_grad()
    def _encode(self, batch: Dict[str, Any], noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = batch[self.config.input_key]
        if self.vae is None:
            return torch.as_tensor(x).float()
        return self.vae.encode(x, noise)

    @torch.no_grad()
    def _teacher_rollout(self, noisy, start_idx: int, cond, uncond, guidance, stage: int, step_noise,
                         adapter_res=None):
        """The K-step CFG rollout from position ``start_idx``, 2B-batched. A
        multistep scheduler (one with ``init_state``: DPM) threads its carry
        from a fresh one, so its first executed step is first order whatever
        ``start_idx`` is, as in JAX (``distill/flash.py:273-304``); DDPM takes
        ``step_noise``, one draw per step from ``start_idx``."""
        sched, mod = self.stage_schedules[stage], self.teacher_sched_mod
        cond2 = _cat(cond, uncond) if cond is not None else None
        kw = _adapter_kw(_dup(adapter_res))
        sample, b = noisy, noisy.shape[0]
        state = mod.init_state(sample) if self._sched_has_carry else None
        for n, i in enumerate(range(start_idx, self.config.K[stage])):
            t2 = torch.full((2 * b,), sched.timesteps[i], device=sample.device, dtype=torch.long)
            inp = mod.scale_model_input(sched, sample, i)
            pred_c, pred_u = self.teacher_module(torch.cat([inp, inp]), t2, cond2, **kw).chunk(2)
            pred = guidance * pred_c + (1.0 - guidance) * pred_u
            if state is not None:
                sample, state = mod.step(sched, pred, i, sample, state)
            else:
                sample = mod.step(sched, pred, i, sample, noise=step_noise[n] if self._sched_stochastic else None)
        return sample

    def _distill_loss(self, student_output, teacher_output):
        cfg = self.config
        if cfg.distill_loss_type == "l2":
            return l2_loss(student_output, teacher_output)
        if cfg.distill_loss_type == "l1":
            return l1_loss(student_output, teacher_output)
        if cfg.distill_loss_type == "huber":
            return huber_loss(student_output, teacher_output)
        if cfg.distill_loss_type == "lpips":
            s = center_crop(student_output, cfg.lpips_crop)
            t = center_crop(teacher_output, cfg.lpips_crop)

            # checkpointed: the decoder and VGG activations are recomputed in
            # the backward instead of held across the step
            def lp(s_, t_):
                dec_s = torch.clamp(self.vae.decode_latents(s_), -1, 1)
                dec_t = torch.clamp(self.vae.decode_latents(t_), -1, 1)
                return self.lpips(dec_s, dec_t).mean()

            return checkpoint(lp, s, t, use_reentrant=False)
        raise ValueError(cfg.distill_loss_type)

    def _dmd(self, student_output, cond, student_cond, uncond, stage: int, draws, adapter_res=None):
        """DMD: re-noise the student output at a random t, query the teacher
        (CFG) and the student without gradients, score difference."""
        t = draws["dmd_t"]
        sched = self.stage_schedules[stage]
        # noisy reaches the loss only through detached terms: no gradient
        noisy = add_noise(sched, student_output.detach(), draws["dmd_noise"], t)
        with torch.no_grad():
            cond2 = _cat(cond, uncond) if cond is not None else None
            real_c, real_u = self.teacher_module(torch.cat([noisy, noisy]), torch.cat([t, t]), cond2,
                                                 **_adapter_kw(_dup(adapter_res))).chunk(2)
            fake = self._student_forward(noisy, t, student_cond, adapter_res)
        g = self._guidance(draws["dmd_guidance"], stage)
        real = g * real_c + (1.0 - g) * real_u
        pred_x0 = predicted_x0_eps(real, t, noisy, self.sqrt_acp, self.sqrt_1macp, student_output.detach())
        return dmd_loss(student_output, real, fake, pred_x0, self.alphas_cumprod.to(t.device)[t], weighted=True)

    def _gan(self, z, student_output, teacher_output, cond, draws, adapter_res=None):
        """GAN branch: noise fake and real at the fixed timesteps, tap the
        teacher's features (``return_features``) on the 2B batch, both
        losses at once."""
        cfg = self.config
        sel = torch.tensor(cfg.gan_timesteps, device=z.device)
        ts = sel[draws["gan_idx"]]
        noise = draws["gan_noise"]
        real = teacher_output if cfg.use_teacher_as_real else z
        sched = self.stage_schedules[0]
        both = torch.cat([add_noise(sched, student_output, noise, ts), add_noise(sched, real, noise, ts)])
        cond2 = _cat(cond, cond) if cond is not None else None
        _, feats = self.teacher_module(both, torch.cat([ts, ts]), cond2, return_features=True,
                                       **_adapter_kw(_dup(adapter_res)))
        f_fake, f_real = feats.chunk(2)
        return gan_losses(self.discriminator, f_fake, f_real, cfg.gan_loss_type)

    # ------------------------------------------------------------------
    def losses(self, batch: Dict[str, Any], draws: Dict[str, Any], stage: int):
        """(loss_G + loss_D, aux): one backward of the total updates both
        the LoRA factors and the discriminator."""
        cfg = self.config
        sched = self.stage_schedules[stage]
        z = batch.get("__z")
        if z is None:
            z = self._encode(batch, draws.get("vae_noise"))
        pre = batch.get("__conds")
        cond, student_cond, uncond = pre if pre is not None else self._conditionings(batch)
        with record_function("fdt.train.adapter"):
            res = self._adapter_residuals(batch)

        b = z.shape[0]
        start_idx = int(draws["start_idx"])
        start_t = sched.timesteps[start_idx]
        t_b = torch.full((b,), start_t, device=z.device, dtype=torch.long)
        noise = draws["noise"]
        noisy_init = noise * sched.init_noise_sigma if start_idx == 0 else add_noise(sched, z, noise, t_b)
        noisy_in = self.teacher_sched_mod.scale_model_input(sched, noisy_init, start_idx)
        with record_function("fdt.train.student"):
            student_pred = self._student_forward(noisy_in, t_b, student_cond, res)
        c_skip, c_out = boundary_scalings(t_b, cfg.sigma_data, cfg.timestep_scaling)
        student_x0 = predicted_x0_eps(student_pred, t_b, noisy_init, self.sqrt_acp, self.sqrt_1macp, z)
        student_output = c_skip.reshape(-1, 1, 1, 1) * noisy_init + c_out.reshape(-1, 1, 1, 1) * student_x0

        g = self._guidance(draws["guidance"], stage)
        with record_function("fdt.train.rollout"):
            teacher_output = self._teacher_rollout(
                noisy_init.detach(), start_idx, cond, uncond, g, stage, draws["rollout_noise"], res)
        with record_function("fdt.train.distill"):
            distill = self._distill_loss(student_output, teacher_output)
        loss_g = distill * cfg.distill_loss_scale[stage]
        aux = {"loss/distill": distill, "start_timestep": start_t, "guidance": g}
        if cfg.use_dmd_loss:
            with record_function("fdt.train.dmd"):
                dmd = self._dmd(student_output, cond, student_cond, uncond, stage, draws, res)
            loss_g = loss_g + dmd * cfg.dmd_loss_scale[stage]
            aux["loss/dmd"] = dmd
        loss_d = torch.zeros((), device=z.device)
        if self.use_adversarial_loss:
            with record_function("fdt.train.gan"):
                loss_g_adv, loss_d = self._gan(z, student_output, teacher_output, cond, draws, res)
            loss_g = loss_g + cfg.adversarial_loss_scale[stage] * loss_g_adv
            aux["loss/gan_g"] = loss_g_adv
            aux["loss/gan_d"] = loss_d
        aux["loss/generator"] = loss_g
        return loss_g + loss_d, aux
