"""FlashDiffusionSD3 — the rectified-flow distillation step (SD3 MMDiT family).

Port of ``flash_diffusion_tpu/distill/flash_sd3.py:46-253`` (the config,
``__init__``, the teacher rollout, ``losses`` and its DMD and GAN parts) on
the skeleton of the port's ``FlashDiffusion`` (``distill/flash.py``): one
``draws`` dict for every random draw, the student as the teacher's modules
plus the LoRA (the side path, or merged weights under ``lora_mode=
"merge"`` or with a conv pair, optionally rematerialized with
``remat_student_merge``: JAX ``flash_sd3.py:136-150``), ``record_function``
spans ``fdt.train.*``. The flow-matching deltas against the ε family:

- timesteps are floats (σ·T) everywhere: the rollout, the student, DMD and
  the GAN keep them in fp32 (the base class casts its integer DDPM
  timesteps to ``torch.long``, which would change every timestep
  embedding here);
- noising is the σ-interpolation ``σ·noise + (1 − σ)·z`` with σ from the
  stage's shifted flow schedule (pure noise at start index 0);
- the student's one-step prediction is ``x̂₀ = noisy − v̂·σ``, with no
  boundary scalings;
- the teacher rollout is flow-match Euler from the start index to K, cond
  and uncond in one 2B forward a step; it is deterministic (no rollout
  noise, no ``scale_model_input``);
- DMD re-noises at a timestep index drawn over the full 1000-step flow
  schedule (``full_schedule``) and drops the ᾱ weighting; as in JAX (and
  the reference), the weight normalizer takes the raw CFG velocity as its
  "pred_x0";
- the GAN noises fake and real at the tail of that schedule
  (``timesteps[-i]`` for i in ``gan_tail_indices``; their sigmas are
  ``sigmas[-i − 1]``, since the sigmas carry the terminal 0) and reads the
  teacher's own tap, ``return_features=True``: the MMDiT's post-mid stream,
  a UNet's mid block (the toy proof of ``toy_quality_rf.py``).

Draws (``draw``): ``start_idx``, ``noise``, ``guidance``; ``dmd_idx`` [B]
(into ``full_schedule``), ``dmd_noise``, ``dmd_guidance``; ``gan_idx`` [B]
(into ``gan_tail_indices``) and ``gan_noise``. ``sample`` (JAX
``flash_sd3.py:255-309``): the student on the Flash flow-match step with
its noise injected (or drawn, one draw a step), the teacher on the plain
flow-match Euler step, both on the flow schedule of ``num_steps``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..schedulers import REGISTRY, SchedulerConfig, flow_match
from .common import sample_start_index
from .flash import FlashDiffusion, FlashDiffusionConfig, _cat
from .losses import dmd_loss, gan_losses


@dataclasses.dataclass
class FlashDiffusionSD3Config(FlashDiffusionConfig):
    """``FlashDiffusionConfig`` with the GAN's tail indices into the full
    flow schedule in place of fixed DDPM timesteps."""

    gan_tail_indices: List[int] = field(default_factory=lambda: [10, 250, 500, 750])
    use_adversarial_loss: bool = True


class FlashDiffusionSD3(FlashDiffusion):
    """The SD3 step: flow-match Euler teacher, the Flash flow-match sampler
    for the student, the tables above; ``losses`` as JAX's."""

    def __init__(
        self,
        config: FlashDiffusionSD3Config,
        teacher_module,  # MMDiT (or a UNet): (sample, t, cond, return_features)
        scheduler_config: Optional[SchedulerConfig] = None,
        vae=None,
        conditioner=None,  # SD3Conditioner
        discriminator=None,
        lpips=None,
        lora_scaling: float = 1.0,
    ):
        super().__init__(
            config, teacher_module, scheduler_config or SchedulerConfig(shift=3.0),
            teacher_scheduler="FlowMatchEulerDiscreteScheduler",
            sampling_scheduler="FlashFlowMatchEulerDiscreteScheduler",
            vae=vae, conditioner=conditioner, discriminator=discriminator, lpips=lpips,
            lora_scaling=lora_scaling,
        )
        self.use_adversarial_loss = discriminator is not None and config.use_adversarial_loss
        self.full_schedule = flow_match.set_timesteps(self.sched_config, self.sched_config.num_train_timesteps)
        ts_full = np.asarray(self.full_schedule.timesteps, np.float32)  # [T]
        sig_full = np.asarray(self.full_schedule.sigmas, np.float32)  # [T + 1], the terminal 0 last
        self.full_timesteps, self.full_sigmas = torch.from_numpy(ts_full), torch.from_numpy(sig_full)
        tail = np.asarray(config.gan_tail_indices, np.int64)
        self.gan_ts = torch.from_numpy(ts_full[-tail])
        self.gan_sigmas = torch.from_numpy(sig_full[-tail - 1])

    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator, stage: int, latent: torch.Tensor) -> Dict[str, Any]:
        """Every random draw of one ``losses`` call, from ``generator`` (on
        the latents' device), shaped after ``latent`` [B, h, w, C]."""
        dev, shape, b = latent.device, latent.shape, latent.shape[0]
        normal = lambda: torch.randn(shape, generator=generator, device=dev, dtype=latent.dtype)
        uniform = lambda: torch.rand((), generator=generator, device=dev)
        draws = {"start_idx": sample_start_index(self.stage_pdfs[stage], generator), "noise": normal(),
                 "guidance": uniform()}
        draws.update(dmd_idx=torch.randint(0, self.sched_config.num_train_timesteps, (b,), generator=generator,
                                           device=dev),
                     dmd_noise=normal(), dmd_guidance=uniform())
        draws.update(gan_idx=torch.randint(0, len(self.config.gan_tail_indices), (b,), generator=generator,
                                           device=dev),
                     gan_noise=normal())
        return draws

    @torch.no_grad()
    def _teacher_rollout(self, noisy, start_idx: int, cond, uncond, guidance, stage: int):
        """Flow-match Euler with CFG from position ``start_idx`` to K, cond
        and uncond in one 2B-batched forward a step, fp32 timesteps."""
        sched = self.stage_schedules[stage]
        cond2 = _cat(cond, uncond) if cond is not None else None
        sample, b = noisy, noisy.shape[0]
        for i in range(start_idx, self.config.K[stage]):
            t2 = torch.full((2 * b,), sched.timesteps[i], device=sample.device, dtype=torch.float32)
            pred_c, pred_u = self.teacher_module(torch.cat([sample, sample]), t2, cond2).chunk(2)
            pred = guidance * pred_c + (1.0 - guidance) * pred_u
            sample = flow_match.step(sched, pred, i, sample)
        return sample

    def _dmd(self, student_output, cond, student_cond, uncond, stage: int, draws):
        """DMD on rectified flow: re-noise the student output at a timestep of
        the full flow schedule, the teacher (CFG) and the student without
        gradients, the score difference unweighted."""
        idx = draws["dmd_idx"]
        t = self.full_timesteps.to(idx.device)[idx]
        sigma = self.full_sigmas.to(idx.device)[idx]
        # noisy reaches the loss only through detached terms: no gradient
        noisy = flow_match.add_noise(self.full_schedule, student_output.detach(), draws["dmd_noise"], sigma)
        with torch.no_grad():
            cond2 = _cat(cond, uncond) if cond is not None else None
            real_c, real_u = self.teacher_module(torch.cat([noisy, noisy]), torch.cat([t, t]), cond2).chunk(2)
            fake = self._student_forward(noisy, t, student_cond)
        g = self._guidance(draws["dmd_guidance"], stage)
        real = g * real_c + (1.0 - g) * real_u
        # the reference's quirk, kept: the raw CFG velocity as "pred_x0"
        return dmd_loss(student_output, real, fake, real, None, weighted=False)

    def _gan(self, z, student_output, teacher_output, cond, draws):
        """GAN branch: fake and real noised at the schedule's tail with one
        noise, the teacher's features (its tap) on the 2B batch, both losses
        at once (the generator's gradient flows through the teacher's first
        depth // 2 blocks into ``student_output``)."""
        cfg = self.config
        idx = draws["gan_idx"]
        ts = self.gan_ts.to(idx.device)[idx]
        sigma = self.gan_sigmas.to(idx.device)[idx]
        noise = draws["gan_noise"]
        real = teacher_output if cfg.use_teacher_as_real else z
        both = torch.cat([flow_match.add_noise(self.full_schedule, student_output, noise, sigma),
                          flow_match.add_noise(self.full_schedule, real, noise, sigma)])
        cond2 = _cat(cond, cond) if cond is not None else None
        _, feats = self.teacher_module(both, torch.cat([ts, ts]), cond2, return_features=True)
        f_fake, f_real = feats.chunk(2)
        return gan_losses(self.discriminator, f_fake, f_real, cfg.gan_loss_type)

    # ------------------------------------------------------------------
    def losses(self, batch: Dict[str, Any], draws: Dict[str, Any], stage: int):
        """(loss_G + loss_D, aux), as JAX ``FlashDiffusionSD3.losses``."""
        cfg = self.config
        sched = self.stage_schedules[stage]
        z = batch.get("__z")
        if z is None:
            z = self._encode(batch, draws.get("vae_noise"))
        pre = batch.get("__conds")
        cond, student_cond, uncond = pre if pre is not None else self._conditionings(batch)

        b = z.shape[0]
        start_idx = int(draws["start_idx"])
        start_t = sched.timesteps[start_idx]
        t_b = torch.full((b,), start_t, device=z.device, dtype=torch.float32)
        sigma = sched.sigmas[start_idx]
        noise = draws["noise"]
        if start_idx == 0:
            noisy_init = noise * sched.init_noise_sigma
        else:
            noisy_init = flow_match.add_noise(sched, z, noise, torch.full((b,), sigma, device=z.device))
        with record_function("fdt.train.student"):
            student_pred = self._student_forward(noisy_init, t_b, student_cond)
        student_output = noisy_init - student_pred * sigma

        g = self._guidance(draws["guidance"], stage)
        with record_function("fdt.train.rollout"):
            teacher_output = self._teacher_rollout(noisy_init.detach(), start_idx, cond, uncond, g, stage)
        with record_function("fdt.train.distill"):
            distill = self._distill_loss(student_output, teacher_output)
        loss_g = distill * cfg.distill_loss_scale[stage]
        aux = {"loss/distill": distill, "start_timestep": start_t, "guidance": g}
        if cfg.use_dmd_loss:
            with record_function("fdt.train.dmd"):
                dmd = self._dmd(student_output, cond, student_cond, uncond, stage, draws)
            loss_g = loss_g + dmd * cfg.dmd_loss_scale[stage]
            aux["loss/dmd"] = dmd
        loss_d = torch.zeros((), device=z.device)
        if self.use_adversarial_loss:
            with record_function("fdt.train.gan"):
                loss_g_adv, loss_d = self._gan(z, student_output, teacher_output, cond, draws)
            loss_g = loss_g + cfg.adversarial_loss_scale[stage] * loss_g_adv
            aux["loss/gan_g"] = loss_g_adv
            aux["loss/gan_d"] = loss_d
        aux["loss/generator"] = loss_g
        return loss_g + loss_d, aux

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample(
        self,
        lora,
        z: torch.Tensor,
        batch: Dict[str, Any],
        num_steps: int = 4,
        guidance_scale: float = 1.0,
        decode: bool = True,
        use_teacher: bool = False,
        teacher_guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Few-step flow-match sampling (JAX ``FlashDiffusionSD3.sample``):
        the student with ``lora`` on the Flash flow-match step (stochastic),
        or with ``use_teacher`` the teacher on the plain Euler step at
        ``teacher_guidance_scale``; float timesteps, CFG as one 2B forward."""
        sched = flow_match.set_timesteps(self.sched_config, num_steps)
        if use_teacher:
            module, g_scale, mod, stochastic = self.teacher_module, teacher_guidance_scale, flow_match, False
        else:
            module = self.student_module if lora is not None else self.teacher_module
            g_scale, mod, stochastic = guidance_scale, REGISTRY["FlashFlowMatchEulerDiscreteScheduler"], True
        cond2, do_cfg = self._sample_conds(batch, g_scale)
        with self.using_lora(None if use_teacher else lora):
            sample = self._sample_loop(module, mod, sched, z.float(), cond2, g_scale, do_cfg, stochastic,
                                       noise, generator)
        if decode and self.vae is not None:
            return self.vae.decode_latents(sample)
        return sample
