"""The port's training run against the JAX package, at tiny sizes on the CPU.

Held against JAX with every draw injected: the EMA functions (exact); the
six optimizers with a schedule, a global-norm clip and gradient
accumulation against optax compiled as the JAX trainer runs it (1e-6);
Euler and Euler-ancestral (1e-6 of the sample's scale); ``sample`` of the
ε family (LCM student with a LoRA, Euler-ancestral teacher under CFG, with
and without the tiny VAE decode) and of SD3 (the tiny MMDiT) at 1e-4; the
``"g"`` and ``"d"`` phase gradients against ``jax.value_and_grad`` over the
LoRA or the discriminator alone (1e-4); the ``switch_teacher`` merge
against JAX ``_merged_teacher``'s (one bf16 ulp); ``rename_keys`` and
``adapt_state_dict``; the PEFT file read back by JAX. On the port alone:
offload against resident, checkpoint round trip and resume (bit-equal),
the alternating parity, ``switch_teacher`` inside ``fit``, and
``build_trainer("sd15")`` driven as ``chip_smoke.py`` phase 10 drives it on
the card (shards, EMA, accumulation 2, validation, samples, checkpoints,
resume, export).
"""

import functools
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.distill import (
    ConvDiscriminator,
    DiscriminatorConfig,
    FlashDiffusion,
    FlashDiffusionConfig,
    FlashDiffusionSD3,
    FlashDiffusionSD3Config,
)
from flash_diffusion_tpu_torch.lora import init_lora, load_peft_safetensors, save_peft_safetensors, to_peft
from flash_diffusion_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig, MMDiT, MMDiTConfig, UNetConfig
from flash_diffusion_tpu_torch.schedulers import REGISTRY
from flash_diffusion_tpu_torch.schedulers import SchedulerConfig as TSchedulerConfig
from flash_diffusion_tpu_torch.trainer import (
    SCHEDULES,
    CheckpointCallback,
    MetricLogger,
    SampleLogger,
    TrainingConfig,
    TrainingPipeline,
    adapt_state_dict,
    export_lora,
    latest_step,
    rename_keys,
    restore_state,
    save_state,
)
from flash_diffusion_tpu_torch.utils import discriminator_from_jax, lora_from_jax, mmdit_from_jax, vae_from_jax
from flash_diffusion_tpu_torch.utils import ema as tema
from test_torch_train import B, HW, UNET_KW, VAE_KW, jax_step_draws, jax_unet, perturbed, port_unet, t_

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp
    import optax

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill import FlashDiffusionSD3 as JFlashDiffusionSD3
    from flash_diffusion_tpu.distill import FlashDiffusionSD3Config as JFlashDiffusionSD3Config
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.models import mmdit as jmmdit
    from flash_diffusion_tpu.schedulers import REGISTRY as JREGISTRY
    from flash_diffusion_tpu.schedulers import SchedulerConfig as JSchedulerConfig
    from flash_diffusion_tpu.trainer import checkpoint as jckpt
    from flash_diffusion_tpu.trainer.training_config import TrainingConfig as JTrainingConfig
    from flash_diffusion_tpu.utils import ema as jema
    from flash_diffusion_tpu.utils.hf import unet_lora_name_map
except ImportError:
    jax = None

torch.set_num_threads(2)
C = 4


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def close(got, want, tol, msg=""):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0, err_msg=msg)


def flat(tree, prefix=""):
    """A nested dict's leaves by '/'-joined path (a leading 'params' dropped)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, "" if key == "params" else key))
        else:
            out[key] = v
    return out


# ---------------------------------------------------------------- EMA
def test_ema_functions_match_jax(jax_ref):
    """``init_ema`` (a real copy), ``update_ema`` at four decays and
    ``ema_warmup_decay`` over 700 steps: bit-equal to JAX."""
    rng = np.random.default_rng(0)
    e, p = (rng.standard_normal((64, 33)).astype(np.float32) for _ in range(2))
    src = {"m": {"a": torch.tensor(p)}}
    copy = tema.init_ema(src)
    assert torch.equal(copy["m"]["a"], src["m"]["a"]) and copy["m"]["a"].data_ptr() != src["m"]["a"].data_ptr()
    for decay in (0.999, 0.9999, 0.5, 0.123456):
        want = np.asarray(jema.update_ema({"x": jnp.asarray(e)}, {"x": jnp.asarray(p)}, decay)["x"])
        got = tema.update_ema({"x": torch.tensor(e)}, {"x": torch.tensor(p)}, decay)["x"]
        np.testing.assert_array_equal(got.numpy(), want)
    steps = np.arange(0, 5000, 7)
    np.testing.assert_array_equal(tema.ema_warmup_decay(torch.tensor(steps)).numpy(),
                                  np.asarray(jema.ema_warmup_decay(jnp.asarray(steps))))


# ---------------------------------------------------------------- optimizers
# each optimizer with one of the four schedules (every schedule taken twice
# or more over the six)
OPTIMIZER_SCHEDULES = {
    "Adam": ("warmup_cosine", {"warmup_steps": 2, "decay_steps": 6}),
    "AdamW": ("cosine", {"decay_steps": 3}),
    "Adadelta": ("exponential", {"transition_steps": 2, "decay_rate": 0.5}),
    "Adagrad": ("constant", {}),
    "RMSprop": ("cosine", {"decay_steps": 3}),
    "SGD": ("warmup_cosine", {"warmup_steps": 2, "decay_steps": 6}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZER_SCHEDULES))
def test_optimizers_match_optax(jax_ref, name):
    """Eight micro-steps of each optimizer (with momentum too for RMSprop
    and SGD) under a learning-rate schedule, a global-norm clip of 4 and
    gradient accumulation 2, against ``TrainingConfig.build_optimizer`` of
    the JAX package (optax, ``MultiSteps``) compiled by ``jax.jit``: 1e-6;
    the update lands on every second micro-step, the count is 4."""
    assert {s for s, _ in OPTIMIZER_SCHEDULES.values()} == set(SCHEDULES)
    rng = np.random.default_rng(1)
    shapes = ((5, 3), (7,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 3 for s in shapes] for _ in range(8)]
    sched, skw = OPTIMIZER_SCHEDULES[name]
    for kw in [{}] + ([{"momentum": 0.9}] if name in ("RMSprop", "SGD") else []):
        common = dict(optimizers_name=[name, name], learning_rates=[1e-2, 1e-2], optimizers_kwargs=[kw, kw],
                      lr_schedulers_name=[sched, None], lr_schedulers_kwargs=[skw, {}], gradient_clip_norm=4.0,
                      gradient_accumulation_steps=2)
        tx = JTrainingConfig(**common).build_optimizer(0)
        update = jax.jit(tx.update)
        jp = [jnp.asarray(p) for p in params]
        state = tx.init(jp)
        tp = [t_(p) for p in params]
        opt = TrainingConfig(**common).build_optimizer(0, tp)
        for i, gs in enumerate(grads):
            up, state = update([jnp.asarray(g) for g in gs], state, jp)
            jp = [p + u.astype(p.dtype) for p, u in zip(jp, up)]
            for p, g in zip(tp, gs):
                p.grad = t_(g)
            assert opt.step() == (i % 2 == 1)
            for p, w in zip(tp, jp):
                close(p, w, 1e-6, f"{name} {sched} {kw} step {i}")
        assert opt.count == 4


# ---------------------------------------------------------------- Euler
@pytest.mark.parametrize("name", ["EulerDiscreteScheduler", "EulerAncestralDiscreteScheduler"])
def test_euler_schedulers_match_jax(jax_ref, name):
    """``set_timesteps`` (timesteps, sigmas, the ancestral split, the initial
    sigma: equal) and ``scale_model_input`` and ``step`` along a trajectory
    of n = 1, 2, 4, 8 steps in three spacings and two prediction types, the
    ancestral noise injected from JAX's draws: 1e-6 of the sample's
    scale."""
    rng = np.random.default_rng(2)
    for kw in ({}, {"prediction_type": "v_prediction"}, {"timestep_spacing": "leading", "steps_offset": 1},
               {"timestep_spacing": "linspace"}):
        for n in (1, 2, 4, 8):
            js, ts = JREGISTRY[name].set_timesteps(JSchedulerConfig(**kw), n), \
                REGISTRY[name].set_timesteps(TSchedulerConfig(**kw), n)
            assert [int(t) for t in np.asarray(js.timesteps)] == ts.timesteps
            for a, b in ((js.sigmas, ts.sigmas), (js.sigma_up, ts.sigma_up), (js.sigma_down, ts.sigma_down)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b, np.float32))
            assert float(js.init_noise_sigma) == ts.init_noise_sigma
            x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * ts.init_noise_sigma
            for i in range(n):
                out = rng.standard_normal(x.shape).astype(np.float32)
                key = jax.random.PRNGKey(i)
                noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
                close(REGISTRY[name].scale_model_input(ts, t_(x), i),
                      JREGISTRY[name].scale_model_input(js, jnp.asarray(x), i), 1e-6)
                want = np.asarray(JREGISTRY[name].step(js, jnp.asarray(out), i, jnp.asarray(x), key=key))
                close(REGISTRY[name].step(ts, t_(out), i, t_(x), noise=t_(noise)), want, 1e-6, f"{kw} n={n} i={i}")
                x = want


# ---------------------------------------------------------------- sample
class _JCond:
    """A conditioner stand-in with the JAX call: the batch's context (and
    pooled vector), zeroed for an unconditional drop."""

    def __call__(self, params, batch, rng=None, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": {k: batch[k] * 0.0 if ucg_keys else batch[k] for k in ("crossattn", "vector") if k in batch}}


class _TCond:
    """The same stand-in with the port's call."""

    def __call__(self, batch, generator=None, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": {k: batch[k] * 0.0 if ucg_keys else batch[k] for k in ("crossattn", "vector") if k in batch}}


def jax_step_noise(key, shape, n):
    """The per-step noise ``sample`` draws from ``key`` (one split a step)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(t_(jax.random.normal(sub, shape, jnp.float32)))
    return out


@functools.lru_cache(maxsize=None)
def sample_models():
    """The tiny UNet (and VAE) of test_torch_train in both packages:
    DDPM teacher, LCM student sampler, Euler-ancestral teacher sampler."""
    net, uparams = jax_unet()
    jvae = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW))
    vparams = perturbed(jax.jit(jvae.init)(jax.random.PRNGKey(7), jnp.zeros((1, 2 * HW, 2 * HW, 3))), 8)
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6)
    kw = dict(K=[2], num_iterations_per_K=[2], mixture_num_components=2)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**kw), student_module=net, teacher_module=net, vae=jvae,
                             conditioner=_JCond(), teacher_sampling_scheduler="EulerAncestralDiscreteScheduler",
                             lora_scaling=0.5)
    vae = AutoencoderKL(AutoencoderKLConfig(**VAE_KW))
    vae.load_state_dict(vae_from_jax(vparams, vae.config))
    unet = port_unet(uparams).requires_grad_(False)
    tmodel = FlashDiffusion(FlashDiffusionConfig(**kw), unet, vae=vae.eval(), conditioner=_TCond(),
                            teacher_sampling_scheduler="EulerAncestralDiscreteScheduler", lora_scaling=0.5)
    # the student carries a zero-B tree; sample is handed the perturbed one
    tmodel.attach_lora(init_lora(unet, 2, torch.Generator().manual_seed(0)))
    return jmodel, {"teacher": uparams, "vae": vparams}, lora, tmodel, lora_from_jax(lora, UNetConfig(**UNET_KW))


@pytest.mark.parametrize("who,decode", [("student", False), ("teacher", True), ("teacher-dpm", False)])
def test_flash_sample_matches_jax(jax_ref, who, decode):
    """``FlashDiffusion.sample``: the LCM student (4 steps over the DDPM
    teacher's trailing timesteps, guidance 1, a LoRA other than the one
    attached, the step noise injected from JAX's key splits; latents out)
    or the teacher (Euler ancestral, 2 steps, CFG 5 as one 2B forward;
    through the tiny VAE decode; or DPM-Solver++ 2M, Pixart's, its
    multistep carry through 3 steps), against JAX ``sample``: 1e-4. The
    attached tree is back afterwards."""
    jmodel, frozen, jl, tmodel, tl = sample_models()
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    ctx = rng.standard_normal((B, 8, 16)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    teacher = who.startswith("teacher")
    steps = 3 if who == "teacher-dpm" else 2 if teacher else 4
    if who == "teacher-dpm":
        saved = jmodel.teacher_sampling_sched_mod, tmodel.teacher_sampling_sched_mod
        jmodel.teacher_sampling_sched_mod = JREGISTRY["DPMSolverMultistepScheduler"]
        tmodel.teacher_sampling_sched_mod = REGISTRY["DPMSolverMultistepScheduler"]
    want = jmodel.sample(frozen, None if teacher else jl, jnp.asarray(z), {"crossattn": jnp.asarray(ctx)},
                         num_steps=steps, decode=decode, use_teacher=teacher, teacher_guidance_scale=5.0, rng=key)
    attached = {name: m.lora for name, m in tmodel.student_module.named_modules() if getattr(m, "lora", None)}
    got = tmodel.sample(None if teacher else tl, t_(z), {"crossattn": t_(ctx)}, num_steps=steps, decode=decode,
                        use_teacher=teacher, teacher_guidance_scale=5.0,
                        noise=None if teacher else jax_step_noise(key, z.shape, steps))
    if who == "teacher-dpm":
        jmodel.teacher_sampling_sched_mod, tmodel.teacher_sampling_sched_mod = saved
    close(got, want, 1e-4)
    assert all(tmodel.student_module.get_submodule(n).lora is v for n, v in attached.items())


@pytest.mark.parametrize("who", ["student", "teacher"])
def test_sd3_sample_matches_jax(jax_ref, who):
    """``FlashDiffusionSD3.sample`` on the tiny MMDiT of
    test_torch_sd3_train: the student with a LoRA on the Flash flow-match
    step (noise injected), or the teacher on the plain Euler step with CFG
    5; 4 steps, no decode: 1e-4. The LoRA's root ``proj_out`` pair has B
    = 0, as training leaves it (JAX merges it into the weights it samples
    with; the port's tree has no such pair)."""
    from test_torch_sd3_train import MMDIT_KW, _cond_np

    c3, hw = MMDIT_KW["in_channels"], 16
    net = jm.MMDiT(jmmdit.MMDiTConfig(**MMDIT_KW))
    cond = _cond_np(0)
    cond1 = {"cond": {k: jnp.asarray(v[:1]) for k, v in cond.items()}}
    params = perturbed(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, c3)), jnp.zeros((1,)), cond1),
                       1)
    lora = perturbed(jlora.init_lora(params, 2, jax.random.PRNGKey(5)), 6)
    # JAX samples on merged weights, where the root proj_out pair (inert on
    # the training side path, so its B stays 0) would count: keep its B 0
    root = lora["params"] if "params" in lora else lora
    root["proj_out"]["kernel"]["b"] = np.zeros_like(root["proj_out"]["kernel"]["b"])
    kw = dict(K=[4], num_iterations_per_K=[2], mixture_num_components=4)
    jmodel = JFlashDiffusionSD3(JFlashDiffusionSD3Config(**kw), student_module=net, teacher_module=net,
                                conditioner=_JCond(), lora_scaling=0.5)
    cfg = MMDiTConfig(**MMDIT_KW)
    mmdit = MMDiT(cfg)
    mmdit.load_state_dict(mmdit_from_jax(params, cfg))
    tmodel = FlashDiffusionSD3(FlashDiffusionSD3Config(**kw), mmdit.eval().requires_grad_(False),
                               conditioner=_TCond(), lora_scaling=0.5)
    tl = lora_from_jax(lora, cfg)
    tmodel.attach_lora(tl)
    z = np.random.default_rng(6).standard_normal((B, hw, hw, c3)).astype(np.float32)
    key, teacher = jax.random.PRNGKey(7), who == "teacher"
    want = jmodel.sample({"teacher": params}, None if teacher else lora, jnp.asarray(z),
                         {k: jnp.asarray(v) for k, v in cond.items()}, num_steps=4, decode=False,
                         use_teacher=teacher, teacher_guidance_scale=5.0, rng=key)
    got = tmodel.sample(None if teacher else tl, t_(z), {k: t_(v) for k, v in cond.items()},
                        num_steps=4, decode=False, use_teacher=teacher, teacher_guidance_scale=5.0,
                        noise=None if teacher else jax_step_noise(key, z.shape, 4))
    close(got, want, 1e-4)


# ---------------------------------------------------------------- phases
@pytest.fixture(scope="module")
def phase_setup(jax_ref):
    """The l2 step of test_torch_train without DMD (hinge GAN, K = [2, 2],
    stage 1, batch 2) with JAX's gradients over the LoRA alone and over the
    discriminator alone (one compile), and a port trainer around the same
    weights."""
    net, uparams = jax_unet()
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=1))
    dparams = perturbed(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((B, HW // 2, HW // 2, 32))), 4)
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6)
    kw = dict(K=[2, 2], num_iterations_per_K=[2, 2], guidance_scale_min=1.0, guidance_scale_max=3.0,
              distill_loss_type="l2", mixture_num_components=2, gan_loss_type="hinge",
              adversarial_loss_scale=[0.5, 1.0])
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**kw), student_module=net, teacher_module=net,
                             discriminator=jdisc, lora_scaling=0.5)
    rng = np.random.default_rng(18)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [rng.standard_normal((B, 8, 16)).astype(np.float32) for _ in range(3)]
    conds[2][:] = 0.0
    jbatch = {"__z": jnp.asarray(z), "__conds": tuple({"cond": {"crossattn": jnp.asarray(c)}} for c in conds)}
    stage, key = 1, jax.random.PRNGKey(19)
    frozen = {"teacher": uparams}
    g_fn = lambda lo: jmodel.losses({"lora": lo, "disc": dparams}, frozen, jbatch, key, stage)
    d_fn = lambda di: jmodel.losses({"lora": lora, "disc": di}, frozen, jbatch, key, stage)
    phases = jax.jit(lambda lo, di: (jax.value_and_grad(g_fn, has_aux=True)(lo),
                                     jax.value_and_grad(d_fn, has_aux=True)(di)))
    ((_, g_aux), g_grads), ((_, d_aux), d_grads) = phases(lora, dparams)
    ucfg, dcfg = UNetConfig(**UNET_KW), DiscriminatorConfig(feature_dim=8, num_stages=1)
    disc = ConvDiscriminator(dcfg, in_channels=32)
    disc.load_state_dict(discriminator_from_jax(dparams, dcfg))
    tmodel = FlashDiffusion(FlashDiffusionConfig(**kw, gan_update_mode="alternating"), port_unet(uparams),
                            discriminator=disc, lora_scaling=0.5)
    trainer = TrainingPipeline(tmodel, TrainingConfig(optimizers_name=["SGD", "SGD"], learning_rates=[1e-3, 1e-3]),
                               lora_from_jax(lora, ucfg), frozen_dtype=None, device="cpu")
    tbatch = {"__z": t_(z), "__conds": tuple({"cond": {"crossattn": t_(c)}} for c in conds)}
    draws = jax_step_draws(jmodel, key, stage, z)
    tmodel.draw = lambda *a, **k: draws
    return dict(trainer=trainer, batch=tbatch, stage=stage, g=(g_aux, lora_from_jax(g_grads, ucfg)),
                d=(d_aux, discriminator_from_jax(d_grads, dcfg)))


@pytest.mark.parametrize("phase", ["g", "d"])
def test_phase_gradients_match_jax(phase_setup, phase):
    """``train_step(..., phase)``: on ``"g"`` the LoRA gradients equal
    ``jax.value_and_grad`` over the LoRA alone and the discriminator has
    none and stays put; on ``"d"`` the discriminator's equal JAX's over the
    discriminator alone and the LoRA has none and stays put; the losses
    agree: 1e-4."""
    s = phase_setup
    tr = s["trainer"]
    disc = tr.model.discriminator
    lora0 = {k: {n: v.clone() for n, v in ab.items()} for k, ab in tr.lora.items()}
    disc0 = {k: v.clone() for k, v in disc.state_dict().items()}
    aux = tr.train_step(s["batch"], s["stage"], phase)
    want_aux, want = s[phase]
    for k in ("loss/distill", "loss/gan_g", "loss/gan_d"):
        close(aux[k], want_aux[k], 1e-4, k)
    if phase == "g":
        for name, ab in tr.lora.items():
            for k in ("a", "b"):
                close(ab[k].grad, want[name][k], 1e-4, f"{name}.{k}")
        assert all(p.grad is None for p in disc.parameters())
        assert all(torch.equal(v, disc.state_dict()[k]) for k, v in disc0.items())
    else:
        for name, p in disc.named_parameters():
            close(p.grad, want[name], 1e-4, name)
        assert all(t.grad is None for ab in tr.lora.values() for t in ab.values())
        assert all(torch.equal(lora0[k][n], v) for k, ab in tr.lora.items() for n, v in ab.items())
    with torch.no_grad():  # back to the setup's state for the other phase
        for k, ab in tr.lora.items():
            for n, v in ab.items():
                v.copy_(lora0[k][n])
        disc.load_state_dict(disc0)


def test_switch_teacher_merge_matches_jax(jax_ref):
    """``merge_lora_into_teacher`` on a bf16 teacher against JAX
    ``_merged_teacher``'s computation (``student_params`` under jit, cast
    to bf16): every weight within one bf16 ulp, most equal; the untargeted
    weights untouched."""
    net, uparams = jax_unet()
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6, scale=0.3)
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), uparams)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(K=[2], num_iterations_per_K=[2], mixture_num_components=2),
                             student_module=net, lora_scaling=0.5)
    merge = jax.jit(lambda f, lo: jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                                         jmodel.student_params(f, lo)))
    want = port_unet(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), merge({"teacher": bf16}, lora)))
    unet = port_unet(uparams).to(torch.bfloat16)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    tmodel = FlashDiffusion(FlashDiffusionConfig(K=[2], num_iterations_per_K=[2], mixture_num_components=2), unet,
                            lora_scaling=0.5)
    tl = lora_from_jax(lora, unet.config)
    tmodel.merge_lora_into_teacher(tl)
    targeted = {f"{n}.weight" for n in tl}
    equal = 0
    for k, v in unet.state_dict().items():
        w = want.state_dict()[k].to(torch.bfloat16)
        if k not in targeted:
            assert torch.equal(v, before[k]), k
            continue
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(v.float().abs(), w.float().abs())
        assert torch.all((v.float() - w.float()).abs() <= ulp), k
        assert not torch.equal(v, before[k]), k
        equal += torch.equal(v, w)
    assert equal >= len(targeted) // 2


# ---------------------------------------------------------------- checkpoint helpers
def test_rename_keys_and_adapt_state_dict_match_jax(jax_ref):
    """``rename_keys`` over a nested tree (prefix and exact matches) and a
    flat state dict; ``adapt_state_dict``: zeros fill (grown), narrowing,
    and the normal fill's statistics (the overlap kept, the grown part with
    the source's mean and standard deviation), against JAX's."""
    rng = np.random.default_rng(9)
    tree = {"a": {"b": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)}, "c": np.ones(2, np.float32)},
            "d": np.zeros(3, np.float32)}
    key_map = {"a/b": "x/y", "d": "e"}
    want, got = flat(jckpt.rename_keys(tree, key_map)), flat(rename_keys(tree, key_map))
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    assert rename_keys({"conv_in.weight": 1, "conv_in.bias": 2}, {"conv_in": "conv_x"}, sep=".") == {
        "conv_x.weight": 1, "conv_x.bias": 2}
    src = {"conv_in": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 2 + 1},
           "head": {"kernel": rng.standard_normal((16, 6)).astype(np.float32)}}
    shapes = {"conv_in/kernel": (3, 3, 9, 8), "head/kernel": (10, 6)}
    want = flat(jckpt.adapt_state_dict(src, shapes, fill="zeros"))
    got = flat(adapt_state_dict(src, shapes, fill="zeros"))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    big = {"w": {"kernel": rng.standard_normal((64, 64)).astype(np.float32) * 3 + 2}}
    got = flat(adapt_state_dict(big, {"w/kernel": (256, 64)}, fill="normal",
                                generator=torch.Generator().manual_seed(0)))["w/kernel"].numpy()
    want = np.asarray(flat(jckpt.adapt_state_dict(big, {"w/kernel": (256, 64)}, fill="normal"))["w/kernel"])
    np.testing.assert_array_equal(got[:64], big["w"]["kernel"])
    for g, w in ((got[64:], want[64:]),):
        assert abs(g.mean() - w.mean()) < 0.1 and abs(g.std() - w.std()) < 0.1
        assert abs(g.mean() - 2.0) < 0.1 and abs(g.std() - 3.0) < 0.1


def test_peft_file_read_by_jax(jax_ref, tmp_path):
    """The port's ``save_peft_safetensors`` of the bridged tiny-UNet LoRA,
    read by JAX ``load_peft_safetensors``, gives the JAX tree back (1e-7)
    with JAX's scaling, each diffusers module name mapped to JAX's path
    through ``unet_lora_name_map`` (JAX's ``from_peft`` turns the names'
    dots into slashes before it looks its name map up, so it cannot invert
    one: read without it); the file's keys equal JAX ``to_peft``'s; the
    port's ``load_peft_safetensors`` reads it back equal."""
    _, uparams = jax_unet()
    jl = perturbed(jlora.init_lora(uparams, 3, jax.random.PRNGKey(5)), 6)
    tl = lora_from_jax(jl, UNetConfig(**UNET_KW))
    path = str(tmp_path / "pytorch_lora_weights.safetensors")
    save_peft_safetensors(path, tl, prefix="unet")
    name_map = unet_lora_name_map(jm.UNetConfig(**UNET_KW))
    inverse = {v: k for k, v in name_map.items()}
    back, scaling = jlora.load_peft_safetensors(path, uparams, prefix="unet")
    got = {}
    for key, v in flat(back).items():
        module, leaf = key.rsplit("/kernel/", 1)
        got[f"{inverse[module.replace('/', '.')]}/kernel/{leaf}"] = v
    want = flat(jl)
    assert got.keys() == want.keys() and scaling == 1.0
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=1e-7, rtol=0, err_msg=k)
    assert set(to_peft(tl)) == set(jlora.to_peft(jl["params"] if "params" in jl else jl, name_map, "unet"))
    mine, s2 = load_peft_safetensors(path)
    assert s2 == 1.0 and all(torch.equal(mine[n][k], tl[n][k]) for n in tl for k in ("a", "b"))


# ---------------------------------------------------------------- the port's trainer
def tiny_trainer(cfg_kw=None, train_kw=None, offload=0, seed=0):
    """A tiny SD1.5-shaped trainer on the CPU: the UNet of test_torch_train
    with ``remat``, its VAE, a 1-layer CLIP, a 1-stage discriminator; l2,
    DMD and hinge GAN, K = [2, 2]; built from ``seed``."""
    from flash_diffusion_tpu_torch.models import UNet2DCondition
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedder, ClipEmbedderConfig, ConditionerWrapper

    torch.manual_seed(seed)
    unet = UNet2DCondition(UNetConfig(**UNET_KW, remat=True))
    vae = AutoencoderKL(AutoencoderKLConfig(**VAE_KW))
    clip = ConditionerWrapper([ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=dict(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=8,
        eos_token_id=63)))])
    disc = ConvDiscriminator(DiscriminatorConfig(feature_dim=8, num_stages=1), in_channels=32)
    kw = {**dict(K=[2, 2], num_iterations_per_K=[2, 2], distill_loss_type="l2", mixture_num_components=2,
                 use_dmd_loss=True, adversarial_loss_scale=0.5), **(cfg_kw or {})}
    model = FlashDiffusion(FlashDiffusionConfig(**kw), unet, vae=vae, conditioner=clip, discriminator=disc)
    lora = init_lora(unet, 2, torch.Generator().manual_seed(1))
    tc = TrainingConfig(learning_rates=[1e-3, 1e-3], seed=seed, **(train_kw or {}))
    return TrainingPipeline(model, tc, lora, device="cpu", text_encoder_offload=offload)


def tiny_batches(n, seed=21):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (B, 2 * HW, 2 * HW, 3)).astype(np.float32),
             "text_ids": rng.integers(0, 63, (B, 8))} for _ in range(n)]


def snap(tr):
    """Copies of the trainable state's tensors, by name."""
    out = {f"lora.{n}.{k}": v.detach().clone() for n, ab in tr.lora.items() for k, v in ab.items()}
    out.update({f"disc.{k}": v.clone() for k, v in tr.model.discriminator.state_dict().items()})
    if tr.ema is not None:
        out.update({f"ema.{n}.{k}": v.clone() for n, ab in tr.ema.items() for k, v in ab.items()})
    for which in ("opt_g", "opt_d"):
        st = getattr(tr, which).state_dict()
        out.update({f"{which}.{s}.{i}": t.clone() for s, ts in st["slots"].items() for i, t in enumerate(ts)})
        out.update({f"{which}.acc.{i}": t.clone() for i, t in enumerate(st["acc"])})
        out[f"{which}.counts"] = torch.tensor([st["count"], st["mini_step"]])
    out["step"] = torch.tensor(tr.step)
    out["generator"] = tr.generator.get_state().clone()
    return out


def test_offload_matches_resident():
    """Text towers on the host between bursts of 2 batches against resident
    ones, 3 steps: the same losses and the same LoRA, bit for bit; two
    bursts moved the towers; ``sampling_frozen`` moves them once more and
    hands them back to their host storage; ``stage_batch`` outside ``fit``
    places them for its encode and stages what the resident trainer does."""
    data = tiny_batches(3)
    res, off = tiny_trainer(), tiny_trainer(offload=2)
    losses = {}
    for name, tr in (("resident", res), ("offload", off)):
        hist = MetricLogger(1)
        tr.fit(data, max_steps=3, callbacks=[hist])
        losses[name] = hist.history
    assert losses["resident"] == losses["offload"] and len(losses["offload"]) == 3
    assert all(torch.equal(res.lora[n][k], off.lora[n][k]) for n in res.lora for k in ("a", "b"))
    assert len(off.offload_moves) == 2 and not res.offload_moves
    w = next(off.model.conditioner.parameters())
    host = w.data_ptr()
    with off.sampling_frozen():
        assert len(off.offload_moves) == 3
    assert w.data_ptr() == host and w.device.type == "cpu"
    staged = [tr.stage_batch(data[0], step=7) for tr in (res, off)]  # outside fit: the towers placed for it
    assert len(off.offload_moves) == 4
    assert all(torch.equal(a["cond"][k], b["cond"][k]) for a, b in zip(*(s["__conds"] for s in staged))
               for k in a["cond"])


def test_checkpoint_round_trip_and_resume(tmp_path):
    """EMA 0.9, accumulation 2, AdamW: 2 steps, ``save_state``; a fresh
    trainer and ``restore_state`` give back every tensor, the counts, the
    step and the generator bit for bit; one more step on it equals the
    third step of a continuous run bit for bit (LoRA, discriminator, EMA,
    optimizers); ``keep`` prunes the older steps."""
    train_kw = dict(ema_decay=0.9, gradient_accumulation_steps=2)
    data = tiny_batches(3)
    cont = tiny_trainer(train_kw=train_kw)
    cont.fit(data, max_steps=3)
    first = tiny_trainer(train_kw=train_kw)
    first.fit(data[:2], max_steps=2)
    saved = snap(first)
    save_state(str(tmp_path), 1, first.state_dict())
    save_state(str(tmp_path), 2, first.state_dict(), keep=1)
    assert latest_step(str(tmp_path)) == 2 and os.listdir(tmp_path) == ["2"]
    resumed = tiny_trainer(train_kw=train_kw)
    _, step = restore_state(str(tmp_path), resumed)
    assert step == 2
    back = snap(resumed)
    assert saved.keys() == back.keys() and all(torch.equal(saved[k], back[k]) for k in saved)
    resumed.fit(data[2:], max_steps=3)
    a, b = snap(cont), snap(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    assert restore_state(str(tmp_path / "none"))[1] is None


def test_alternating_mode_and_switch_teacher_in_fit():
    """``gan_update_mode="alternating"``: step 1 (``"g"``) moves the LoRA and
    not the discriminator, step 2 (``"d"``) the discriminator and not the
    LoRA. ``switch_teacher`` with K = [2, 4]: entering stage 1 merges the
    LoRA of step 1 into the teacher's weights (as ``merge_lora_into_teacher``
    does), which the student shares."""
    tr = tiny_trainer({"gan_update_mode": "alternating"})
    data = iter(tiny_batches(2))
    s0 = snap(tr)
    tr.fit(data, max_steps=1)
    s1 = snap(tr)
    tr.fit(data, max_steps=2)
    s2 = snap(tr)
    moved = lambda a, b, pre: any(not torch.equal(a[k], b[k]) for k in a if k.startswith(pre))
    assert moved(s0, s1, "lora.") and not moved(s0, s1, "disc.")
    assert moved(s1, s2, "disc.") and not moved(s1, s2, "lora.")
    assert tr.opt_g.count == 1 and tr.opt_d.count == 1

    tr = tiny_trainer({"K": [2, 4], "switch_teacher": True})
    data = iter(tiny_batches(2))
    tr.fit(data, max_steps=1)
    teacher = tr.model.teacher_module
    w0 = {k: v.clone() for k, v in teacher.state_dict().items()}
    want = tiny_trainer({"K": [2, 4]})
    with torch.no_grad():
        want.model.teacher_module.load_state_dict(w0)
    want.model.merge_lora_into_teacher(tr.lora)
    tr.fit(data, max_steps=2)
    merged = want.model.teacher_module.state_dict()
    assert any(not torch.equal(w0[k], merged[k]) for k in w0)
    assert all(torch.equal(teacher.state_dict()[k], merged[k]) for k in w0)
    name = next(iter(tr.lora))
    assert tr.model.student_module.get_submodule(name).weight is teacher.get_submodule(name).weight


# ---------------------------------------------------------------- the run, as phase 10
def write_shards(root, n_shards, per_shard, seed, size=(40, 56)):
    """Tar shards of ``.jpg`` + ``.json`` (``caption``, ``aesthetic_score``:
    every third below 6) from ``seed``; returns their paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths, idx = [], 0
    for s in range(n_shards):
        path = os.path.join(root, f"{s:06d}.tar")
        with tarfile.open(path, "w") as tf:
            for _ in range(per_shard):
                h, w = (int(v) for v in rng.integers(size[0], size[1] + 1, 2))
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
                meta = json.dumps({"caption": f"sample {idx}", "aesthetic_score": 4.0 if idx % 3 == 0 else 6.5})
                for name, data in ((f"{idx:06d}.jpg", buf.getvalue()), (f"{idx:06d}.json", meta.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1
        paths.append(path)
    return paths


def test_sd15_training_run_as_phase_10(monkeypatch, tmp_path):
    """``build_trainer("sd15")`` on tiny modules with ``flash_sd.yaml``
    stage 1 (l2 in place of LPIPS), ``EMA_DECAY`` 0.999, accumulation 2,
    validation and checkpoints every 4 steps, ``build_data`` over 3 JPEG
    shards (thread workers), a ``SampleLogger`` (the yaml's two prompts,
    1 and 2 steps, teacher samples Euler-ancestral CFG 5): after step 1
    nothing trainable moved, after step 2 all of it, with EMA =
    0.999·EMA₀ + 0.001·LoRA; finite validation; every PNG decodes; a
    checkpoint at step 4 that a fresh trainer restores bit for bit, and one
    more step on both gives the same LoRA; the export is the EMA tree."""
    from PIL import Image

    from flash_diffusion_tpu_torch import sample, train
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedderConfig

    monkeypatch.setattr(sample, "sd15_unet_config", lambda **kw: UNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda: AutoencoderKLConfig(**VAE_KW))
    monkeypatch.setattr(sample, "ClipEmbedderConfig", lambda **kw: ClipEmbedderConfig(**kw, text_embedder_config=dict(
        vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=77,
        eos_token_id=49407)))
    shards = write_shards(str(tmp_path), 3, 6, seed=0)
    os.makedirs(tmp_path / "eval", exist_ok=True)
    eval_shard = write_shards(str(tmp_path / "eval"), 1, 4, seed=1)[0]
    cfg = {**train.load_config(train.CONFIGS["sd15"]), "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000],
           "LORA_RANK": 4, "IMAGE_SIZE": 32, "BATCH_SIZE": 2, "DISTILL_LOSS_TYPE": "l2", "EMA_DECAY": 0.999,
           "GRADIENT_ACCUMULATION_STEPS": 2, "VAL_EVERY_N_STEPS": 4, "CKPT_EVERY_N_STEPS": 4,
           "SHARDS_PATH_OR_URLS": [os.path.join(str(tmp_path), "{000000..000002}.tar")], "SHUFFLE_BUFFER_SIZE": 4}
    trainer = train.build_trainer("sd15", device="cpu", config=cfg)
    assert trainer.model.teacher_sampling_sched_mod is REGISTRY["EulerAncestralDiscreteScheduler"]
    tok = train.make_tokenizer("sd15", cfg)
    data = train.tokenize_batches(train.build_data(cfg, num_workers=2), tok, "sd15", 32)
    eval_pipe = train.build_data({**cfg, "SHARDS_PATH_OR_URLS": [eval_shard]}, num_workers=1)
    eval_data = lambda: train.tokenize_batches(eval_pipe.batches(epoch=0), tok, "sd15", 32)
    prompts = cfg["VALIDATION_PROMPTS"]
    logger = SampleLogger(lambda: {"text": prompts, **tok(prompts)}, (16, 16, 4), out_dir=str(tmp_path / "samples"),
                          every_n_steps=4, num_steps=[1, 2], log_teacher_samples=True)
    ckpt = str(tmp_path / "ckpt")
    callbacks = [MetricLogger(1), CheckpointCallback(ckpt, 4), logger]
    s0 = snap(trainer)
    trainer.fit(data, max_steps=1, callbacks=callbacks, eval_data=eval_data)
    s1 = snap(trainer)
    assert all(torch.equal(s0[k], s1[k]) for k in s0 if k.startswith(("lora.", "disc.", "ema.")))
    trainer.fit(data, max_steps=2, callbacks=callbacks, eval_data=eval_data)
    s2 = snap(trainer)
    for pre in ("lora.", "disc.", "ema."):
        assert any(not torch.equal(s1[k], s2[k]) for k in s1 if k.startswith(pre)), pre
    for n, ab in trainer.ema.items():
        for k, e in ab.items():
            want = (s1[f"ema.{n}.{k}"] * 0.999 + trainer.lora[n][k].detach() * (1.0 - 0.999))
            assert torch.equal(e, want)
    trainer.fit(data, max_steps=4, callbacks=callbacks, eval_data=eval_data)
    assert trainer.last_val and all(np.isfinite(v) for v in trainer.last_val.values())
    assert len([p for p in logger.written if p.endswith(".png")]) == 4
    for p in logger.written:
        if p.endswith(".png"):
            assert np.isfinite(np.asarray(Image.open(p), np.float32)).all()
    assert latest_step(ckpt) == 4 and trainer.data_wait_s > 0
    resumed = train.build_trainer("sd15", device="cpu", config=cfg)
    restore_state(ckpt, resumed)
    a, b = snap(trainer), snap(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a)
    batch = next(iter(data))
    for tr in (trainer, resumed):
        tr.fit([batch], max_steps=5)
    assert all(torch.equal(trainer.lora[n][k], resumed.lora[n][k]) for n in trainer.lora for k in ("a", "b"))
    assert export_lora(trainer) is trainer.ema
