"""The port's SDXL Flash distillation step against the JAX package.

- DPM-Solver++ 2M (``schedulers/dpm.py``): the tables of ``set_timesteps``
  to 1e-6, and a whole trajectory against JAX ``dpm.step`` and the
  diffusers-semantics golden port (``tests/golden/diffusers_port.py``) to
  1e-4, as ``tests/test_scheduler_golden.py`` holds the JAX one;
- ``FlashDiffusion._teacher_rollout`` with the DPM teacher against the JAX
  one from every kind of start position (0, 1, K − 2, K − 1 at K = 4): the
  multistep carry restarts at each rollout, so the first executed step is
  first order wherever it enters, to 1e-4;
- one ``losses`` and backward of a tiny SDXL-shaped ``FlashDiffusion`` (the
  UNet, VAE and text towers of ``tests/test_torch_pipeline.py``'s SDXL
  stack; DPM teacher, K = [4], l2 distill, DMD, lsgan, ``crossattn`` and
  ``vector`` conditioning, a discriminator over the UNet's mid features)
  against ``jax.value_and_grad(FlashDiffusion.losses)``, with the draws
  made from a JAX key whose start index lets a second-order step run, to
  1e-4 (``tests/test_torch_train.py`` holds SD1.5 so); the same step
  (``build_sdxl_step``) on a non-square bucket's latent with the real size
  tuples' embeddings, and with a conv LoRA pair on a resnet conv (JAX's
  merged-weights path; the port's parametrized weights under ``remat``);
- ``build_trainer("sdxl")`` on ``flash_sdxl.yaml`` with tiny modules, one
  ``fit`` step of it, ``synthetic_batches``' size keys and the LoRA tree's
  names against JAX ``lora_paths``.

fp32 on both sides; JAX params carried by ``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import train
from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig, FlashDiffusion
from flash_diffusion_tpu_torch.distill import FlashDiffusionConfig
from flash_diffusion_tpu_torch.lora import init_lora, lora_paths, lora_scaling
from flash_diffusion_tpu_torch.models import AutoencoderKLConfig, UNet2DCondition, UNetConfig
from flash_diffusion_tpu_torch.models.embedders import ClipEmbedderConfig
from flash_diffusion_tpu_torch.sample import SIZE_KEYS
from flash_diffusion_tpu_torch.schedulers import REGISTRY, SchedulerConfig, dpm
from flash_diffusion_tpu_torch.utils import discriminator_from_jax, lora_from_jax, unet_from_jax
from flash_diffusion_tpu_torch.utils.convert import lora_path_to_port
from golden.diffusers_port import GoldenDPMSolverMultistep
from test_torch_pipeline import CLIP_KW, SDXL_UNET_KW, SIZE_CHANNELS, VAE_KW
from test_torch_train import close, jax_step_draws, perturbed, t_

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill import common as jcommon
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.schedulers import SchedulerConfig as JSchedulerConfig
    from flash_diffusion_tpu.schedulers import dpm as jdpm
except ImportError:
    jax = None

torch.set_num_threads(2)

B, HW, C, TOKENS = 2, 16, 4, 16
# the tiny SDXL-shaped UNet: crossattn 64 wide, vector 72 (mid features
# [B, 8, 8, 128] at 16² latents)
COND_W, VEC_W, MID_C = 64, 72, 128
K = 4
DPM = "DPMSolverMultistepScheduler"


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def _conds(seed):
    """(cond, student_cond, uncond) of the SDXL stack: crossattn (the two
    towers' text states) and vector (bigG's pooled projection, then the
    size embeddings); the uncond drops both towers (crossattn and the pooled
    part zero), as ``USE_EMPTY_PROMPT: false`` makes it."""
    rng = np.random.default_rng(seed)
    out = [{"crossattn": rng.standard_normal((B, TOKENS, COND_W)).astype(np.float32),
            "vector": rng.standard_normal((B, VEC_W)).astype(np.float32)} for _ in range(3)]
    out[2]["crossattn"][:] = 0.0
    out[2]["vector"][:, :24] = 0.0
    out[2]["vector"][:, 24:] = out[0]["vector"][:, 24:]
    return out


@pytest.fixture(scope="module")
def sdxl_unet(jax_ref):
    """The tiny SDXL-shaped UNet in JAX (perturbed params) and the port."""
    net = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    cond = {"cond": {"crossattn": jnp.zeros((1, TOKENS, COND_W)), "vector": jnp.zeros((1, VEC_W))}}
    params = perturbed(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)), cond),
                       1)
    cfg = UNetConfig(**SDXL_UNET_KW, use_linear_projection=True)
    unet = UNet2DCondition(cfg)
    unet.load_state_dict(unet_from_jax(params, cfg))
    return net, params, unet.eval().requires_grad_(False)


# ---------------------------------------------------------------- DPM
@pytest.mark.parametrize("n", [4, 32])
def test_dpm_tables_match_jax(jax_ref, n):
    """``set_timesteps``' fp32 tables against JAX's, to 1e-6."""
    got, want = dpm.set_timesteps(SchedulerConfig(), n), jdpm.set_timesteps(JSchedulerConfig(), n)
    assert got.timesteps == [int(t) for t in np.asarray(want.timesteps)]
    assert got.num_inference_steps == want.num_inference_steps == n
    assert got.init_noise_sigma == float(want.init_noise_sigma) == 1.0
    for name in ("alphas_cumprod", "sigmas", "alpha_t", "sigma_t", "lambda_t"):
        t = getattr(got, name)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(want, name)), atol=1e-6, rtol=0, err_msg=name)
    assert float(got.sigma_t[-1]) == 0.0 and float(got.lambda_t[-1]) == pytest.approx(23.02585, rel=1e-6)


def _pred(x):
    """The deterministic fake denoiser of tests/test_scheduler_golden.py."""
    return 0.3 * x + 0.05


@pytest.mark.parametrize("n", [4, 32])
def test_dpm_trajectory_matches_jax_and_diffusers(jax_ref, n):
    """A whole DPM++2M trajectory (first-order warm-up, midpoint D1,
    lower_order_final) step by step against JAX ``dpm.step`` and the golden
    diffusers port, to 1e-4."""
    sched, jsched = dpm.set_timesteps(SchedulerConfig(), n), jdpm.set_timesteps(JSchedulerConfig(), n)
    gold = GoldenDPMSolverMultistep()
    gold.set_timesteps(n)
    start = np.linspace(-1.0, 1.0, 64).reshape(1, 4, 4, 4)
    s, s_j, s_g = torch.tensor(start, dtype=torch.float32), jnp.asarray(start, jnp.float32), start
    state, jstate = dpm.init_state(s), jdpm.init_state(s_j)
    assert state[1] is False and not state[0].any()
    for i in range(n):
        s, state = dpm.step(sched, _pred(s), i, s, state)
        s_j, jstate = jdpm.step(jsched, _pred(s_j), jnp.int32(i), s_j, jstate)
        s_g = gold.step(_pred(s_g), s_g)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-4, rtol=1e-4, err_msg=f"JAX, step {i}")
        np.testing.assert_allclose(s.numpy(), s_g, atol=1e-4, rtol=1e-4, err_msg=f"diffusers, step {i}")
        np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]), atol=1e-4, rtol=1e-4)
        assert state[1] is True


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_dpm_convert_model_output_matches_jax(jax_ref, prediction_type):
    """x̂₀ from each prediction type against JAX ``convert_model_output``."""
    sched = dpm.set_timesteps(SchedulerConfig(prediction_type=prediction_type), 8)
    jsched = jdpm.set_timesteps(JSchedulerConfig(prediction_type=prediction_type), 8)
    rng = np.random.default_rng(3)
    x, out = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    for i in (0, 3, 7):
        got = dpm.convert_model_output(sched, torch.tensor(out), i, torch.tensor(x))
        want = jdpm.convert_model_output(jsched, jnp.asarray(out), jnp.int32(i), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("setting", [
    {"solver_order": 1}, {"solver_order": 3}, {"lower_order_final": False}, {"euler_at_final": True},
    {"final_sigmas_type": "sigma_max"},
])
def test_dpm_refuses_settings_it_does_not_implement(setting):
    """Only the 2M solver with a first-order last step is implemented, as in
    JAX: another DPM setting raises instead of being ignored."""
    with pytest.raises(ValueError):
        dpm.set_timesteps(SchedulerConfig(**setting), 4)


def test_registry_resolves_the_sdxl_teacher():
    assert REGISTRY[DPM] is dpm
    assert {"init_state", "set_timesteps", "scale_model_input", "step"} <= set(dir(dpm))


# ---------------------------------------------------------------- rollout
def _flash_kw(**kw):
    return dict(K=[K], num_iterations_per_K=[4], guidance_scale_min=1.0, guidance_scale_max=3.0,
                mixture_num_components=4, mode_probs=[[0.25] * 4], **kw)


@pytest.fixture(scope="module")
def rollouts(sdxl_unet):
    """The DPM teacher rollout in both packages over one (cond, uncond,
    guidance); JAX's jitted once with the start index traced."""
    net, params, unet = sdxl_unet
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**_flash_kw()), student_module=net, teacher_module=net,
                             teacher_scheduler=DPM)
    tmodel = FlashDiffusion(FlashDiffusionConfig(**_flash_kw()), unet, teacher_scheduler=DPM)
    cond, _, uncond = _conds(12)
    guidance = 2.5
    jcond, juncond = ({"cond": {k: jnp.asarray(v) for k, v in c.items()}} for c in (cond, uncond))
    jfn = jax.jit(lambda x, start: jmodel._teacher_rollout(
        {"teacher": params}, x, start, jcond, juncond, None, jnp.float32(guidance), 0, jax.random.PRNGKey(0)))
    tcond, tuncond = ({"cond": {k: t_(v) for k, v in c.items()}} for c in (cond, uncond))
    tfn = lambda x, start: tmodel._teacher_rollout(x, start, tcond, tuncond, torch.tensor(guidance), 0, [])
    return tmodel, jfn, tfn


@pytest.mark.parametrize("start_idx", [0, 1, K - 2, K - 1])
def test_dpm_teacher_rollout_matches_jax(rollouts, start_idx):
    """The DPM teacher's 2B-batched CFG rollout from ``start_idx`` against
    the JAX ``_teacher_rollout`` on the same weights and inputs, to 1e-4
    absolute and relative (a fresh carry each time: the first executed step is first order); a
    DPM rollout draws no rollout noise."""
    tmodel, jfn, tfn = rollouts
    assert tmodel._sched_has_carry and not tmodel._sched_stochastic
    noisy = np.random.default_rng(11 + start_idx).standard_normal((B, HW, HW, C)).astype(np.float32)
    want = jfn(jnp.asarray(noisy), jnp.int32(start_idx))
    # |x| reaches ~40 here (x̂₀ of the perturbed UNet at t = 999 over α ≈ 0.068): 1e-4 absolute and relative
    np.testing.assert_allclose(tfn(t_(noisy), start_idx).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                               err_msg=f"rollout from {start_idx}")
    assert tmodel.draw(torch.Generator().manual_seed(0), 0, t_(noisy))["rollout_noise"] == []


# ---------------------------------------------------------------- the step
def build_sdxl_step(sdxl_unet, hw=(HW, HW), targets=None, size_part=None, remat=False):
    """The tiny SDXL FlashDiffusion in both packages (DPM teacher, K = [4],
    l2 distill (the LPIPS one is held in tests/test_torch_train.py), DMD,
    lsgan, a one-stage discriminator over the mid features), perturbed
    weights, a non-zero LoRA B, pre-staged ``__z``/``__conds``, and a JAX key
    whose start index is 1: its rollout runs a first-order, a second-order
    and the final step. ``hw``: the latent's (h, w); ``targets``: JAX
    ``init_lora``'s (a conv target gives the merged-weights path);
    ``size_part``: the conditioning vector's size embeddings [B, 48] (the
    three SDXL size tuples'), else random; ``remat``: the port's UNet
    recomputes its blocks in the backward."""
    net, uparams, unet = sdxl_unet
    h, w = hw
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=1))
    dparams = perturbed(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((B, h // 2, w // 2, MID_C))), 4)
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5), *([targets] if targets else [])), 6)
    kw = _flash_kw(distill_loss_type="l2", use_dmd_loss=True, gan_loss_type="lsgan", adversarial_loss_scale=0.5,
                   dmd_loss_scale=0.3)
    frozen = {"teacher": uparams}
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**kw), student_module=net, teacher_module=net,
                             teacher_scheduler=DPM, discriminator=jdisc, lora_scaling=0.5)
    z = np.random.default_rng(18).standard_normal((B, h, w, C)).astype(np.float32)
    conds = _conds(19)
    if size_part is not None:
        for c in conds:
            c["vector"][:, 24:] = size_part
    stage = 0
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if int(jcommon.sample_start_index(jax.random.split(k, 8)[3], jmodel.stage_pdfs[stage])) == 1)
    jbatch = {"__z": jnp.asarray(z), "__conds": tuple({"cond": {k: jnp.asarray(v) for k, v in c.items()}}
                                                      for c in conds)}
    loss_fn = lambda tr: jmodel.losses(tr, frozen, jbatch, key, stage)
    trainable = {"lora": lora, "disc": dparams}
    # compiled without XLA's backend optimizations: a quarter less compile
    # time, the same arithmetic
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(trainable).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    (total, aux), grads = step(trainable)

    ucfg = unet.config
    if remat:
        unet = UNet2DCondition(UNetConfig(**SDXL_UNET_KW, use_linear_projection=True, remat=True))
        unet.load_state_dict(unet_from_jax(uparams, ucfg))
        unet.requires_grad_(False)
    dcfg = DiscriminatorConfig(feature_dim=8, num_stages=1)
    disc = ConvDiscriminator(dcfg, in_channels=MID_C)
    disc.load_state_dict(discriminator_from_jax(dparams, dcfg))
    tmodel = FlashDiffusion(FlashDiffusionConfig(**kw), unet, teacher_scheduler=DPM, discriminator=disc,
                            lora_scaling=0.5)
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()} for k, ab in lora_from_jax(lora, ucfg).items()}
    tmodel.attach_lora(tl)
    tbatch = {"__z": t_(z), "__conds": tuple({"cond": {k: t_(v) for k, v in c.items()}} for c in conds)}
    draws = jax_step_draws(jmodel, key, stage, z)
    want = dict(total=total, aux=aux, lora=lora_from_jax(grads["lora"], ucfg),
                disc=discriminator_from_jax(grads["disc"], dcfg))
    return tmodel, tl, tbatch, draws, stage, want


def check_sdxl_step(step):
    """``losses`` and the LoRA and discriminator gradients of one backward
    of a ``build_sdxl_step`` vs JAX's, to 1e-4."""
    tmodel, tl, batch, draws, stage, want = step
    assert draws["start_idx"] == 1 and not tmodel._sched_stochastic
    total, aux = tmodel.losses(batch, draws, stage)
    total.backward()
    close(total, want["total"], 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator", "guidance"):
        close(aux[k], want["aux"][k], 1e-4, k)
    assert aux["start_timestep"] == int(want["aux"]["start_timestep"]) == tmodel.stage_schedules[0].timesteps[1]
    for name, ab in tl.items():
        for k in ("a", "b"):
            close(ab[k].grad, want["lora"][name][k], 1e-4, f"{name}.{k}")
    for name, p in tmodel.discriminator.named_parameters():
        close(p.grad, want["disc"][name], 1e-4, name)


@pytest.fixture(scope="module")
def sdxl_step(sdxl_unet):
    """``build_sdxl_step`` at the square 16² latent."""
    return build_sdxl_step(sdxl_unet)


# a 128 × 192 bucket's latent, its image cut from a 300 × 450 original at
# (top, left) = (10, 4), as ``BucketAssignMapper`` emits the tuples
BUCKET_HW, BUCKET_TUPLES = (16, 24), {"original_size_as_tuple": (300, 450), "crop_coords_top_left": (10, 4),
                                       "target_size_as_tuple": (128, 192)}


def test_sdxl_flash_step_losses_and_grads_match_jax(sdxl_step):
    """``losses`` and the LoRA and discriminator gradients of one backward
    vs ``jax.value_and_grad(FlashDiffusion.losses)``, DPM teacher from
    start index 1 (no rollout noise drawn). Tolerance 1e-4."""
    check_sdxl_step(sdxl_step)


def size_embeddings(tuples):
    """The three SDXL size keys' sinusoidal embeddings ([B, 48]: 2 values ×
    ``SIZE_CHANNELS`` each) through the port's ``TimestepsEmbedder`` and the
    JAX one, which must agree."""
    from flash_diffusion_tpu.models.embedders import TimestepsEmbedder as JEmbedder
    from flash_diffusion_tpu.models.embedders import TimestepsEmbedderConfig as JEmbedderConfig
    from flash_diffusion_tpu_torch.models.embedders import TimestepsEmbedder, TimestepsEmbedderConfig

    got, want = [], []
    for key in SIZE_KEYS:
        batch = {key: np.tile(np.asarray(tuples[key], np.float32), (B, 1))}
        port = TimestepsEmbedder(TimestepsEmbedderConfig(input_key=key, num_channels=SIZE_CHANNELS))
        jemb = JEmbedder(JEmbedderConfig(input_key=key, num_channels=SIZE_CHANNELS))
        got.append(port.embed(batch)["vector"].numpy())
        want.append(np.asarray(jemb.embed({}, batch)["vector"]))
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1), atol=1e-6)
    return np.concatenate(want, 1)


def test_sdxl_flash_step_on_a_non_square_bucket_matches_jax(sdxl_unet):
    """The step of ``test_sdxl_flash_step_losses_and_grads_match_jax`` on a
    non-square bucket's 16 × 24 latent (mid features 8 × 12, a transposed
    token reshape would show), its conditioning vector carrying the
    bucket's real size tuples: losses and gradients to 1e-4."""
    step = build_sdxl_step(sdxl_unet, hw=BUCKET_HW, size_part=size_embeddings(BUCKET_TUPLES))
    assert step[2]["__z"].shape[1:3] == BUCKET_HW
    check_sdxl_step(step)


def test_sdxl_flash_step_with_a_conv_pair_matches_jax(sdxl_unet):
    """The step with a LoRA pair on a resnet's 3×3 convolution besides the
    default targets: JAX merges the whole tree into the weights
    (``lora_is_dense_only`` is False), the port's student reads merged
    weights through a parametrization, here under ``remat`` (the backward
    recomputes each block and must see the same merged weight): losses and
    gradients, the conv pair's included, to 1e-4; the teacher's weights
    untouched."""
    targets = (*jlora.DEFAULT_TARGETS, r".*down_0_resnet_0/conv1/kernel$")
    step = build_sdxl_step(sdxl_unet, targets=targets, remat=True)
    tmodel, tl = step[0], step[1]
    conv = "down_blocks.0.resnets.0.conv1"
    assert tl[conv]["a"].shape == (3, 3, 32, 2) and tl[conv]["b"].shape == (2, 32)
    before = tmodel.teacher_module.get_submodule(conv).weight.clone()
    check_sdxl_step(step)
    assert torch.equal(tmodel.teacher_module.get_submodule(conv).weight, before)
    assert tmodel.teacher_module.get_submodule(conv).weight.grad is None


def test_sdxl_lora_tree_maps_one_to_one_onto_jax_lora_paths(sdxl_unet):
    """JAX ``lora_paths`` of the tiny SDXL UNet and the port's (linear
    projections, depth 2 at level 1) name the same layers."""
    _, params, unet = sdxl_unet
    jpaths = jlora.lora_paths(params)
    mapped = [lora_path_to_port(p, unet.config) for p in jpaths]
    assert len(set(mapped)) == len(jpaths) and set(mapped) == set(lora_paths(unet))
    assert any(".transformer_blocks.1." in name for name in mapped)
    lora = init_lora(unet, 4, torch.Generator().manual_seed(0))
    assert set(lora) == set(mapped)


# ---------------------------------------------------------------- build_trainer
def tiny_sdxl_modules(monkeypatch):
    """``sample``'s SDXL configs replaced by tiny ones: the SDXL-shaped UNet
    (crossattn 32 = two 16-wide towers; vector 24 + the three 512-wide size
    embeddings), the tiny VAE, CLIP towers of 16 with bigG's projection 24."""
    from flash_diffusion_tpu_torch import sample

    unet_kw = dict(SDXL_UNET_KW, cross_attention_dim=32, projection_class_embeddings_input_dim=24 + 3 * 512)
    monkeypatch.setattr(sample, "sdxl_unet_config", lambda **kw: UNetConfig(**unet_kw, use_linear_projection=True,
                                                                             **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda **kw: AutoencoderKLConfig(**VAE_KW, **kw))

    def clip_config(**kw):
        tiny = dict(CLIP_KW, vocab_size=49408, hidden_size=16, intermediate_size=32, max_positions=77,
                    eos_token_id=49407)
        if kw.get("use_projection"):
            tiny.update(hidden_act="gelu", projection_dim=24)
        return ClipEmbedderConfig(**{**kw, "text_embedder_config": tiny})

    monkeypatch.setattr(sample, "ClipEmbedderConfig", clip_config)


def test_build_trainer_reads_flash_sdxl_yaml(monkeypatch):
    """``build_trainer("sdxl")`` maps ``flash_sdxl.yaml`` onto the model: DPM
    teacher with its carry, lsgan, the uncond dropping both CLIP towers, the
    DMD and adversarial scales, the mode probabilities, a 256-feature
    discriminator of 3 stages (1024² / 32 = 32² mid features) over the UNet's
    last level, the VAE's SDXL scaling factor, the five conditioners, the
    UNet's ``remat``, frozen modules in bf16; and refuses a model whose
    training is not ported."""
    import yaml

    tiny_sdxl_modules(monkeypatch)
    with open(train.CONFIGS["sdxl"]) as f:
        want = yaml.safe_load(f)
    trainer = train.build_trainer("sdxl", device="cpu", config={**want, "LORA_RANK": 4})
    model, mc = trainer.model, trainer.model.config
    assert (mc.K, mc.num_iterations_per_K, mc.mode_probs) == (want["K"], want["NUM_ITERATIONS_PER_K"],
                                                              want["MODE_PROBS"])
    assert (mc.distill_loss_scale, mc.dmd_loss_scale, mc.adversarial_loss_scale) == (
        want["DISTILL_LOSS_SCALE"], want["DMD_LOSS_SCALE"], want["ADVERSARIAL_LOSS_SCALE"])
    assert (mc.distill_loss_type, mc.gan_loss_type, mc.use_dmd_loss, mc.use_empty_prompt) == (
        "lpips", "lsgan", True, False)
    assert (mc.guidance_scale_min, mc.guidance_scale_max) == ([3.0] * 4, [13.0] * 4)
    assert model.teacher_sched_mod is dpm and model._sched_has_carry and not model._sched_stochastic
    assert isinstance(model.stage_schedules[0], dpm.DPMSchedule)
    assert model.discriminator.config.feature_dim == 256 and model.discriminator.config.num_stages == 3
    assert model.discriminator.conv_0.in_channels == MID_C
    assert model.vae.config.scaling_factor == 0.13025
    assert [c.input_key for c in model.conditioner.conditioners] == ["text", "text", *SIZE_KEYS]
    assert model.teacher_module.config.remat and model.lora_scaling == lora_scaling(4)
    assert trainer.opt_g.lr == trainer.opt_d.lr == float(want["LR"])
    assert all(ab["a"].shape[1] == 4 for ab in trainer.lora.values())
    assert model.teacher_module.conv_in.weight.dtype == torch.bfloat16
    assert "canny_adapter" not in train.MODELS  # the T2I-Adapter family is not ported
    with pytest.raises(ValueError):
        train.build_trainer("canny_adapter", device="cpu")


def test_build_trainer_fills_what_the_yaml_leaves_out(monkeypatch):
    """A yaml without the image size, LoRA rank, empty-prompt flag and
    teacher scheduler takes the JAX SDXL example's: 1024² (3 discriminator
    stages), rank 64, the uncond dropping the towers, the DPM teacher."""
    tiny_sdxl_modules(monkeypatch)
    cfg = train.load_config(train.CONFIGS["sdxl"])
    for key in ("IMAGE_SIZE", "LORA_RANK", "USE_EMPTY_PROMPT", "TEACHER_SCHEDULER"):
        del cfg[key]
    model = train.build_trainer("sdxl", device="cpu", config=cfg).model
    assert model.discriminator.config.num_stages == 3 and model.lora_scaling == lora_scaling(64)
    assert not model.config.use_empty_prompt and model.teacher_sched_mod is dpm


def test_sdxl_trainer_steps_on_tiny_modules(monkeypatch):
    """One ``fit`` step of ``build_trainer("sdxl")`` (``flash_sdxl.yaml`` at
    32², stage 1, tiny modules) on ``synthetic_batches(model="sdxl")``:
    finite losses, every LoRA B factor and the discriminator changed, the
    teacher, VAE and both text towers bit-identical."""
    tiny_sdxl_modules(monkeypatch)
    cfg = {**train.load_config(train.CONFIGS["sdxl"]), "LORA_RANK": 4, "IMAGE_SIZE": 32,
           "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
    trainer = train.build_trainer("sdxl", device="cpu", config=cfg)
    model = trainer.model
    snap = lambda ms: [t.detach().clone() for m in ms for t in m.state_dict().values()]
    frozen_modules = (model.teacher_module, model.vae, model.conditioner)
    frozen, disc = snap(frozen_modules), snap([model.discriminator])
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    aux = trainer.fit(train.synthetic_batches(2, 32, model="sdxl"), max_steps=1)
    assert trainer.step == 1 and model.stage_for_iteration(1) == 1
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items())
    assert not all(torch.equal(a, b) for a, b in zip(disc, snap([model.discriminator])))
    assert all(torch.equal(a, b) for a, b in zip(frozen, snap(frozen_modules)))


def test_synthetic_batches_carry_the_size_keys():
    """``model="sdxl"`` adds ``size_cond_fn``'s three tuples: original and
    target size (H, W), crop (0, 0); SD1.5 batches have none."""
    batch = next(train.synthetic_batches(2, 64, seed=1, model="sdxl"))
    assert batch["image"].shape == (2, 64, 64, 3) and batch["text_ids"].shape == (2, 77)
    np.testing.assert_array_equal(batch["original_size_as_tuple"], [[64, 64]] * 2)
    np.testing.assert_array_equal(batch["target_size_as_tuple"], [[64, 64]] * 2)
    np.testing.assert_array_equal(batch["crop_coords_top_left"], np.zeros((2, 2)))
    assert all(batch[k].dtype == np.float32 for k in SIZE_KEYS)
    assert not set(SIZE_KEYS) & set(next(train.synthetic_batches(2, 64, seed=1)))
