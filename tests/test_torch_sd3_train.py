"""The port's SD3 Flash distillation step (rectified flow) against the JAX package.

- the step's tables against JAX's ``FlashDiffusionSD3`` at shift 3: the
  stage schedules (float σ·T timesteps, sigmas with the terminal 0), the
  full 1000-step ``full_schedule``, and the GAN's tail timesteps and sigmas
  (``sigmas[-i − 1]`` beside ``timesteps[-i]``), all bit-equal in fp32;
- one ``losses`` and backward of a tiny SD3-shaped ``FlashDiffusionSD3``
  (an MMDiT of depth 2 over 16×16×16 latents and 32 context tokens: a joint
  sequence of 96 padded to 128 and masked at ``kv_valid`` 96; K = [4, 4] at
  stage 1: l2 distill, DMD 0.3, lsgan 0.1 over the post-mid features
  through a 2-stage discriminator; a non-zero LoRA B) against
  ``jax.value_and_grad(FlashDiffusionSD3.losses)``, from start index 0 (pure
  noise) and 2 (the σ-interpolation), every draw injected from the JAX key
  (``test_torch_train.jax_step_draws``), the LoRA and discriminator
  gradients to 1e-4 of max(1, max|want|); the JAX attention runs as its own
  CPU tests run it;
- the MMDiT's ``remat``: the same forward and gradients as without it;
- ``build_trainer("sd3")`` on ``flash_sd3.yaml`` with tiny modules (the
  MMDiT, the SD3 VAE, both CLIP towers and T5 monkeypatched in ``sample``),
  with and without T5, one ``fit`` step of it, and
  ``synthetic_batches(model="sd3")``'s keys and shapes.

fp32 on both sides; JAX params carried by ``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import train
from flash_diffusion_tpu_torch.distill import (
    ConvDiscriminator,
    DiscriminatorConfig,
    FlashDiffusionSD3,
    FlashDiffusionSD3Config,
)
from flash_diffusion_tpu_torch.lora import init_lora, lora_scaling
from flash_diffusion_tpu_torch.models import MMDiT, MMDiTConfig
from flash_diffusion_tpu_torch.models.embedders import ClipEmbedder, SD3Conditioner, T5AsSD3Embedder
from flash_diffusion_tpu_torch.schedulers import flow_match
from flash_diffusion_tpu_torch.utils import discriminator_from_jax, lora_from_jax, mmdit_from_jax
import torch_parallel_workers as W
from test_torch_train import check_merge_step, jax_step_draws, perturbed, t_

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.distill import FlashDiffusionSD3 as JFlashDiffusionSD3
    from flash_diffusion_tpu.distill import FlashDiffusionSD3Config as JFlashDiffusionSD3Config
    from flash_diffusion_tpu.distill import common as jcommon
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.models import mmdit as jmmdit
except ImportError:
    jax = None

torch.set_num_threads(2)

B, HW, C, CTX, JOINT_DIM, POOLED = 2, 16, 16, 32, 96, 48
# SD3-shaped at tiny width: 16 latent channels, patch 2, depth 2 (the post-mid
# tap after block 0, the last block context_pre_only), 2 heads of 32; 64
# image + 32 context tokens: a joint sequence of 96, padded to 128
MMDIT_KW = dict(in_channels=C, out_channels=C, patch_size=2, hidden_size=64, depth=2, num_heads=2,
                joint_attention_dim=JOINT_DIM, pooled_projection_dim=POOLED, pos_embed_max_size=16, sample_size=8)
K = 4


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def close(got, want, tol, msg=""):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), want,
                               atol=tol * max(1.0, float(np.abs(want).max())), rtol=0, err_msg=msg)


def _flash_kw():
    """Stage 1 of two: distill 1.0, DMD 0.3, adversarial 0.1, as
    ``flash_sd3.yaml``'s stage 1; l2, lsgan."""
    return dict(K=[K, K], num_iterations_per_K=[2, 2], guidance_scale_min=3.0, guidance_scale_max=7.0,
                distill_loss_type="l2", mixture_num_components=4, use_dmd_loss=True, gan_loss_type="lsgan",
                distill_loss_scale=1.0, dmd_loss_scale=[0.0, 0.3], adversarial_loss_scale=[0.0, 0.1])


def _cond_np(seed, zero=False):
    rng = np.random.default_rng(seed)
    cond = {"crossattn": rng.standard_normal((B, CTX, JOINT_DIM)).astype(np.float32),
            "vector": rng.standard_normal((B, POOLED)).astype(np.float32)}
    if zero:  # the uncond: every text key dropped
        cond = {k: np.zeros_like(v) for k, v in cond.items()}
    return cond


# ---------------------------------------------------------------- the tables
@pytest.mark.parametrize("k", [4, 32])
def test_sd3_step_tables_match_jax(jax_ref, k):
    """At shift 3: the stage schedules (float σ·T timesteps and n + 1 sigmas
    ending in 0), the full 1000-step schedule and the GAN's tail timesteps
    and sigmas equal JAX's bit for bit; the tail sigma of ``timesteps[-i]``
    is ``sigmas[-i − 1]`` (``sigmas[-i]`` would be the next step's, off by
    one with no error); the start-index pdfs are JAX's."""
    kw = dict(_flash_kw(), K=[k, k], mixture_num_components=4)
    jmodel = JFlashDiffusionSD3(JFlashDiffusionSD3Config(**kw), student_module=None,
                                teacher_module=jm.MMDiT(jmmdit.MMDiTConfig(**MMDIT_KW)))
    model = FlashDiffusionSD3(FlashDiffusionSD3Config(**kw), MMDiT(MMDiTConfig(**MMDIT_KW)))
    assert model.sched_config.shift == 3.0 and model.teacher_sched_mod is flow_match
    for got, want in zip(model.stage_schedules, jmodel.stage_schedules):
        np.testing.assert_array_equal(np.asarray(got.timesteps, np.float32), np.asarray(want.timesteps))
        np.testing.assert_array_equal(np.asarray(got.sigmas, np.float32), np.asarray(want.sigmas))
        assert len(got.sigmas) == k + 1 and got.sigmas[-1] == 0.0 and got.sigmas[0] == 1.0
        assert got.timesteps[1] != round(got.timesteps[1])  # float timesteps, never cast
    for got, want in zip(model.stage_pdfs, jmodel.stage_pdfs):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(model.full_timesteps.numpy(), np.asarray(jmodel.full_schedule.timesteps))
    np.testing.assert_array_equal(model.full_sigmas.numpy(), np.asarray(jmodel.full_schedule.sigmas))
    assert model.full_timesteps.shape == (1000,) and model.full_sigmas.shape == (1001,)
    np.testing.assert_array_equal(model.gan_ts.numpy(), np.asarray(jmodel.gan_ts))
    np.testing.assert_array_equal(model.gan_sigmas.numpy(), np.asarray(jmodel.gan_sigmas))
    tail = np.asarray(model.config.gan_tail_indices)
    np.testing.assert_array_equal(model.gan_sigmas.numpy(), model.full_sigmas.numpy()[-tail - 1])
    np.testing.assert_allclose(model.gan_sigmas.numpy(), model.gan_ts.numpy() / 1000, rtol=1e-6)
    assert not np.array_equal(model.gan_sigmas.numpy(), model.full_sigmas.numpy()[-tail])


# ---------------------------------------------------------------- the MMDiT's remat
def test_mmdit_remat_gives_the_same_forward_and_gradients():
    """``remat`` recomputes each joint block in the backward: the output, the
    post-mid features and the gradients of the input and of every LoRA
    factor are bit-equal to the plain module's at a masked joint length."""
    torch.manual_seed(0)
    plain = MMDiT(MMDiTConfig(**MMDIT_KW)).requires_grad_(False)
    rematted = MMDiT(MMDiTConfig(**MMDIT_KW, remat=True)).requires_grad_(False)
    rematted.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(1)
    lora = init_lora(plain, 3, g)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.1
    x = torch.randn(B, HW, HW, C, generator=g)
    t = torch.tensor([912.5, 250.0])
    cond = {"cond": {k: t_(v) for k, v in _cond_np(2).items()}}
    w, wf = (torch.randn(B, HW, HW, C, generator=g) for _ in range(2))
    grads = []
    for net in (plain, rematted):
        pairs = {k: {n: v.clone().requires_grad_() for n, v in ab.items()} for k, ab in lora.items()}
        for name, ab in pairs.items():
            net.get_submodule(name).lora = (ab["a"], ab["b"], 0.5)
        xi = x.clone().requires_grad_()
        out, feats = net(xi, t, cond, return_features="post_mid")
        ((out * w).sum() + (feats * wf).sum()).backward()
        grads.append((out.detach(), xi.grad, [ab[k].grad for ab in pairs.values() for k in ("a", "b")]))
    (o1, x1, l1), (o2, x2, l2) = grads
    assert torch.equal(o1, o2) and torch.equal(x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(l1, l2)) and len(l1) == 2 * len(lora) and x1.abs().sum() > 0
    with torch.no_grad():
        assert torch.equal(rematted(x, t, cond), o1)


# ---------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def sd3_jax(jax_ref):
    """The tiny JAX SD3 step's modules and trees, built once: the MMDiT with
    perturbed params, a 2-stage 8-feature discriminator over its 16-channel
    post-mid features, a LoRA with a non-zero B, staged ``__z`` and
    ``__conds`` (the uncond zeroes every text stream)."""
    net = jm.MMDiT(jmmdit.MMDiTConfig(**MMDIT_KW))
    cond1 = {"cond": {k: jnp.asarray(v[:1]) for k, v in _cond_np(0).items()}}
    params = perturbed(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)), cond1),
                       1)
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=2))
    disc_params = perturbed(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((B, HW, HW, C))), 4)
    lora = perturbed(jlora.init_lora(params, 2, jax.random.PRNGKey(5)), 6)
    jmodel = JFlashDiffusionSD3(JFlashDiffusionSD3Config(**_flash_kw()), student_module=net, teacher_module=net,
                                discriminator=jdisc, lora_scaling=0.5)
    z = np.random.default_rng(18).standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [_cond_np(19), _cond_np(20), _cond_np(19, zero=True)]
    return dict(net=net, params=params, jdisc=jdisc, disc_params=disc_params, lora=lora, jmodel=jmodel, z=z,
                conds=conds)


@pytest.fixture(scope="module", params=[0, 2])
def sd3_step(request, sd3_jax):
    """JAX's losses and gradients from a key whose start index is
    ``request.param``, and the port's step with the same weights and draws
    (its MMDiT with ``remat``, as the trainer builds it)."""
    s, stage = sd3_jax, 1
    jmodel = s["jmodel"]
    key = next(k for k in map(jax.random.PRNGKey, range(200)) if int(jcommon.sample_start_index(
        jax.random.split(k, 8)[3], jmodel.stage_pdfs[stage])) == request.param)
    jbatch = {"__z": jnp.asarray(s["z"]),
              "__conds": tuple({"cond": {k: jnp.asarray(v) for k, v in c.items()}} for c in s["conds"])}
    loss_fn = lambda tr: jmodel.losses(tr, {"teacher": s["params"]}, jbatch, key, stage)
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {"lora": s["lora"], "disc": s["disc_params"]})

    cfg = MMDiTConfig(**MMDIT_KW, remat=True)
    mmdit = MMDiT(cfg)
    mmdit.load_state_dict(mmdit_from_jax(s["params"], cfg))
    mmdit.eval().requires_grad_(False)
    dcfg = DiscriminatorConfig(feature_dim=8, num_stages=2)
    disc = ConvDiscriminator(dcfg, in_channels=C)
    disc.load_state_dict(discriminator_from_jax(s["disc_params"], dcfg))
    tmodel = FlashDiffusionSD3(FlashDiffusionSD3Config(**_flash_kw()), mmdit, discriminator=disc, lora_scaling=0.5)
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()} for k, ab in lora_from_jax(s["lora"], cfg).items()}
    tmodel.attach_lora(tl)
    tbatch = {"__z": t_(s["z"]), "__conds": tuple({"cond": {k: t_(v) for k, v in c.items()}} for c in s["conds"])}
    draws = jax_step_draws(jmodel, key, stage, s["z"])
    want = dict(total=total, aux=aux, lora=lora_from_jax(grads["lora"], cfg),
                disc=discriminator_from_jax(grads["disc"], dcfg))
    return dict(tmodel=tmodel, tl=tl, batch=tbatch, draws=draws, stage=stage, want=want, start=request.param)


def test_sd3_flash_step_losses_and_grads_match_jax(sd3_step):
    """``losses`` and the LoRA and discriminator gradients of one backward
    vs ``jax.value_and_grad(FlashDiffusionSD3.losses)``: the flow-match
    rollout from the start index (0: pure noise; 2: the σ-interpolation of
    ``z``), float timesteps, DMD over the full schedule, both lsgan losses
    over the post-mid features, at a joint sequence masked past
    ``kv_valid``; every draw the JAX key's. Tolerance 1e-4 of max(1,
    max|want|) per tensor; every gradient finite."""
    s = sd3_step
    tmodel, tl, want, draws = s["tmodel"], s["tl"], s["want"], s["draws"]
    assert draws["start_idx"] == s["start"] and "rollout_noise" not in draws and draws["dmd_idx"].dtype == torch.long
    total, aux = tmodel.losses(s["batch"], draws, s["stage"])
    total.backward()
    close(total, want["total"], 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator", "guidance"):
        close(aux[k], want["aux"][k], 1e-4, k)
    assert float(aux["loss/dmd"].detach()) != 0.0 and float(aux["loss/gan_d"].detach()) != 0.0
    start_t = tmodel.stage_schedules[1].timesteps[s["start"]]
    assert isinstance(aux["start_timestep"], float) and aux["start_timestep"] == start_t
    assert np.float32(want["aux"]["start_timestep"]) == np.float32(start_t)
    assert set(want["lora"]) == set(tl)
    for name, ab in tl.items():
        for k in ("a", "b"):
            assert torch.isfinite(ab[k].grad).all(), f"{name}.{k}"
            close(ab[k].grad, want["lora"][name][k], 1e-4, f"{name}.{k}")
    for name, p in tmodel.discriminator.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, want["disc"][name], 1e-4, name)


def test_sd3_merge_step_matches_jax(sd3_step):
    """SD3's student on merged weights (``lora_mode="merge"``) over the
    dense tree: JAX's step to 1e-4, and ``remat_student_merge`` bit-equal."""
    s = sd3_step
    check_merge_step(s["tmodel"], s["tl"], s["batch"], s["draws"], s["stage"], s["want"], close)


# ---------------------------------------------------------------- build_trainer
CLIP_KW = dict(vocab_size=49408, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, max_positions=77)
CLIP_G_KW = dict(CLIP_KW, hidden_size=48, intermediate_size=96, num_layers=3, hidden_act="gelu")
T5_KW = dict(vocab_size=32128, d_model=JOINT_DIM, d_ff=64, d_kv=16, num_layers=1, num_heads=2)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)


SD3_TINY = dict(mmdit=MMDIT_KW, vae=VAE_KW, clip=CLIP_KW, clip_g=CLIP_G_KW, t5=T5_KW, joint=JOINT_DIM)


def tiny_sd3_modules(monkeypatch):
    """``sample``'s SD3 configs replaced by tiny ones: the MMDiT above, the
    2-level SD3 VAE (latents / 2), CLIP-L and CLIP-G of 32 and 48 wide over
    the full CLIP vocabulary (projections 16 and 32: the 48-wide vector),
    a 1-layer T5 of the joint width, and that width for the conditioner."""
    for obj, name, value in W.tiny_sd3_patches(SD3_TINY):
        monkeypatch.setattr(obj, name, value)


@pytest.mark.parametrize("use_t5", [True, False])
def test_build_trainer_reads_flash_sd3_yaml(monkeypatch, use_t5):
    """``build_trainer("sd3")`` maps ``flash_sd3.yaml`` onto the model: K =
    32 on the flow-match Euler teacher at shift 3, l2 distill (no LPIPS
    module), DMD, lsgan, guidance 3–7, the loss scales, the GAN's tail
    indices; the 64-feature discriminator over the 16 post-mid channels (4
    stages at 1024²; 3 at 256², which 4 would reduce below the 4×4 head);
    CLIP-L, CLIP-G and T5 over 77 tokens packed by ``SD3Conditioner``, the
    uncond dropping ``text`` and ``t5_text`` (without T5: the two CLIP
    towers and ``text``); the MMDiT's ``remat``; the MMDiT in bf16, the text
    towers in fp32 over bf16-rounded weights."""
    import yaml

    tiny_sd3_modules(monkeypatch)
    with open(train.CONFIGS["sd3"]) as f:
        want = yaml.safe_load(f)
    cfg = {**want, "LORA_RANK": 4, "USE_T5": use_t5}
    trainer = train.build_trainer("sd3", device="cpu", config=cfg)
    model, mc = trainer.model, trainer.model.config
    assert isinstance(model, FlashDiffusionSD3) and model.teacher_sched_mod is flow_match
    assert model.sched_config.shift == 3.0 and not model._sched_stochastic and not model._sched_has_carry
    assert (mc.K, mc.num_iterations_per_K) == (want["K"], want["NUM_ITERATIONS_PER_K"]) and mc.K[1] == 32
    assert (mc.distill_loss_scale, mc.dmd_loss_scale, mc.adversarial_loss_scale) == (
        want["DISTILL_LOSS_SCALE"], want["DMD_LOSS_SCALE"], want["ADVERSARIAL_LOSS_SCALE"])
    assert (mc.distill_loss_type, mc.gan_loss_type, mc.use_dmd_loss, mc.use_adversarial_loss) == (
        "l2", "lsgan", True, True)
    assert (mc.guidance_scale_min, mc.guidance_scale_max) == ([3.0] * 4, [7.0] * 4)
    assert list(mc.gan_tail_indices) == [10, 250, 500, 750] and model.use_adversarial_loss
    assert model.lpips is None and isinstance(model.teacher_module, MMDiT)
    dc = model.discriminator.config
    assert (dc.feature_dim, dc.num_stages, dc.norm_groups, model.discriminator.conv_0.in_channels) == (64, 4, 4, C)
    assert train._discriminator("sd3", model.teacher_module, 256).config.num_stages == 3
    cond = model.conditioner
    assert isinstance(cond, SD3Conditioner) and cond.t5_dim == JOINT_DIM
    towers = cond.conditioners
    assert [type(c) for c in towers] == [ClipEmbedder, ClipEmbedder] + [T5AsSD3Embedder] * use_t5
    assert mc.ucg_keys == (["text", "t5_text"] if use_t5 else ["text"])
    if use_t5:
        assert towers[2].input_key == "t5_text" and towers[2].config.max_length == 77
        w = towers[2].module.shared.weight
        assert w.dtype == torch.float32 and torch.equal(w, w.bfloat16().float())
    assert model.teacher_module.config.remat and model.lora_scaling == lora_scaling(4)
    assert set(trainer.lora) == set(init_lora(model.teacher_module, 4))
    assert all(ab["a"].shape[1] == 4 for ab in trainer.lora.values())
    assert trainer.opt_g.lr == trainer.opt_d.lr == float(want["LR"])
    assert model.teacher_module.proj_out.weight.dtype == torch.bfloat16
    assert model.vae.config.latent_channels == C and model.vae.config.shift_factor == pytest.approx(0.0609)


def test_sd3_trainer_steps_on_tiny_modules(monkeypatch):
    """One ``fit`` step of ``build_trainer("sd3")`` (``flash_sd3.yaml`` at
    64², stage 1, K = 4, tiny modules, T5 on) on ``synthetic_batches(model=
    "sd3")``: finite losses, every LoRA B factor but the inert one of the
    final block's ``add_q_proj`` (its gradient exactly 0) and the
    discriminator changed, the MMDiT, VAE and text towers bit-identical."""
    tiny_sd3_modules(monkeypatch)
    cfg = {**train.load_config(train.CONFIGS["sd3"]), "LORA_RANK": 4, "IMAGE_SIZE": 64, "K": [K] * 4,
           "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
    trainer = train.build_trainer("sd3", device="cpu", config=cfg)
    model = trainer.model
    snap = lambda ms: [t.detach().clone() for m in ms for t in m.state_dict().values()]
    frozen_modules = (model.teacher_module, model.vae, model.conditioner)
    frozen, disc = snap(frozen_modules), snap([model.discriminator])
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    aux = trainer.fit(train.synthetic_batches(2, 64, model="sd3"), max_steps=1)
    assert trainer.step == 1 and model.stage_for_iteration(1) == 1
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert aux["start_timestep"] in model.stage_schedules[1].timesteps
    # the final block's context queries feed only the context rows, which
    # its context_pre_only drops: that pair's gradient is exactly 0, as in JAX
    inert = f"transformer_blocks.{MMDIT_KW['depth'] - 1}.attn.add_q_proj"
    assert not trainer.lora[inert]["b"].grad.any() and not trainer.lora[inert]["b"].any()
    assert all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items() if k != inert)
    assert not all(torch.equal(a, b) for a, b in zip(disc, snap([model.discriminator])))
    assert all(torch.equal(a, b) for a, b in zip(frozen, snap(frozen_modules)))


def test_synthetic_batches_sd3_keys_and_shapes():
    """``model="sd3"``: CLIP-style ids [B, 77] and, with T5 (77 tokens by
    default, the yaml's), T5-style ``t5_text_ids`` (tokens ≥ 3, one EOS 1,
    padding 0) with ``t5_text_mask`` 1 up to the EOS, as
    ``train_flash_sd3.py`` tokenizes them; without T5, the CLIP ids alone."""
    batch = next(train.synthetic_batches(3, 64, seed=2, model="sd3"))
    assert set(batch) == {"image", "text_ids", "t5_text_ids", "t5_text_mask"}
    ids, mask = batch["t5_text_ids"], batch["t5_text_mask"]
    assert batch["image"].shape == (3, 64, 64, 3) and batch["text_ids"].shape == (3, 77)
    assert ids.shape == mask.shape == (3, 77) and ids.dtype == mask.dtype == np.int64
    assert (batch["text_ids"][:, 0] == 49406).all()
    for row, m in zip(ids, mask):
        n = int(m.sum())
        assert row[n - 1] == 1 and (row[: n - 1] >= 3).all() and not row[n:].any() and m[:n].all()
    clip_only = next(train.synthetic_batches(2, 64, model="sd3", t5_max_length=None))
    assert set(clip_only) == {"image", "text_ids"}
    assert next(train.synthetic_batches(1, 64, model="sd3", t5_max_length=16))["t5_text_ids"].shape == (1, 16)
