"""Parity of the PyTorch port's training modules with the JAX package.

Every module of the Flash SD1.5 step (VAE encoder, discriminator, LPIPS,
DDPM schedule, distill helpers and losses, the UNet's ``return_features``
and ``remat``, the LoRA side path, the optimizer, the trainer) is held
against the JAX package on the same numpy inputs and the same weights (JAX
params carried by ``utils/convert.py``), fp32 on both sides. Tolerances
are stated per test; 1e-4 absolute where fp32 sums run in another order
through a few dozen layers. The whole step is in ``test_torch_train.py``.
"""

import functools

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.distill import (
    LPIPS,
    ConvDiscriminator,
    DiscriminatorConfig,
    FlashDiffusion,
    FlashDiffusionConfig,
)
from flash_diffusion_tpu_torch.distill import common as tcommon
from flash_diffusion_tpu_torch.distill import losses as tlosses
from flash_diffusion_tpu_torch.lora import attach_lora, init_lora, lora_paths, merge_lora, shared_copy
from flash_diffusion_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig, UNet2DCondition, UNetConfig
from flash_diffusion_tpu_torch.schedulers import SchedulerConfig, add_noise, ddpm
from flash_diffusion_tpu_torch.trainer import TrainingConfig, TrainingPipeline
from flash_diffusion_tpu_torch.train import CONFIGS
from flash_diffusion_tpu_torch.utils import (
    discriminator_from_jax,
    lora_from_jax,
    lpips_from_jax,
    unet_from_jax,
    vae_from_jax,
)
from flash_diffusion_tpu_torch.utils.convert import lora_path_to_port

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill import common as jcommon
    from flash_diffusion_tpu.distill import losses as jlosses
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.distill.lpips import LPIPS as JLPIPS
    from flash_diffusion_tpu.schedulers import ddpm as jddpm
    from flash_diffusion_tpu.schedulers.base import SchedulerConfig as JSchedulerConfig
except ImportError:
    jax = None

torch.set_num_threads(2)

B, HW, C = 2, 16, 4
# the tiny SD1.5-shaped UNet of tests/test_distill.py
UNET_KW = dict(
    in_channels=C, out_channels=C, block_out_channels=[16, 32],
    down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
    transformer_layers_per_block=[1, 1], num_heads=[2, 2], cross_attention_dim=16, norm_num_groups=8,
)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), params)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


@functools.lru_cache(maxsize=None)
def jax_unet(seed=0):
    net = jm.UNet2DCondition(jm.UNetConfig(**UNET_KW))
    cond = {"cond": {"crossattn": jnp.zeros((1, 8, 16))}}
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)), cond)
    return net, perturbed(params, seed + 1)


def port_unet(params, **kw):
    cfg = UNetConfig(**UNET_KW, **kw)
    unet = UNet2DCondition(cfg)
    unet.load_state_dict(unet_from_jax(params, cfg))
    return unet.eval()


# ---------------------------------------------------------------- modules
def test_vae_encode_matches_jax(jax_ref):
    """Encoder (asymmetric-pad downsamples, mid attention), quant_conv,
    logvar clip and the posterior sample with injected noise."""
    vae = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW))
    params = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3))), 2)
    x = np.random.default_rng(3).uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = vae.apply(params, jnp.asarray(x), key, method=vae.encode)
    want_mode = vae.apply(params, jnp.asarray(x), method=vae.encode)
    mean, _ = vae.apply(params, jnp.asarray(x), method=vae.moments)
    noise = jax.random.normal(key, mean.shape, mean.dtype)
    cfg = AutoencoderKLConfig(**VAE_KW)
    tvae = AutoencoderKL(cfg)
    tvae.load_state_dict(vae_from_jax(params, cfg))
    with torch.no_grad():
        got = tvae.encode(t_(x), t_(noise))
        got_mode = tvae.encode(t_(x))
    assert got.shape == (B, HW // 2, HW // 2, C)
    close(got, want, 1e-4)
    close(got_mode, want_mode, 1e-4)


@pytest.mark.parametrize("stages", [1, 2])
def test_discriminator_matches_jax(jax_ref, stages):
    """Stage 0 has no norm; stage 1 adds the GroupNorm. NHWC features in."""
    jd = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=stages))
    shape = (B, 16, 16, 12) if stages == 2 else (B, 8, 8, 12)
    params = perturbed(jd.init(jax.random.PRNGKey(5), jnp.zeros(shape)), 6)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = jd.apply(params, jnp.asarray(x))
    cfg = DiscriminatorConfig(feature_dim=8, num_stages=stages)
    td = ConvDiscriminator(cfg, in_channels=12)
    td.load_state_dict(discriminator_from_jax(params, cfg))
    with torch.no_grad():
        got = td(t_(x))
    assert got.shape == tuple(want.shape)
    close(got, want, 1e-5)


def test_lpips_matches_jax(jax_ref):
    """VGG16 taps, channel normalization, lin heads; 32² inputs."""
    jl = JLPIPS()
    a, b = (np.random.default_rng(s).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32) for s in (8, 9))
    params = perturbed(jax.jit(jl.init)(jax.random.PRNGKey(8), jnp.asarray(a), jnp.asarray(b)), 9, 0.01)
    want = jax.jit(jl.apply)(params, jnp.asarray(a), jnp.asarray(b))
    tl = LPIPS()
    tl.load_state_dict(lpips_from_jax(params))
    with torch.no_grad():
        got = tl(t_(a), t_(b))
    assert got.shape == (B,)
    close(got, want, 1e-5)


def test_ddpm_schedule_and_step_match_jax(jax_ref):
    want = jddpm.set_timesteps(JSchedulerConfig(), 32)
    got = ddpm.set_timesteps(SchedulerConfig(), 32)
    assert got.timesteps == np.asarray(want.timesteps).tolist()
    for name in ("sqrt_acp_t", "sqrt_1macp_t", "x0_coeff", "sample_coeff", "sigma_noise"):
        assert np.asarray(getattr(got, name), np.float32).tolist() == np.asarray(getattr(want, name)).tolist(), name
    assert np.array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))
    rng = np.random.default_rng(10)
    sample, out = (rng.standard_normal((B, 4, 4, C)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(11)
    noise = jax.random.normal(key, sample.shape, sample.dtype)
    for i in (0, 17, 31):
        w = jddpm.step(want, jnp.asarray(out), i, jnp.asarray(sample), key=key)
        close(ddpm.step(got, t_(out), i, t_(sample), noise=t_(noise)), w, 1e-5, f"step {i}")
    t = np.array([999, 3], np.int64)
    from flash_diffusion_tpu.schedulers import add_noise as jadd_noise

    w = jadd_noise(want, jnp.asarray(sample), jnp.asarray(out), jnp.asarray(t, jnp.int32))
    close(add_noise(got, t_(sample), t_(out), t_(t)), w, 1e-6)


def test_distill_common_matches_jax(jax_ref):
    for dist in ("mixture", "uniform", "gaussian"):
        np.testing.assert_array_equal(tcommon.timestep_pdf(dist, 32, 4, 0.5, [0.1, 0.3, 0.3, 0.3]),
                                      jcommon.timestep_pdf(dist, 32, 4, 0.5, [0.1, 0.3, 0.3, 0.3]))
    for it in (1, 4999, 5000, 5001, 20000, 25000):
        assert tcommon.stage_index(it, [5000] * 4) == jcommon.stage_index(it, [5000] * 4)
    t = np.array([999, 0, 259], np.int64)
    for g, w in zip(tcommon.boundary_scalings(t_(t)), jcommon.boundary_scalings(jnp.asarray(t))):
        close(g, w, 0)
    acp = np.linspace(0.0, 0.99, 1000).astype(np.float32)
    sa, s1 = np.sqrt(acp), np.sqrt(1 - acp)
    rng = np.random.default_rng(12)
    out, sample, inp = (rng.standard_normal((3, 2, 2, C)).astype(np.float32) for _ in range(3))
    want = jcommon.predicted_x0_eps(jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample), jnp.asarray(sa),
                                    jnp.asarray(s1), jnp.asarray(inp))
    got = tcommon.predicted_x0_eps(t_(out), t_(t), t_(sample), t_(sa), t_(s1), t_(inp))
    close(got, want, 1e-6)  # t = 0 takes the zero-alpha fallback
    # the start index draw: a categorical over the pdf, on the host
    g = torch.Generator().manual_seed(0)
    pdf = tcommon.timestep_pdf("mixture", 8, 2, 0.5)
    assert all(0 <= tcommon.sample_start_index(pdf, g) < 8 for _ in range(20))


@pytest.mark.parametrize("loss_type", ["hinge", "vanilla", "non-saturating", "wgan", "lsgan"])
def test_losses_match_jax(jax_ref, loss_type):
    rng = np.random.default_rng(13)
    a, b, c, d = (rng.standard_normal((B, 8, 8, C)).astype(np.float32) for _ in range(4))
    for name in ("l2_loss", "l1_loss", "huber_loss"):
        close(getattr(tlosses, name)(t_(a), t_(b)), getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)), 1e-6, name)
    close(tlosses.center_crop(t_(a), 4), jlosses.center_crop(jnp.asarray(a), 4), 0)
    ap = np.array([0.3, 0.9], np.float32)
    close(tlosses.dmd_loss(t_(a), t_(b), t_(c), t_(d), t_(ap)),
          jlosses.dmd_loss(*(jnp.asarray(x) for x in (a, b, c, d, ap))), 1e-5)
    jd = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=1))
    params = perturbed(jd.init(jax.random.PRNGKey(14), jnp.asarray(a)), 15)
    want = jlosses.gan_losses(jd.apply, params, jnp.asarray(a), jnp.asarray(b), loss_type)
    cfg = DiscriminatorConfig(feature_dim=8, num_stages=1)
    td = ConvDiscriminator(cfg, in_channels=C)
    td.load_state_dict(discriminator_from_jax(params, cfg))
    got = tlosses.gan_losses(td, t_(a), t_(b), loss_type)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_unet_return_features_match_jax(jax_ref):
    net, params = jax_unet()
    rng = np.random.default_rng(16)
    x, ctx = rng.standard_normal((B, HW, HW, C)).astype(np.float32), rng.standard_normal((B, 8, 16)).astype(np.float32)
    t = np.array([999, 10], np.int32)
    cond = lambda f: {"cond": {"crossattn": f(ctx)}}
    want_out, want_feat = jax.jit(lambda p, x, t: net.apply(p, x, t, cond(jnp.asarray), return_features=True))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out, feat = port_unet(params)(t_(x), t_(t), cond(t_), return_features=True)
    assert feat.shape == tuple(want_feat.shape) == (B, HW // 2, HW // 2, 32)
    close(out, want_out, 1e-4)
    close(feat, want_feat, 1e-4)


def test_unet_remat_matches_plain():
    """``remat`` recomputes blocks in the backward: the same outputs and the
    same input and LoRA gradients as without (fp32, tolerance 1e-6)."""
    torch.manual_seed(0)
    base = UNet2DCondition(UNetConfig(**UNET_KW)).eval()
    remat = UNet2DCondition(UNetConfig(**UNET_KW, remat=True)).eval()
    remat.load_state_dict(base.state_dict())
    g = torch.Generator().manual_seed(1)
    lora = init_lora(base, 2, g)
    for ab in lora.values():
        ab["b"].normal_(generator=g)
        ab["a"].requires_grad_()
    x = torch.randn(B, HW, HW, C, generator=g)
    cond = {"cond": {"crossattn": torch.randn(B, 8, 16, generator=g)}}
    results = []
    for net in (base, remat):
        net.requires_grad_(False)
        attach_lora(net, lora)
        xi = x.clone().requires_grad_()
        out = net(xi, torch.tensor([999, 10]), cond)
        (out * out).sum().backward()
        a = next(iter(lora.values()))["a"]
        results.append((out.detach(), xi.grad, a.grad.clone()))
        a.grad = None
    for r0, r1 in zip(*results):
        torch.testing.assert_close(r1, r0, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- LoRA
def test_lora_tree_maps_one_to_one_onto_jax_lora_paths(jax_ref):
    """JAX ``lora_paths`` of the tiny UNet (proj_in/proj_out Dense there)
    and the port's (1×1 convs here, dense pairs) name the same layers."""
    _, params = jax_unet()
    jpaths = jlora.lora_paths(params)
    unet = port_unet(params)
    mapped = [lora_path_to_port(p, unet.config) for p in jpaths]
    assert len(set(mapped)) == len(jpaths) and set(mapped) == set(lora_paths(unet))
    assert any(name.endswith("proj_in") for name in mapped)
    lora = init_lora(unet, 4, torch.Generator().manual_seed(0))
    assert set(lora) == set(mapped)
    ab = lora["down_blocks.0.attentions.0.proj_in"]
    assert ab["a"].shape == (16, 4) and ab["b"].shape == (4, 16) and not ab["b"].any()


def test_zero_b_student_equals_teacher_and_merge_matches_side_path():
    torch.manual_seed(0)
    teacher = UNet2DCondition(UNetConfig(**UNET_KW)).eval()
    g = torch.Generator().manual_seed(2)
    lora = init_lora(teacher, 2, g)
    student = attach_lora(shared_copy(teacher), lora, 0.5)
    assert student.conv_in.weight is teacher.conv_in.weight
    x, cond = torch.randn(B, HW, HW, C, generator=g), {"cond": {"crossattn": torch.randn(B, 8, 16, generator=g)}}
    t = torch.tensor([500, 20])
    with torch.no_grad():
        assert torch.equal(student(x, t, cond), teacher(x, t, cond))
        for ab in lora.values():
            ab["b"].normal_(generator=g)
        side = student(x, t, cond)
        merged = UNet2DCondition(UNetConfig(**UNET_KW)).eval()
        merged.load_state_dict(merge_lora(teacher.state_dict(), lora, 0.5))
        torch.testing.assert_close(side, merged(x, t, cond), atol=1e-5, rtol=0)
        assert not torch.equal(side, teacher(x, t, cond))


def test_side_path_grads_match_jax_student_forward(jax_ref):
    """dA, dB through the port's side path vs ``jax.grad`` of the JAX
    ``_student_forward`` (``LoraDense`` side path), scaling 0.5; 1e-4."""
    net, params = jax_unet()
    lora = perturbed(jlora.init_lora(params, 2, jax.random.PRNGKey(3)), 4)
    model = JFlashDiffusion(JFlashDiffusionConfig(K=[2], num_iterations_per_K=[2]), student_module=net,
                            lora_scaling=0.5)
    rng = np.random.default_rng(17)
    x, ctx, w = (rng.standard_normal(s).astype(np.float32) for s in ((B, HW, HW, C), (B, 8, 16), (B, HW, HW, C)))
    t = np.array([700, 40], np.int32)
    jcond = {"cond": {"crossattn": jnp.asarray(ctx)}}
    loss = lambda lo: jnp.sum(model._student_forward({"teacher": params}, lo, jnp.asarray(x), jnp.asarray(t), jcond)
                              * jnp.asarray(w))
    want = lora_from_jax(jax.jit(jax.grad(loss))(lora), UNetConfig(**UNET_KW))
    unet = port_unet(params).requires_grad_(False)
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()} for k, ab in lora_from_jax(lora, unet.config).items()}
    student = attach_lora(shared_copy(unet), tl, 0.5)
    (student(t_(x), t_(t), {"cond": {"crossattn": t_(ctx)}}) * t_(w)).sum().backward()
    for name, ab in tl.items():
        for k in ("a", "b"):
            close(ab[k].grad, want[name][k], 1e-4, f"{name}.{k}")


# ---------------------------------------------------------------- trainer
def test_adamw_matches_optax(jax_ref):
    """Two steps of the port's AdamW (bf16 first moment, weight decay 1e-4,
    a global-norm clip) vs optax compiled by ``jax.jit``, as the JAX
    trainer's step runs it (XLA keeps b1·μ unrounded in fp32), on the same
    params and grads; 1e-6."""
    import optax

    rng = np.random.default_rng(20)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 3 for p in params] for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(4.0), optax.adamw(1e-3, weight_decay=1e-4, mu_dtype=jnp.bfloat16))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [t_(p) for p in params]
    opt = TrainingConfig(learning_rates=[1e-3, 1e-3], gradient_clip_norm=4.0).build_optimizer(0, tp)
    assert opt.mu[0].dtype == torch.bfloat16 and opt.weight_decay == 1e-4
    for gs in grads:
        up, state = jax.jit(tx.update)([jnp.asarray(g) for g in gs], state, jp)
        jp = [p + u for p, u in zip(jp, up)]
        for p, g in zip(tp, gs):
            p.grad = t_(g)
        opt.step()
        for p, w in zip(tp, jp):
            close(p, w, 1e-6)


def test_build_trainer_reads_flash_sd_yaml(monkeypatch):
    """``build_trainer`` maps ``flash_sd.yaml``'s keys onto the model and the
    optimizers (tiny UNet, VAE and CLIP in place of SD1.5's), stores the
    frozen modules in bf16, and refuses a model whose training is not
    ported."""
    import yaml

    from flash_diffusion_tpu_torch import sample, train
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedderConfig

    monkeypatch.setattr(sample, "sd15_unet_config", lambda **kw: UNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda: AutoencoderKLConfig(**VAE_KW))
    monkeypatch.setattr(sample, "ClipEmbedderConfig", lambda **kw: ClipEmbedderConfig(**kw, text_embedder_config=dict(
        vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=77,
        eos_token_id=49407)))
    with open(CONFIGS["sd15"]) as f:
        want = yaml.safe_load(f)
    assert train.load_config(CONFIGS["sd15"]) == want
    trainer = train.build_trainer("sd15", device="cpu", config={**want, "LORA_RANK": 4})
    mc = trainer.model.config
    assert (mc.K, mc.num_iterations_per_K, mc.mode_probs) == (want["K"], want["NUM_ITERATIONS_PER_K"],
                                                              want["MODE_PROBS"])
    assert (mc.distill_loss_scale, mc.dmd_loss_scale, mc.adversarial_loss_scale) == (
        want["DISTILL_LOSS_SCALE"], want["DMD_LOSS_SCALE"], want["ADVERSARIAL_LOSS_SCALE"])
    assert (mc.distill_loss_type, mc.gan_loss_type, mc.use_dmd_loss) == ("lpips", "hinge", True)
    assert trainer.opt_g.lr == trainer.opt_d.lr == float(want["LR"])
    assert all(ab["a"].shape[1] == 4 for ab in trainer.lora.values())
    assert trainer.model.teacher_module.conv_in.weight.dtype == torch.bfloat16
    assert trainer.model.student_module.conv_in.weight is trainer.model.teacher_module.conv_in.weight
    assert trainer.model.teacher_module.config.remat and trainer.model.teacher_sched_mod is ddpm
    assert "canny_adapter" not in train.MODELS  # the T2I-Adapter family is not ported
    with pytest.raises(ValueError):
        train.build_trainer("canny_adapter", device="cpu")


@pytest.mark.parametrize("frozen_dtype", [None, torch.bfloat16])
def test_trainer_updates_lora_and_disc_only(frozen_dtype):
    """Two simultaneous steps of the tiny model on the CPU through
    ``TrainingPipeline.fit`` (staged encode and conditioning, DDPM rollout,
    LPIPS distill, DMD, GAN): finite losses, LoRA B and the discriminator
    move, the teacher, the VAE and the conditioner stay bit-identical; the
    frozen modules are cast as the JAX trainer casts them."""
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedder, ClipEmbedderConfig, ConditionerWrapper

    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig(**UNET_KW, remat=True))
    vae = AutoencoderKL(AutoencoderKLConfig(**VAE_KW))
    clip = ConditionerWrapper([ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=dict(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=8,
        eos_token_id=63)))])
    disc = ConvDiscriminator(DiscriminatorConfig(feature_dim=8, num_stages=1), in_channels=32)
    cfg = FlashDiffusionConfig(K=[2, 2], num_iterations_per_K=[1, 1], distill_loss_type="lpips", lpips_crop=8,
                               mixture_num_components=2, use_dmd_loss=True, use_empty_prompt=True)
    model = FlashDiffusion(cfg, unet, vae=vae, conditioner=clip, discriminator=disc, lpips=LPIPS())
    lora = init_lora(unet, 2, torch.Generator().manual_seed(1))
    trainer = TrainingPipeline(model, TrainingConfig(learning_rates=[1e-3, 1e-3]), lora,
                               frozen_dtype=frozen_dtype, device="cpu")
    dtype = frozen_dtype or torch.float32
    assert unet.conv_in.weight.dtype == vae.decoder.conv_in.weight.dtype == dtype
    w = next(clip.parameters())
    assert w.dtype == torch.float32 and torch.equal(w, w.to(dtype).float())
    frozen = [t.clone() for m in (unet, vae, clip) for t in m.state_dict().values()]
    before = ({k: ab["b"].clone() for k, ab in trainer.lora.items()},
              [p.clone() for p in disc.parameters()])
    rng = np.random.default_rng(21)
    data = ({"image": rng.uniform(-1, 1, (B, 2 * HW, 2 * HW, 3)).astype(np.float32),
             "text_ids": rng.integers(0, 63, (B, 8))} for _ in range(3))
    aux = trainer.fit(data, max_steps=2)
    assert trainer.step == 2 and all(np.isfinite(float(v)) for v in aux.values())
    assert all(not torch.equal(before[0][k], ab["b"]) for k, ab in trainer.lora.items())
    assert any(not torch.equal(p0, p) for p0, p in zip(before[1], disc.parameters()))
    after = [t for m in (unet, vae, clip) for t in m.state_dict().values()]
    assert all(torch.equal(a, b) for a, b in zip(frozen, after))
