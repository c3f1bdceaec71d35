"""The port's Pixart-α Flash distillation step and Pixart int8 against the JAX package.

- the teacher's DDPM tables on Pixart's linear betas (``sample.PIXART_
  SCHEDULER``, the JAX example's ``SchedulerConfig``) against JAX's, exact
  in fp32, and apart from the scaled-linear tables the other models use;
- the DiT's training surface: ``remat`` (the same forward and gradients as
  without it), ``return_features`` and the ``concat`` conditioning against
  the JAX ``DiT`` (1e-5, as ``tests/test_torch_dit.py``);
- the LoRA tree: JAX ``lora_paths`` of the DiT, mapped by
  ``utils/convert.py lora_path_to_port``, names the port's ``lora_paths``
  one to one, but for the root ``proj_out`` pair, which the port leaves
  out; that JAX pair is inert (its B changes no output, its gradient is
  exactly 0);
- one ``losses`` and backward of a tiny Pixart-shaped ``FlashDiffusion``
  (DDPM teacher on linear betas, K = [4, 4] at stage 1: distill 1.0, DMD
  0.3, adversarial 0.1; l2 distill, hinge GAN over the DiT's 4-channel
  output latents through a 2-stage discriminator; ``crossattn``,
  ``attention_mask`` and ``vector`` conditioning) against
  ``jax.value_and_grad(FlashDiffusion.losses)``, every draw injected from
  the JAX key, to 1e-4 of each tensor's scale (the distill loss reaches
  ~7.5e3 on linear betas' small √ᾱ_t);
- ``build_trainer("pixart")`` on ``flash_pixart.yaml`` with tiny modules
  (``sample.pixart_config``, ``sd_vae_config`` and ``T5TextEmbedderConfig``
  monkeypatched), one ``fit`` step of it, and ``synthetic_batches(model=
  "pixart")``'s keys and shapes;
- int8: ``quantize_dense`` over the tiny DiT picks JAX ``quantize_dense``'s
  layers (10 a block) with the same codes and scales, bit for bit; the full
  DiT has 280; the int8 DiT forward lies within twice JAX's own int8 spread
  of JAX's (``tests/test_torch_quant.py`` says why).

fp32 on both sides; JAX params carried by ``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import train
from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig, FlashDiffusion
from flash_diffusion_tpu_torch.distill import FlashDiffusionConfig
from flash_diffusion_tpu_torch.lora import init_lora, lora_paths, lora_scaling
from flash_diffusion_tpu_torch.models import AutoencoderKLConfig, DiT, DiTConfig, pixart_config
from flash_diffusion_tpu_torch.models.embedders import RawVectorEmbedder, T5TextEmbedder, T5TextEmbedderConfig
from flash_diffusion_tpu_torch.quant import SCALE_KEY, apply_weights, quantize_dense
from flash_diffusion_tpu_torch.sample import PIXART_SCHEDULER
from flash_diffusion_tpu_torch.schedulers import SchedulerConfig, ddpm, training_tables
from flash_diffusion_tpu_torch.utils import discriminator_from_jax, dit_from_jax, lora_from_jax
from flash_diffusion_tpu_torch.utils.convert import DIT_INERT_LORA, lora_path_to_port
from test_torch_pipeline import VAE_KW
from test_torch_quant import int8_spread, rel_l2
from test_torch_train import jax_step_draws, perturbed, t_

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu import quant as jquant
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill import common as jcommon
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.schedulers import SchedulerConfig as JSchedulerConfig
    from flash_diffusion_tpu.schedulers import ddpm as jddpm
    from flash_diffusion_tpu.schedulers.base import training_tables as jtraining_tables
except ImportError:
    jax = None

torch.set_num_threads(2)

B, HW, C, SEQ = 2, 16, 4, 12
# Pixart-shaped: 3 vector chunks, 2 heads of 24, the T5 mask; 16² latents
# (64 tokens)
DIT_KW = dict(in_channels=4, out_channels=8, patch_size=2, hidden_size=48, depth=2, num_heads=2,
              caption_channels=32, num_vector_embeds=3, vector_embed_dim=16, sample_size=16)
K = 4
MIN_DIM = 32  # quantizes every allowlisted layer of the tiny DiT (48 and 192 wide)


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def _cond_np(seed, concat=False):
    """A conditioning of the tiny DiT: projected-to-be T5 states, a padding
    mask (5 of 12 tokens in the first sample), [h, w, aspect ratio]."""
    rng = np.random.default_rng(seed)
    cond = {"crossattn": rng.standard_normal((B, SEQ, 32)).astype(np.float32),
            "attention_mask": np.array([[1] * 5 + [0] * (SEQ - 5), [1] * SEQ], np.int32),
            "vector": np.array([[128.0, 128.0, 1.0], [128.0, 192.0, 1.5]], np.float32)}
    if concat:
        cond["concat"] = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    return cond


def _jcond(cond):
    return {"cond": {k: jnp.asarray(v) for k, v in cond.items()}}


def _tcond(cond):
    return {"cond": {k: t_(v) for k, v in cond.items()}}


_JAX_DITS = {}


def jax_dit(concat=0, seed=0):
    """The tiny JAX DiT (``concat`` extra input channels) and its perturbed
    params, built once per module."""
    if (concat, seed) not in _JAX_DITS:
        net = jm.DiT(jm.DiTConfig(**DIT_KW))
        params = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)),
                                   _jcond({k: v[:1] for k, v in _cond_np(0, concat > 0).items()}))
        _JAX_DITS[concat, seed] = net, perturbed(params, seed + 1)
    return _JAX_DITS[concat, seed]


def port_dit(params, **kw):
    cfg = DiTConfig(**{**DIT_KW, **kw})
    net = DiT(cfg)
    net.load_state_dict(dit_from_jax(params, cfg))
    return net.eval()


def close(got, want, tol, msg=""):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0,
                               err_msg=msg)


# ---------------------------------------------------------------- DDPM on linear betas
@pytest.mark.parametrize("n", [4, 16])
def test_ddpm_linear_beta_tables_match_jax(jax_ref, n):
    """The teacher's DDPM tables on Pixart's linear betas (1e-4 → 0.02)
    equal JAX's from the JAX example's ``SchedulerConfig``, in fp32; the
    full training tables too; and they are not the scaled-linear tables of
    ``SchedulerConfig()``, which would diverge without an error."""
    jcfg = JSchedulerConfig(beta_schedule="linear", beta_start=0.0001, beta_end=0.02)
    got, want = ddpm.set_timesteps(PIXART_SCHEDULER, n), jddpm.set_timesteps(jcfg, n)
    assert got.timesteps == np.asarray(want.timesteps).tolist()
    for name in ("sqrt_acp_t", "sqrt_1macp_t", "x0_coeff", "sample_coeff", "sigma_noise"):
        assert np.asarray(getattr(got, name), np.float32).tolist() == np.asarray(getattr(want, name)).tolist(), name
    assert np.array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))
    for a, b in zip(training_tables(PIXART_SCHEDULER), jtraining_tables(jcfg)):
        np.testing.assert_array_equal(a, b)
    scaled = ddpm.set_timesteps(SchedulerConfig(), n)
    assert abs(float(got.alphas_cumprod[500]) - float(scaled.alphas_cumprod[500])) > 1e-2


# ---------------------------------------------------------------- the DiT
def test_dit_remat_gives_the_same_forward_and_gradients():
    """``remat`` recomputes each block in the backward: the output and the
    gradients of the input and of every LoRA factor are bit-equal to the
    plain module's, and without a gradient nothing is checkpointed."""
    torch.manual_seed(0)
    plain = DiT(DiTConfig(**DIT_KW)).requires_grad_(False)
    rematted = DiT(DiTConfig(**DIT_KW, remat=True)).requires_grad_(False)
    rematted.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(1)
    lora = init_lora(plain, 3, g)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.1
    x = torch.randn(B, HW, HW, C, generator=g)
    t = torch.tensor([999, 259])
    cond = _tcond(_cond_np(2))
    w = torch.randn(B, HW, HW, C, generator=g)
    grads = []
    for net in (plain, rematted):
        pairs = {k: {n: v.clone().requires_grad_() for n, v in ab.items()} for k, ab in lora.items()}
        for name, ab in pairs.items():
            net.get_submodule(name).lora = (ab["a"], ab["b"], 0.5)
        xi = x.clone().requires_grad_()
        out = net(xi, t, cond)
        (out * w).sum().backward()
        grads.append((out.detach(), xi.grad, [ab[k].grad for ab in pairs.values() for k in ("a", "b")]))
    (o1, x1, l1), (o2, x2, l2) = grads
    assert torch.equal(o1, o2) and torch.equal(x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(l1, l2)) and len(l1) == 2 * 10 * DIT_KW["depth"]
    with torch.no_grad():
        assert torch.equal(rematted(x, t, cond), o1)


@pytest.mark.parametrize("concat", [0, 2])
def test_dit_return_features_and_concat_match_jax(jax_ref, concat):
    """``return_features=True`` gives (the fp32 output, that output in the
    compute dtype: the GAN's features) as JAX; a ``concat`` conditioning is
    concatenated to the latents' channels before the patchify (the patch
    convolution 4 + 2 wide, ``concat_channels``) and the output cropped back
    to 4. 1e-5 of max(1, max|out|)."""
    net, params = jax_dit(concat)
    x = np.random.default_rng(4).standard_normal((B, HW, HW, C)).astype(np.float32)
    t = np.array([999.0, 259.0], np.float32)
    cond = _cond_np(5, concat > 0)
    want, wfeat = jax.jit(lambda p, x, t, c: net.apply(p, x, t, c, return_features=True))(
        params, jnp.asarray(x), jnp.asarray(t), _jcond(cond))
    port = port_dit(params, concat_channels=concat)
    with torch.no_grad():
        got, feat = port(t_(x), t_(t), _tcond(cond), return_features=True)
    assert got.shape == (B, HW, HW, C) and got.dtype == feat.dtype == torch.float32
    assert port.pos_embed.proj.in_channels == C + concat
    tol = 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), atol=tol, rtol=0)
    assert torch.equal(feat, got)


# ---------------------------------------------------------------- the LoRA tree
def test_dit_lora_tree_maps_one_to_one_onto_jax_lora_paths(jax_ref):
    """JAX ``lora_paths`` over the DiT: per block attn1/attn2 q, k, v, out
    and ff_in/ff_out, plus the root ``proj_out``. Mapped to port names they
    are the port's ``lora_paths`` (and ``init_lora``'s keys) one to one, but
    the root ``proj_out``, which maps to None and which the port's tree
    leaves out."""
    _, params = jax_dit()
    jpaths = jlora.lora_paths(params)
    assert len(jpaths) == 10 * DIT_KW["depth"] + 1
    assert [p for p in jpaths if lora_path_to_port(p, None) is None] == [f"params/{DIT_INERT_LORA}/kernel"]
    mapped = [lora_path_to_port(p, None) for p in jpaths if lora_path_to_port(p, None) is not None]
    port = port_dit(params)
    assert len(set(mapped)) == len(mapped) and set(mapped) == set(lora_paths(port))
    assert "transformer_blocks.1.attn2.to_out.0" in mapped and "transformer_blocks.0.ff.net.2" in mapped
    assert set(init_lora(port, 4, torch.Generator().manual_seed(0))) == set(mapped)
    tree = jlora.init_lora(params, 2, jax.random.PRNGKey(3))
    assert set(lora_from_jax(tree, port.config)) == set(mapped)


# ---------------------------------------------------------------- the step
def _flash_kw():
    """Stage 1 of two: distill 1.0, DMD 0.3, adversarial 0.1, as
    ``flash_pixart.yaml``'s stage 1; DDPM teacher, l2, hinge."""
    return dict(K=[K, K], num_iterations_per_K=[2, 2], guidance_scale_min=3.0, guidance_scale_max=7.0,
                distill_loss_type="l2", mixture_num_components=4, use_dmd_loss=True, gan_loss_type="hinge",
                distill_loss_scale=1.0, dmd_loss_scale=[0.0, 0.3], adversarial_loss_scale=[0.0, 0.1],
                use_empty_prompt=True)


@pytest.fixture(scope="module")
def pixart_step(jax_ref):
    """The tiny Pixart FlashDiffusion in both packages (DDPM teacher on
    linear betas, a 2-stage 8-feature discriminator over the 4-channel
    output latents), perturbed weights, a non-zero LoRA B (the JAX root
    ``proj_out`` pair included), pre-staged ``__z``/``__conds`` (the uncond
    zeroes the T5 states, keeps mask and vector, as the ucg of the text
    key does), and a JAX key whose start index is 1 (three rollout steps
    with posterior noise)."""
    net, dparams = jax_dit(seed=6)
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=2))
    disc_params = perturbed(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((B, HW, HW, C))), 4)
    lora = perturbed(jlora.init_lora(dparams, 2, jax.random.PRNGKey(5)), 6)
    jsched = JSchedulerConfig(beta_schedule="linear", beta_start=0.0001, beta_end=0.02)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**_flash_kw()), student_module=net, teacher_module=net,
                             scheduler_config=jsched, discriminator=jdisc, lora_scaling=0.5)
    z = np.random.default_rng(18).standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [_cond_np(19), _cond_np(20), _cond_np(19)]
    conds[2]["crossattn"][:] = 0.0
    stage = 1
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if int(jcommon.sample_start_index(jax.random.split(k, 8)[3], jmodel.stage_pdfs[stage])) == 1)
    jbatch = {"__z": jnp.asarray(z), "__conds": tuple(_jcond(c) for c in conds)}
    loss_fn = lambda tr: jmodel.losses(tr, {"teacher": dparams}, jbatch, key, stage)
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"lora": lora, "disc": disc_params})

    dit = port_dit(dparams).requires_grad_(False)
    dcfg = DiscriminatorConfig(feature_dim=8, num_stages=2)
    disc = ConvDiscriminator(dcfg, in_channels=C)
    disc.load_state_dict(discriminator_from_jax(disc_params, dcfg))
    tmodel = FlashDiffusion(FlashDiffusionConfig(**_flash_kw()), dit, scheduler_config=PIXART_SCHEDULER,
                            discriminator=disc, lora_scaling=0.5)
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()} for k, ab in lora_from_jax(lora, dit.config).items()}
    tmodel.attach_lora(tl)
    tbatch = {"__z": t_(z), "__conds": tuple(_tcond(c) for c in conds)}
    draws = jax_step_draws(jmodel, key, stage, z)
    want = dict(total=total, aux=aux, lora=grads["lora"], disc=discriminator_from_jax(grads["disc"], dcfg))
    return dict(tmodel=tmodel, tl=tl, batch=tbatch, draws=draws, stage=stage, want=want, jax=(net, dparams, lora))


def test_pixart_flash_step_losses_and_grads_match_jax(pixart_step):
    """``losses`` and the LoRA and discriminator gradients of one backward
    vs ``jax.value_and_grad(FlashDiffusion.losses)``: the DDPM rollout from
    start index 1 on linear betas with the JAX posterior noises, DMD and
    both hinge losses over the DiT's output latents, every draw the JAX
    key's. Tolerance 1e-4 of max(1, max|want|) per tensor: on linear betas
    √ᾱ_t falls to 6.4e-3 at t = 999, so x̂₀ and the losses built on it
    reach ~1e4 here, where fp32 rounding alone is ~4e-7 relative."""
    s = pixart_step
    tmodel, tl, want = s["tmodel"], s["tl"], s["want"]
    assert s["draws"]["start_idx"] == 1 and len(s["draws"]["rollout_noise"]) == K - 1
    assert tmodel._sched_stochastic and tmodel.sched_config is PIXART_SCHEDULER
    total, aux = tmodel.losses(s["batch"], s["draws"], s["stage"])
    total.backward()
    close(total, want["total"], 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator", "guidance"):
        close(aux[k], want["aux"][k], 1e-4, k)
    assert float(aux["loss/dmd"].detach()) != 0.0 and float(aux["loss/gan_d"].detach()) != 0.0
    assert aux["start_timestep"] == int(want["aux"]["start_timestep"]) == tmodel.stage_schedules[1].timesteps[1]
    jgrads = lora_from_jax(want["lora"], tmodel.teacher_module.config)
    assert set(jgrads) == set(tl)
    for name, ab in tl.items():
        for k in ("a", "b"):
            close(ab[k].grad, jgrads[name][k], 1e-4, f"{name}.{k}")
    for name, p in tmodel.discriminator.named_parameters():
        close(p.grad, want["disc"][name], 1e-4, name)


def test_jax_root_proj_out_lora_pair_is_inert(pixart_step):
    """The pair JAX gives the DiT's root ``proj_out`` (a plain ``nn.Dense``)
    is inert, so the port may leave it out: its gradient in the step is
    exactly 0 (so Adam moves neither A nor B; decay only shrinks A, which
    nothing reads, and B stays where it starts, at 0), and the DiT's output
    is the same with that pair's B set to anything."""
    net, params, lora = pixart_step["jax"]
    grad = pixart_step["want"]["lora"]["params"][DIT_INERT_LORA]["kernel"]
    assert set(grad) == {"a", "b"} and not any(np.asarray(g).any() for g in grad.values())
    pair = lora["params"][DIT_INERT_LORA]["kernel"]
    assert np.asarray(pair["b"]).any()
    x = np.random.default_rng(21).standard_normal((B, HW, HW, C)).astype(np.float32)
    t, cond = jnp.asarray([999.0, 259.0]), _jcond(_cond_np(22))
    forward = jax.jit(lambda b: net.apply({**params, "lora": jlora.lora_collection(
        {"params": {**lora["params"], DIT_INERT_LORA: {"kernel": {"a": pair["a"], "b": b}}}}, 0.5)},
        jnp.asarray(x), t, cond))
    outs = [np.asarray(forward(b)) for b in (np.zeros_like(pair["b"]), pair["b"], np.full_like(pair["b"], 3.0))]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


# ---------------------------------------------------------------- build_trainer
TINY_PIXART = dict(DIT_KW, caption_channels=16, sample_size=32)
TINY_T5 = dict(vocab_size=32128, d_model=16, d_ff=32, d_kv=8, num_layers=1, num_heads=2)


def tiny_pixart_modules(monkeypatch):
    """``sample``'s Pixart configs replaced by tiny ones: the DiT above (its
    caption projection 16 wide), the 2-level VAE (latents / 2), a 1-layer
    T5 of width 16 over the full T5 vocabulary."""
    from flash_diffusion_tpu_torch import sample

    base = {k: v for k, v in TINY_PIXART.items() if k != "num_vector_embeds"}
    monkeypatch.setattr(sample, "pixart_config", lambda **kw: DiTConfig(**base, **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda **kw: AutoencoderKLConfig(**VAE_KW, **kw))
    monkeypatch.setattr(sample, "T5TextEmbedderConfig",
                        lambda **kw: T5TextEmbedderConfig(**kw, text_embedder_config=TINY_T5))


def test_build_trainer_reads_flash_pixart_yaml(monkeypatch):
    """``build_trainer("pixart")`` maps ``flash_pixart.yaml`` onto the model:
    K = 16, DDPM on the linear-beta tables, l2 distill (no LPIPS module),
    DMD, hinge, the empty-prompt uncond, guidance 3–7, the loss scales; the
    64-feature, 3-stage discriminator over the 4 latent channels; T5 and the
    raw [h, w, aspect ratio] conditioner; the DiT's ``remat`` and 10 LoRA
    pairs a block; the DiT in bf16, T5 in fp32 over bf16-rounded weights."""
    import yaml

    tiny_pixart_modules(monkeypatch)
    with open(train.CONFIGS["pixart"]) as f:
        want = yaml.safe_load(f)
    trainer = train.build_trainer("pixart", device="cpu", config={**want, "LORA_RANK": 4, "IMAGE_SIZE": 64})
    model, mc = trainer.model, trainer.model.config
    assert (mc.K, mc.num_iterations_per_K) == (want["K"], want["NUM_ITERATIONS_PER_K"]) and mc.K[1] == 16
    assert (mc.distill_loss_scale, mc.dmd_loss_scale, mc.adversarial_loss_scale) == (
        want["DISTILL_LOSS_SCALE"], want["DMD_LOSS_SCALE"], want["ADVERSARIAL_LOSS_SCALE"])
    assert (mc.distill_loss_type, mc.gan_loss_type, mc.use_dmd_loss, mc.use_empty_prompt) == (
        "l2", "hinge", True, True)
    assert (mc.guidance_scale_min, mc.guidance_scale_max) == ([3.0] * 4, [7.0] * 4)
    assert model.teacher_sched_mod is ddpm and model._sched_stochastic and model.sched_config is PIXART_SCHEDULER
    np.testing.assert_array_equal(model.alphas_cumprod.numpy(),
                                  training_tables(PIXART_SCHEDULER)[0].astype(np.float32))
    assert model.lpips is None and isinstance(model.teacher_module, DiT)
    dc = model.discriminator.config
    assert (dc.feature_dim, dc.num_stages, dc.norm_groups, model.discriminator.conv_0.in_channels) == (64, 3, 4, 4)
    t5, vec = model.conditioner.conditioners
    assert isinstance(t5, T5TextEmbedder) and isinstance(vec, RawVectorEmbedder)
    assert [c.input_key for c in (t5, vec)] == ["text", "resolution_ar"]
    assert model.teacher_module.config.remat and model.lora_scaling == lora_scaling(4)
    assert len(trainer.lora) == 10 * DIT_KW["depth"] and all(ab["a"].shape[1] == 4 for ab in trainer.lora.values())
    assert trainer.opt_g.lr == trainer.opt_d.lr == float(want["LR"])
    assert model.teacher_module.proj_out.weight.dtype == torch.bfloat16
    w = t5.module.shared.weight
    assert w.dtype == torch.float32 and torch.equal(w, w.bfloat16().float())


def test_pixart_trainer_steps_on_tiny_modules(monkeypatch):
    """One ``fit`` step of ``build_trainer("pixart")`` (``flash_pixart.yaml``
    at 64², stage 1, tiny modules) on ``synthetic_batches(model="pixart")``:
    finite losses, every LoRA B factor and the discriminator changed, the
    DiT, VAE and T5 bit-identical."""
    tiny_pixart_modules(monkeypatch)
    cfg = {**train.load_config(train.CONFIGS["pixart"]), "LORA_RANK": 4, "IMAGE_SIZE": 64,
           "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
    trainer = train.build_trainer("pixart", device="cpu", config=cfg)
    model = trainer.model
    snap = lambda ms: [t.detach().clone() for m in ms for t in m.state_dict().values()]
    frozen_modules = (model.teacher_module, model.vae, model.conditioner)
    frozen, disc = snap(frozen_modules), snap([model.discriminator])
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    aux = trainer.fit(train.synthetic_batches(2, 64, model="pixart"), max_steps=1)
    assert trainer.step == 1 and model.stage_for_iteration(1) == 1
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items())
    assert not all(torch.equal(a, b) for a, b in zip(disc, snap([model.discriminator])))
    assert all(torch.equal(a, b) for a, b in zip(frozen, snap(frozen_modules)))


def test_synthetic_batches_pixart_keys_and_shapes():
    """``model="pixart"``: T5-style ids [B, 120] (tokens ≥ 3, one EOS 1,
    padding 0), ``text_mask`` 1 up to the EOS, ``resolution_ar`` [size,
    size, 1.0], as ``train_flash_pixart.py`` makes them."""
    batch = next(train.synthetic_batches(3, 64, seed=2, model="pixart"))
    assert set(batch) == {"image", "text_ids", "text_mask", "resolution_ar"}
    ids, mask = batch["text_ids"], batch["text_mask"]
    assert batch["image"].shape == (3, 64, 64, 3) and ids.shape == mask.shape == (3, 120)
    for row, m in zip(ids, mask):
        n = int(m.sum())
        assert row[n - 1] == 1 and (row[: n - 1] >= 3).all() and not row[n:].any() and m[:n].all()
    np.testing.assert_array_equal(batch["resolution_ar"], [[64.0, 64.0, 1.0]] * 3)
    assert batch["resolution_ar"].dtype == np.float32
    assert next(train.synthetic_batches(1, 64, max_length=16, model="pixart"))["text_ids"].shape == (1, 16)


# ---------------------------------------------------------------- int8
def test_quantize_dense_matches_jax_on_the_tiny_dit(jax_ref):
    """The same layers as JAX ``quantize_dense`` (10 a block; not the root
    ``proj_out`` head, the caption projection or the adaLN linears), each
    with JAX's codes and scale, bit for bit."""
    _, params = jax_dit(seed=8)
    cfg = DiTConfig(**DIT_KW)
    jq, jn = jquant.quantize_dense(params, min_dim=MIN_DIM)
    state, n = quantize_dense(dit_from_jax(params, cfg), min_dim=MIN_DIM)
    want = dit_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), jq), cfg)
    assert n == jn == 10 * DIT_KW["depth"]
    scales = {k[: -len(SCALE_KEY)] for k in state if k.endswith(SCALE_KEY)}
    assert len(scales) == n and "proj_out." not in scales
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    jscales = [np.asarray(v) for p, v in flat if str(p[-1]).strip("[]'\"") == jquant.SCALE_KEY]
    assert sorted(s.tolist() for s in jscales) == sorted(state[k + SCALE_KEY].tolist() for k in scales)
    for key, t in state.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.float().numpy(), want[key].numpy())


def test_quantize_dense_counts_280_layers_of_the_pixart_dit():
    """The full Pixart-α DiT, built on the meta device: 28 blocks × 10
    (attn1/attn2 q, k, v, out, ff.net.0.proj, ff.net.2); the root head, the
    caption projection and the adaLN linears stay float."""
    with torch.device("meta"):
        state = DiT(pixart_config(num_vector_embeds=3)).state_dict()
    out, n = quantize_dense(state)
    assert n == 280
    names = [k[: -len(".weight")] for k, t in out.items() if t.dtype == torch.int8]
    assert all(k.startswith("transformer_blocks.") for k in names)
    assert sum(k.endswith(("ff.net.0.proj", "ff.net.2")) for k in names) == 56


def test_int8_dit_forward_matches_jax(jax_ref):
    """One forward of the tiny DiT on ``quantize_dense`` in fp32 against the
    JAX DiT on JAX's ``quantize_dense``, to twice JAX's own int8 spread
    (a code flipped by fp32 rounding grows through the blocks; see
    ``tests/test_torch_quant.py``), and the int8 route really differs from
    the float one (by 3× that distance)."""
    net, params = jax_dit(seed=8)
    qparams, jn = jquant.quantize_dense(params, min_dim=MIN_DIM)
    x = np.random.default_rng(9).standard_normal((B, HW, HW, C)).astype(np.float32)
    t, cond = np.array([999.0, 259.0], np.float32), _cond_np(10)
    forward = jax.jit(lambda p, x: net.apply(p, x, jnp.asarray(t), _jcond(cond)))
    want = forward(qparams, x)
    spread = int8_spread(lambda x: forward(qparams, x), x)
    port = DiT(DiTConfig(**DIT_KW)).eval()
    state, n = quantize_dense(dit_from_jax(params, port.config), min_dim=MIN_DIM)
    apply_weights(port, state)
    with torch.no_grad():
        got = port(t_(x), t_(t), _tcond(cond))
    assert n == jn
    err = rel_l2(got.numpy(), want)
    assert err <= 2 * spread, (err, spread)
    assert rel_l2(want, forward(params, x)) >= 3 * err
