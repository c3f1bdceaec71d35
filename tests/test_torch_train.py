"""The port's Flash distillation step as a whole against the JAX package.

One tiny distillation step (the setup of ``tests/test_distill.py``: UNet
[16, 32], DMD and hinge GAN, K = [2, 2], batch 2; once with the ``l2``
distill loss and once with ``lpips`` through a tiny VAE decode to 16²),
with pre-staged ``__z``/``__conds``, the same weights (JAX params carried
by ``utils/convert.py``) and the same randomness: the draws are made with
``jax.random`` exactly as ``FlashDiffusion.losses`` splits its key and
handed to the port as ``draws``. fp32 on both sides; ``losses`` and the
LoRA and discriminator gradients agree to 1e-4 absolute (fp32 sums in
another order through the rollout, the student, DMD and the GAN branch).
The modules of the step have their own tests in ``test_torch_distill.py``.
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
from flash_diffusion_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig, UNet2DCondition, UNetConfig
from flash_diffusion_tpu_torch.utils import (
    discriminator_from_jax,
    lora_from_jax,
    lpips_from_jax,
    unet_from_jax,
    vae_from_jax,
)

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill import common as jcommon
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.distill.lpips import LPIPS as JLPIPS
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


# ---------------------------------------------------------------- the step
def jax_step_draws(jmodel, rng, stage, z):
    """The draws ``FlashDiffusion.losses`` makes from ``rng``, for the port.
    ``FlashDiffusionSD3.losses`` splits the key alike but draws no rollout
    noise (its flow-match rollout is deterministic), reads DMD's index into
    its full 1000-step schedule (``dmd_idx``) and the GAN's into
    ``gan_tail_indices``."""
    _, _, k_noise, k_start, k_guid, k_roll, k_dmd, k_gan = jax.random.split(rng, 8)
    cfg, b = jmodel.config, z.shape[0]
    sd3 = hasattr(jmodel, "full_schedule")
    start = int(jcommon.sample_start_index(k_start, jmodel.stage_pdfs[stage]))
    draws = {"start_idx": start, "noise": t_(jax.random.normal(k_noise, z.shape, z.dtype)),
             "guidance": t_(jax.random.uniform(k_guid))}
    if not sd3:
        key, roll = k_roll, []
        for _ in range(start, cfg.K[stage]):
            key, sub = jax.random.split(key)
            roll.append(t_(jax.random.normal(sub, z.shape, z.dtype)))
        draws["rollout_noise"] = roll
    kn, kt, kg = jax.random.split(k_dmd, 3)
    draws.update({"dmd_idx" if sd3 else "dmd_t": t_(jax.random.randint(kt, (b,), 0, 1000)).long()},
                 dmd_noise=t_(jax.random.normal(kn, z.shape, z.dtype)),
                 dmd_guidance=t_(jax.random.uniform(kg)))
    kt, kn = jax.random.split(k_gan)
    n_gan = len(cfg.gan_tail_indices if sd3 else cfg.gan_timesteps)
    draws.update(gan_idx=t_(jax.random.randint(kt, (b,), 0, n_gan)).long(),
                 gan_noise=t_(jax.random.normal(kn, z.shape, z.dtype)))
    return draws


@pytest.fixture(scope="module", params=["l2", "lpips"])
def step_setup(request):
    """The tiny FlashDiffusion of tests/test_distill.py (DMD, hinge GAN,
    K = [2, 2], batch 2) in both packages, with perturbed weights, a
    non-zero LoRA B, pre-staged ``__z``/``__conds``; with ``lpips`` also a
    tiny VAE decode to 16² and LPIPS-VGG16."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    loss_type = request.param
    net, uparams = jax_unet()
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=1))
    dparams = perturbed(jdisc.init(jax.random.PRNGKey(3), jnp.zeros((B, HW // 2, HW // 2, 32))), 4)
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6)
    kw = dict(K=[2, 2], num_iterations_per_K=[2, 2], guidance_scale_min=1.0, guidance_scale_max=3.0,
              distill_loss_type=loss_type, mixture_num_components=2, use_dmd_loss=True, gan_loss_type="hinge",
              lpips_crop=8, adversarial_loss_scale=[0.5, 1.0])
    frozen = {"teacher": uparams}
    jvae = jlp = None
    if loss_type == "lpips":
        jvae, jlp = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW)), JLPIPS()
        frozen["vae"] = perturbed(jax.jit(jvae.init)(jax.random.PRNGKey(7), jnp.zeros((1, HW, HW, 3))), 8)
        im = jnp.zeros((1, HW, HW, 3))
        frozen["lpips"] = perturbed(jax.jit(jlp.init)(jax.random.PRNGKey(9), im, im), 10, 0.01)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**kw), student_module=net, teacher_module=net, vae=jvae,
                             discriminator=jdisc, lpips=jlp, lora_scaling=0.5)
    rng = np.random.default_rng(18)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [rng.standard_normal((B, 8, 16)).astype(np.float32) for _ in range(3)]
    conds[2][:] = 0.0  # the dropped-text uncond
    jbatch = {"__z": jnp.asarray(z), "__conds": tuple({"cond": {"crossattn": jnp.asarray(c)}} for c in conds)}
    stage, key = 1, jax.random.PRNGKey(19)
    loss_fn = lambda tr: jmodel.losses(tr, frozen, jbatch, key, stage)
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"lora": lora, "disc": dparams})

    ucfg = UNetConfig(**UNET_KW)
    vae = lp = None
    if loss_type == "lpips":
        vae = AutoencoderKL(AutoencoderKLConfig(**VAE_KW))
        vae.load_state_dict(vae_from_jax(frozen["vae"], vae.config))
        lp = LPIPS()
        lp.load_state_dict(lpips_from_jax(frozen["lpips"]))
    dcfg = DiscriminatorConfig(feature_dim=8, num_stages=1)
    disc = ConvDiscriminator(dcfg, in_channels=32)
    disc.load_state_dict(discriminator_from_jax(dparams, dcfg))
    tmodel = FlashDiffusion(FlashDiffusionConfig(**kw), port_unet(uparams).requires_grad_(False), vae=vae,
                            discriminator=disc, lpips=lp, lora_scaling=0.5)
    for m in (vae, lp):
        if m is not None:
            m.requires_grad_(False).eval()
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()} for k, ab in lora_from_jax(lora, ucfg).items()}
    tmodel.attach_lora(tl)
    tbatch = {"__z": t_(z), "__conds": tuple({"cond": {"crossattn": t_(c)}} for c in conds)}
    draws = jax_step_draws(jmodel, key, stage, z)
    want = dict(total=total, aux=aux, lora=lora_from_jax(grads["lora"], ucfg),
                disc=discriminator_from_jax(grads["disc"], dcfg))
    return tmodel, tl, tbatch, draws, stage, want


def test_flash_step_losses_and_grads_match_jax(step_setup):
    """``losses`` and the LoRA and discriminator gradients of one backward
    vs ``jax.value_and_grad(FlashDiffusion.losses)``. Tolerance 1e-4."""
    tmodel, tl, batch, draws, stage, want = step_setup
    for ab in tl.values():
        for v in ab.values():
            v.grad = None
    tmodel.discriminator.zero_grad(set_to_none=True)
    total, aux = tmodel.losses(batch, draws, stage)
    total.backward()
    close(total, want["total"], 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator", "guidance"):
        close(aux[k], want["aux"][k], 1e-4, k)
    assert aux["start_timestep"] == int(want["aux"]["start_timestep"])
    for name, ab in tl.items():
        for k in ("a", "b"):
            close(ab[k].grad, want["lora"][name][k], 1e-4, f"{name}.{k}")
    for name, p in tmodel.discriminator.named_parameters():
        close(p.grad, want["disc"][name], 1e-4, name)


def lora_step(tmodel, tl, batch, draws, stage, **cfg):
    """``losses`` and the gradients of the LoRA leaves (by name) and of the
    discriminator with ``tmodel.config``'s fields set to ``cfg`` and fresh
    copies of ``tl`` attached; ``tmodel`` as it was after."""
    saved = {k: getattr(tmodel.config, k) for k in cfg}
    copies = {n: {k: v.detach().clone().requires_grad_() for k, v in ab.items()} for n, ab in tl.items()}
    leaves = [(f"{n}.{k}", v) for n, ab in copies.items() for k, v in ab.items()]
    disc = list(tmodel.discriminator.named_parameters())
    try:
        for k, v in cfg.items():
            setattr(tmodel.config, k, v)
        tmodel.attach_lora(copies)
        merged = tmodel.merged_student
        total, aux = tmodel.losses(batch, draws, stage)
        grads = torch.autograd.grad(total, [v for _, v in leaves + disc], allow_unused=True)
    finally:
        for k, v in saved.items():
            setattr(tmodel.config, k, v)
        tmodel.attach_lora(tl)
    grads = [torch.zeros_like(v) if g is None else g for (_, v), g in zip(leaves + disc, grads)]
    return dict(total=total.detach(), aux={k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()},
                grads=dict(zip([n for n, _ in leaves + disc], grads)), merged=merged, n_lora=len(leaves))


def check_merge_step(tmodel, tl, batch, draws, stage, want, cmp=close):
    """``lora_mode="merge"`` on the dense tree equals JAX's side-path step
    (the same function) to 1e-4 (``cmp``, the file's own comparison);
    ``remat_student_merge`` is bit-equal to it."""
    merge = lora_step(tmodel, tl, batch, draws, stage, lora_mode="merge")
    assert merge["merged"] and not tmodel.merged_student
    cmp(merge["total"], want["total"], 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator"):
        cmp(merge["aux"][k], want["aux"][k], 1e-4, k)
    names = list(merge["grads"])
    for name in names[:merge["n_lora"]]:
        layer, k = name.rsplit(".", 1)
        cmp(merge["grads"][name], want["lora"][layer][k], 1e-4, name)
    for name in names[merge["n_lora"]:]:
        cmp(merge["grads"][name], want["disc"][name], 1e-4, name)
    remat = lora_step(tmodel, tl, batch, draws, stage, lora_mode="merge", remat_student_merge=True)
    assert torch.equal(remat["total"], merge["total"])
    assert all(torch.equal(torch.as_tensor(remat["aux"][k]), torch.as_tensor(v)) for k, v in merge["aux"].items())
    assert all(torch.equal(remat["grads"][n], g) for n, g in merge["grads"].items())


def test_flash_merge_step_matches_jax(step_setup):
    """The student on merged weights W + s·Δ (``lora_mode="merge"``, JAX's
    merge path) over the dense tree: the losses and gradients equal
    JAX's step to 1e-4, and ``remat_student_merge`` (the student's forward
    one checkpointed segment) leaves them bit for bit."""
    tmodel, tl, batch, draws, stage, want = step_setup
    check_merge_step(tmodel, tl, batch, draws, stage, want)


def test_flash_step_gradients_partition(step_setup):
    """loss_G puts no gradient into the discriminator, loss_D none into LoRA."""
    tmodel, tl, batch, draws, stage, _ = step_setup
    leaves = [v for ab in tl.values() for v in ab.values()]
    disc = list(tmodel.discriminator.parameters())
    _, aux = tmodel.losses(batch, draws, stage)
    g_lora = torch.autograd.grad(aux["loss/generator"], leaves + disc, allow_unused=True)
    assert all(g is None or not g.any() for g in g_lora[len(leaves):])
    assert any(g is not None and g.any() for g in g_lora[:len(leaves)])
    _, aux = tmodel.losses(batch, draws, stage)
    g_disc = torch.autograd.grad(aux["loss/gan_d"], leaves + disc, allow_unused=True)
    assert all(g is None or not g.any() for g in g_disc[:len(leaves)])
    assert any(g is not None and g.any() for g in g_disc[len(leaves):])


