"""The port's Pixart-α slice against the JAX package: T5, the DiT, their
conditioners, and the whole ``FlashPipeline.generate``.

Tiny configs are initialised in JAX, their params perturbed (so no bias or
norm parameter sits at its trivial init), carried to the port through
``utils/convert.py`` (``t5_from_jax``, ``dit_from_jax``), and both run in
fp32 on the same numpy inputs. Tolerances: 1e-5 for one T5 or DiT forward,
absolute up to outputs of 1 and relative above (fp32, the same math with
sums in another order; the DiT's outputs reach ~3); 1e-4 for the
slice's images, whose LCM steps scale a forward's differences by up to
1/sqrt(ᾱ_t). The randomness of the slice (latents and step noise) is drawn
with ``jax.random`` as ``flash_diffusion_tpu/pipelines.py`` draws it and
handed to the port. Tests marked ``cuda`` run a tiny Pixart slice through
the kernels on the card.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import FlashPipeline
from flash_diffusion_tpu_torch.models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    DiT,
    DiTConfig,
    T5Config,
    T5Encoder,
)
from flash_diffusion_tpu_torch.models import dit as tdit
from flash_diffusion_tpu_torch.models import text_encoders as tte
from flash_diffusion_tpu_torch.models.embedders import (
    ConditionerWrapper,
    RawVectorEmbedder,
    RawVectorEmbedderConfig,
    T5TextEmbedder,
    T5TextEmbedderConfig,
)
from flash_diffusion_tpu_torch.sample import PIXART_SCHEDULER, pixart_size_cond_fn
from flash_diffusion_tpu_torch.utils import dit_from_jax, t5_from_jax, vae_from_jax

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.models import dit as jdit
    from flash_diffusion_tpu.models import embedders as jemb
    from flash_diffusion_tpu.models import text_encoders as jte
    from flash_diffusion_tpu.pipelines import FlashPipeline as JFlashPipeline
    from flash_diffusion_tpu.schedulers.base import SchedulerConfig as JSchedulerConfig
    from flash_diffusion_tpu.schedulers.base import split_step_key, step_noise
    from flash_diffusion_tpu.utils import hf
except ImportError:
    jax = None

torch.set_num_threads(2)

T5_KW = dict(vocab_size=50, d_model=32, d_ff=48, d_kv=8, num_layers=2, num_heads=4,
             relative_buckets=8, relative_max_distance=16)
# Pixart-shaped: 3 vector chunks (height, width, aspect ratio), the T5 mask,
# pos-embed interpolation 2 (the 1024-MS checkpoints'), D = 16 heads
DIT_KW = dict(in_channels=4, out_channels=8, patch_size=2, hidden_size=48, depth=2, num_heads=3,
              caption_channels=32, num_vector_embeds=3, vector_embed_dim=16, sample_size=8,
              interpolation_scale=2.0)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
LATENT = (8, 8, 4)
SEQ = 12


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def tokenizer_fn(texts):
    """Ids and a padding mask that depend only on each prompt's text."""
    ids = np.stack([(np.arange(SEQ) * (len(t) + 3) + sum(map(ord, t))) % 50 for t in texts])
    mask = np.stack([(np.arange(SEQ) < 3 + len(t) % (SEQ - 3)) for t in texts]).astype(np.int32)
    return {"text_ids": ids.astype(np.int32), "text_mask": mask}


def _jax_t5(seed=0):
    net = jte.T5Encoder(jte.T5Config(**T5_KW))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32), jnp.ones((1, SEQ), jnp.int32))
    return net, perturbed(params, seed + 1)


def _port_t5(params):
    cfg = T5Config(**T5_KW)
    net = T5Encoder(cfg)
    net.load_state_dict(t5_from_jax(params, cfg))
    return net.eval()


_JAX_DITS = {}


def _jax_dit(seed=2, num_vector_embeds=3):
    """A JAX DiT and its perturbed params, built once per module."""
    key = (seed, num_vector_embeds)
    if key not in _JAX_DITS:
        net = jm.DiT(jm.DiTConfig(**{**DIT_KW, "num_vector_embeds": num_vector_embeds}))
        cond = {"cond": {"crossattn": jnp.zeros((1, SEQ, 32)), "attention_mask": jnp.ones((1, SEQ), jnp.int32),
                         "vector": jnp.zeros((1, 3))}}
        params = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *LATENT)), jnp.zeros((1,)), cond)
        _JAX_DITS[key] = net, perturbed(params, seed + 1)
    return _JAX_DITS[key]


def _port_dit(params, **kw):
    cfg = DiTConfig(**{**DIT_KW, **kw})
    net = DiT(cfg)
    net.load_state_dict(dit_from_jax(params, cfg))
    return net.eval()


def close(got, want, tol=1e-5):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def _dit_inputs(seed, mask=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *LATENT)).astype(np.float32)
    t = np.array([999.0, 259.0], np.float32)
    ctx = rng.standard_normal((2, SEQ, 32)).astype(np.float32)
    cond = {"crossattn": ctx, "vector": np.array([[64.0, 64.0, 1.0], [64.0, 96.0, 1.5]], np.float32)}
    if mask:
        cond["attention_mask"] = np.array([[1] * 5 + [0] * (SEQ - 5), [1] * SEQ], np.int32)
    return x, t, cond


@pytest.mark.parametrize("h,w,dim,base,interp", [(8, 8, 48, 4, 2.0), (4, 6, 32, 8, 1.0), (64, 64, 1152, 32, 1.0)])
def test_get_2d_sincos_pos_embed_matches_jax(jax_ref, h, w, dim, base, interp):
    want = jdit.get_2d_sincos_pos_embed(dim, h, w, base_size=base, interpolation_scale=interp)
    np.testing.assert_array_equal(tdit.get_2d_sincos_pos_embed(dim, h, w, base, interp), want)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16)])
def test_t5_rel_bucket_matches_jax(jax_ref, buckets, max_distance):
    """Every relative position of a 130-token sequence (Pixart's 120 and
    the 64-token bucket boundary included) lands in JAX's bucket."""
    pos = np.arange(130)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jte._t5_rel_bucket(jnp.asarray(rel), buckets, max_distance))
    got = tte._t5_rel_bucket(torch.from_numpy(rel), buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_encoder_matches_jax(jax_ref):
    """A tiny T5 (relative-position bias, unscaled attention, gated
    tanh-gelu) with a padded mask, through ``t5_from_jax``: 1e-5."""
    net, params = _jax_t5()
    ids = np.array([[3, 7, 1, 9, 4, 4, 0, 0, 0, 0, 0, 0], [5, 2, 8, 8, 1, 6, 3, 2, 9, 7, 1, 1]], np.int32)
    mask = (ids > 0).astype(np.int32)
    mask[1] = 1
    want = net.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    got = _port_t5(params)(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # and the port's state dict reads through the transformers importer
    sd = {k: v.numpy() for k, v in _port_t5(params).state_dict().items()}
    again = net.apply(hf.import_t5_encoder(sd, jte.T5Config(**T5_KW)), jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(again), np.asarray(want), atol=1e-5, rtol=0)


def test_t5_embedder_mask_and_force_zero(jax_ref):
    """``T5TextEmbedder`` surfaces the mask; ``force_zero`` zeroes crossattn
    but never the mask; no mask in the batch means all ones; and the
    wrapper carries the mask and ``RawVectorEmbedder``'s vector beside it."""
    cfg = dict(input_key="text", max_length=SEQ, text_embedder_config=T5_KW)
    jt5 = jemb.T5TextEmbedder(jemb.T5TextEmbedderConfig(**cfg))
    batch = tokenizer_fn(["a cat", "a much longer prompt"])
    params = perturbed(jt5.init(jax.random.PRNGKey(4), batch), 5)
    t5 = T5TextEmbedder(T5TextEmbedderConfig(**cfg))
    t5.module.load_state_dict(t5_from_jax(params, t5.encoder_config))
    for fz in (0.0, 1.0):
        want = jt5(params, batch, force_zero=fz)
        got = t5(batch, force_zero=fz)
        np.testing.assert_allclose(got["crossattn"].detach().numpy(), np.asarray(want["crossattn"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["attention_mask"].numpy(), np.asarray(want["attention_mask"]))
    assert got["crossattn"].abs().max().item() == 0.0 and got["attention_mask"].sum().item() > 0
    assert t5({"text_ids": batch["text_ids"]})["attention_mask"].eq(1).all()

    sizes = pixart_size_cond_fn(2, 1024, 768)
    jvec = jemb.RawVectorEmbedder(jemb.RawVectorEmbedderConfig(input_key="resolution_ar"))
    vec = RawVectorEmbedder(RawVectorEmbedderConfig(input_key="resolution_ar"))
    want = jvec.embed({}, sizes)["vector"]
    np.testing.assert_array_equal(vec.embed(sizes)["vector"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want), [[1024.0, 768.0, 0.75]] * 2)
    assert vec.embed({"resolution_ar": np.array([2.0, 3.0])})["vector"].shape == (2, 1)
    jwrap = jemb.ConditionerWrapper([jt5, jvec])
    wrap = ConditionerWrapper([t5, vec])
    full = {**batch, **sizes}
    want = jwrap([params, {}], full, set_ucg_rate_zero=True)["cond"]
    got = wrap(full, set_ucg_rate_zero=True)["cond"]
    assert set(got) == set(want) == {"crossattn", "attention_mask", "vector"}
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mask,raw", [(True, True), (False, True), (True, False)])
def test_dit_matches_jax(jax_ref, mask, raw):
    """A tiny Pixart-shaped DiT through ``dit_from_jax``: 3 vector chunks
    (raw [B, 3] scalars, or pre-embedded [B, 3·16]), the T5 mask as the
    cross-attention bias or none, interpolation scale 2. 1e-5 (``close``)."""
    net, params = _jax_dit()
    x, t, cond = _dit_inputs(6, mask)
    if not raw:
        cond["vector"] = np.random.default_rng(7).standard_normal((2, 48)).astype(np.float32)
    want = net.apply(params, jnp.asarray(x), jnp.asarray(t), {"cond": {k: jnp.asarray(v) for k, v in cond.items()}})
    got = _port_dit(params)(torch.from_numpy(x), torch.from_numpy(t),
                            {"cond": {k: torch.from_numpy(v) for k, v in cond.items()}})
    assert got.shape == (2, *LATENT) and got.dtype == torch.float32
    close(got.detach().numpy(), want)


def test_dit_state_dict_reads_through_import_pixart_dit(jax_ref):
    """A port DiT's ``state_dict()`` (no vector chunks: the 512 layout)
    through JAX ``import_pixart_dit`` reproduces the same output; and a
    stock 1024-MS layout (one resolution embedder for height and width, one
    aspect-ratio embedder) loads into the port through
    ``pixart_state_from_diffusers`` as ``import_pixart_dit`` reads it into
    JAX."""
    net, params = _jax_dit(num_vector_embeds=0)
    x, t, cond = _dit_inputs(8)
    del cond["vector"]
    port = _port_dit(params, num_vector_embeds=0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jcond = {"cond": {k: jnp.asarray(v) for k, v in cond.items()}}
    want = net.apply(hf.import_pixart_dit(sd, jm.DiTConfig(**{**DIT_KW, "num_vector_embeds": 0})),
                     jnp.asarray(x), jnp.asarray(t), jcond)
    got = port(torch.from_numpy(x), torch.from_numpy(t), {"cond": {k: torch.from_numpy(v) for k, v in cond.items()}})
    close(got.detach().numpy(), want)

    net3, params3 = _jax_dit()
    full = {k: v.numpy() for k, v in _port_dit(params3).state_dict().items()}
    stock = {k: v for k, v in full.items() if ".vector_embedders." not in k}
    for src, name in (("0", "resolution_embedder"), ("2", "aspect_ratio_embedder")):
        for leaf in ("linear_1.weight", "linear_1.bias", "linear_2.weight", "linear_2.bias"):
            stock[f"adaln_single.emb.{name}.{leaf}"] = full[f"adaln_single.emb.vector_embedders.{src}.{leaf}"]
    x, t, cond = _dit_inputs(9)
    want = net3.apply(hf.import_pixart_dit(stock, jm.DiTConfig(**DIT_KW)), jnp.asarray(x), jnp.asarray(t),
                      {"cond": {k: jnp.asarray(v) for k, v in cond.items()}})
    port3 = DiT(DiTConfig(**DIT_KW))
    port3.load_state_dict(tdit.pixart_state_from_diffusers({k: torch.from_numpy(v) for k, v in stock.items()}))
    got = port3.eval()(torch.from_numpy(x), torch.from_numpy(t),
                       {"cond": {k: torch.from_numpy(v) for k, v in cond.items()}})
    close(got.detach().numpy(), want)


@pytest.fixture(scope="module")
def pixart_pipelines():
    """The tiny Pixart stack in JAX and the port, with the same weights,
    built once per module."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    dit, dparams = _jax_dit(seed=10)
    vae = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW))
    vparams = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(12), jnp.zeros((1, 16, 16, 3))), 13)
    cfg = dict(input_key="text", max_length=SEQ, text_embedder_config=T5_KW)
    jt5 = jemb.T5TextEmbedder(jemb.T5TextEmbedderConfig(**cfg))
    tparams = perturbed(jt5.init(jax.random.PRNGKey(14), tokenizer_fn(["x"])), 15)
    jvec = jemb.RawVectorEmbedder(jemb.RawVectorEmbedderConfig(input_key="resolution_ar"))
    sched = JSchedulerConfig(beta_schedule="linear", beta_start=0.0001, beta_end=0.02)
    jpipe = JFlashPipeline(
        dit, dparams, conditioner=jemb.ConditionerWrapper([jt5, jvec]), conditioner_params=[tparams, {}],
        vae=vae, vae_params=vparams, tokenizer_fn=tokenizer_fn, scheduler_config=sched,
        latent_shape=LATENT, vae_scale_factor=2)
    jpipe.size_cond_fn = pixart_size_cond_fn

    t5 = T5TextEmbedder(T5TextEmbedderConfig(**cfg))
    t5.module.load_state_dict(t5_from_jax(tparams, t5.encoder_config))
    vcfg = AutoencoderKLConfig(**VAE_KW)
    tvae = AutoencoderKL(vcfg)
    tvae.load_state_dict(vae_from_jax(vparams, vcfg))
    pipe = FlashPipeline(
        _port_dit(dparams), ConditionerWrapper([t5, RawVectorEmbedder(RawVectorEmbedderConfig(
            input_key="resolution_ar"))]).eval(), tvae.eval(), tokenizer_fn, latent_shape=LATENT,
        vae_scale_factor=2, scheduler_config=PIXART_SCHEDULER)
    pipe.size_cond_fn = pixart_size_cond_fn
    return jpipe, pipe


@pytest.mark.parametrize("guidance_scale", [0.0, 2.0])
def test_pixart_slice_matches_jax_generate(pixart_pipelines, guidance_scale):
    """The whole slice: T5 with its mask and the [h, w, w/h] vector → 4 LCM
    steps on linear betas of the DiT → VAE decode, with the JAX draws
    injected. guidance 0 is the published setting; 2.0 takes the CFG branch
    (ucg zeroes the T5 embedding and the vector, never the mask). 1e-4."""
    jpipe, pipe = pixart_pipelines
    assert PIXART_SCHEDULER.beta_schedule == "linear" and pipe.sched_config is PIXART_SCHEDULER
    prompts = ["a raccoon reading a book", "an astronaut"]
    want = np.asarray(jpipe.generate(prompts, num_inference_steps=4, guidance_scale=guidance_scale, seed=5))
    rng, kz = jax.random.split(jax.random.PRNGKey(5))
    latents = jax.random.normal(kz, (2, *LATENT))
    noise, key = [], rng
    for _ in range(4):
        key, sub = split_step_key(key)
        noise.append(torch.tensor(np.asarray(step_noise(sub, latents))))
    got = pipe.generate(prompts, num_inference_steps=4, guidance_scale=guidance_scale,
                        latents=torch.tensor(np.asarray(latents)), noise=noise)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_build_modules_pixart_names():
    """``build_modules("pixart")`` builds what ``examples/sample.py`` builds
    for Pixart-α 1024² (on the meta device: no memory), and the CLIs offer it."""
    from flash_diffusion_tpu_torch import profiling, serve
    from flash_diffusion_tpu_torch.sample import MODELS, build_modules

    with torch.device("meta"):
        dit, vae, conds, towers, size_fn = build_modules("pixart")
    cfg = dit.config
    assert (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.patch_size, cfg.caption_channels,
            cfg.num_vector_embeds, cfg.in_channels, cfg.out_channels) == (1152, 28, 16, 2, 4096, 3, 4, 8)
    assert sum(p.numel() for p in dit.parameters()) == 611_595_680
    t5, vec = conds
    assert isinstance(t5, T5TextEmbedder) and isinstance(vec, RawVectorEmbedder)
    assert t5.config.max_length == 120 and (t5.ids_key, t5.mask_key) == ("text_ids", "text_mask")
    tc = t5.encoder_config
    assert (tc.d_model, tc.num_layers, tc.num_heads, tc.d_kv, tc.d_ff) == (4096, 24, 64, 64, 10240)
    assert vec.input_key == "resolution_ar" and towers == [("text_encoder", t5)]
    np.testing.assert_array_equal(size_fn(1, 1024, 1024)["resolution_ar"], [[1024.0, 1024.0, 1.0]])
    assert vae.config.scaling_factor == 0.18215
    assert (PIXART_SCHEDULER.beta_schedule, PIXART_SCHEDULER.beta_start, PIXART_SCHEDULER.beta_end) == (
        "linear", 0.0001, 0.02)
    assert "pixart" in MODELS and profiling.MODELS is MODELS and serve.MODELS is MODELS


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_pixart_slice_runs_through_the_kernels_on_card(cuda):
    """The tiny Pixart slice in bf16 on the card (T5 in fp32): finite
    images, the LayerNorm and GroupNorm kernels launched, and the images
    within a relative L2 error of 0.1 of the fp32 slice on the CPU."""
    from flash_diffusion_tpu_torch.ops import attention, norms

    torch.manual_seed(0)
    dit = DiT(DiTConfig(**DIT_KW))
    vcfg = AutoencoderKLConfig(**VAE_KW)
    vae = AutoencoderKL(vcfg)
    t5 = T5TextEmbedder(T5TextEmbedderConfig(input_key="text", max_length=SEQ, text_embedder_config=T5_KW))
    vec = RawVectorEmbedder(RawVectorEmbedderConfig(input_key="resolution_ar"))

    def make(device, dtype):
        p = FlashPipeline(
            DiT(DiTConfig(**DIT_KW)).to(device, dtype).eval(),
            ConditionerWrapper([t5, vec]).to(device).eval(),
            AutoencoderKL(vcfg).to(device, dtype).eval(), tokenizer_fn, latent_shape=LATENT,
            vae_scale_factor=2, scheduler_config=PIXART_SCHEDULER)
        p.denoiser.load_state_dict(dit.state_dict())
        p.vae.load_state_dict(vae.state_dict())
        p.size_cond_fn = pixart_size_cond_fn
        return p

    ref = make("cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    latents, noise = torch.randn(2, *LATENT, generator=g), [torch.randn(2, *LATENT, generator=g) for _ in range(4)]
    want = ref.generate(["a", "b"], latents=latents, noise=noise)
    pipe = make(cuda, torch.bfloat16)
    for d in (attention.LAUNCHES, norms.LAUNCHES):
        d.clear()
    images = pipe.generate(["a", "b"], latents=latents, noise=noise).cpu()
    torch.cuda.synchronize()
    assert images.shape == (2, 16, 16, 3) and torch.isfinite(images).all()
    # a GroupNorm is one resident launch, or the statistics then the apply
    assert norms.LAUNCHES["layer_norm"] > 0 and norms.LAUNCHES["group_norm_fused"] + norms.LAUNCHES["group_norm_stats"] > 0
    assert norms.LAUNCHES["group_norm_apply"] == norms.LAUNCHES["group_norm_stats"]
    assert ((images - want).norm() / want.norm()).item() < 0.1
