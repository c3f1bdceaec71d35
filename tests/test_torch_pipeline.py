"""The port's whole SD1.5 and SDXL slices against the JAX ``FlashPipeline.generate``.

Tiny CLIP → 4 LCM steps of a tiny SD1.5-shaped UNet → tiny VAE decode (and
the SDXL stack: two CLIP towers, the size embeddings through
``size_cond_fn``, an SDXL-shaped UNet with vector conditioning), with
the same weights (JAX params carried by ``utils/convert.py``) and the same
randomness: the initial latents and the per-step LCM noise are drawn with
``jax.random`` exactly as ``flash_diffusion_tpu/pipelines.py`` draws them
(``split_step_key``/``step_noise``) and handed to the port. fp32 on both
sides. Tolerance 1e-3 absolute on images in [-1, 1]: each LCM step divides
the noise estimate by sqrt(ᾱ_t) (≈ 0.068 at t = 999), which scales the
1e-5-level fp32 differences of one forward by ~15.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import FlashPipeline
from flash_diffusion_tpu_torch.config import BaseConfig
from flash_diffusion_tpu_torch.models import AutoencoderKL, UNet2DCondition
from flash_diffusion_tpu_torch.models import AutoencoderKLConfig as TVAEConfig
from flash_diffusion_tpu_torch.models import UNetConfig as TUNetConfig
from flash_diffusion_tpu_torch.models.embedders import (
    ClipEmbedder,
    ClipEmbedderConfig,
    ConditionerWrapper,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from flash_diffusion_tpu_torch.sample import SIZE_KEYS, size_cond_fn
from flash_diffusion_tpu_torch.schedulers import SchedulerConfig, lcm
from flash_diffusion_tpu_torch.utils import clip_text_from_jax, unet_from_jax, vae_from_jax

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.models import embedders as jemb
    from flash_diffusion_tpu.pipelines import FlashPipeline as JFlashPipeline
    from flash_diffusion_tpu.schedulers.base import split_step_key, step_noise
except ImportError:
    jax = None

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_KW = dict(
    in_channels=4, out_channels=4, block_out_channels=[16, 32],
    down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
    num_heads=[2, 2], cross_attention_dim=32,
    norm_num_groups=8,
)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=2, max_positions=16, eos_token_id=99)
LATENT = (8, 8, 4)


# SDXL-shaped: DownBlock2D first, depths [1, 2], D = 64 heads, crossattn =
# CLIP-L-like 32 + CLIP-G-like 32, vector = G's projection 24 + 3 sizes × 8
SDXL_UNET_KW = dict(
    in_channels=4, out_channels=4, block_out_channels=[32, 128],
    down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"], layers_per_block=1,
    transformer_layers_per_block=[1, 2], num_heads=[1, 2], cross_attention_dim=64,
    norm_num_groups=8, class_embed_type="projection", projection_class_embeddings_input_dim=72,
)
SIZE_CHANNELS = 8


def sdxl_conditioner_kw():
    """ClipEmbedderConfig kwargs of the two towers, as the sdxl branch of
    ``examples/sample.py`` sets them, at tiny widths."""
    clip_l = dict(input_key="text", layer="hidden", layer_idx=-2, text_embedder_config=CLIP_KW)
    clip_g = dict(input_key="text", layer="hidden", layer_idx=-2, always_return_pooled=True,
                  use_projection=True,
                  text_embedder_config=dict(CLIP_KW, num_layers=3, hidden_act="gelu", projection_dim=24))
    return clip_l, clip_g


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


def tokenizer_fn(texts):
    """Deterministic ids that depend only on each prompt's text, with EOS
    at a prompt-dependent spot."""
    ids = np.stack([(np.arange(16) * (len(t) + 3) + sum(map(ord, t))) % 99 for t in texts])
    for i, t in enumerate(texts):
        ids[i, 4 + len(t) % 10] = 99
    return {"text_ids": ids.astype(np.int32)}


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params
    )


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX pipeline and its (perturbed) params, built once per module."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    unet = jm.UNet2DCondition(jm.UNetConfig(**UNET_KW))
    uparams = perturbed(jax.jit(unet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
        {"cond": {"crossattn": jnp.zeros((1, 16, 32))}},
    ), 1)
    vae = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW))
    vparams = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), 2)
    clip = jemb.ClipEmbedder(jemb.ClipEmbedderConfig(
        input_key="text", layer="last", text_embedder_config=CLIP_KW))
    cparams = perturbed(clip.init(jax.random.PRNGKey(2), {"text_ids": jnp.zeros((1, 16), jnp.int32)}), 3)
    pipe = JFlashPipeline(
        unet, uparams, conditioner=jemb.ConditionerWrapper([clip]), conditioner_params=[cparams],
        vae=vae, vae_params=vparams, tokenizer_fn=tokenizer_fn, latent_shape=LATENT,
        vae_scale_factor=2,
    )
    return pipe, uparams, vparams, cparams


def port_pipeline(uparams, vparams, cparams):
    ucfg, vcfg = TUNetConfig(**UNET_KW), TVAEConfig(**VAE_KW)
    unet = UNet2DCondition(ucfg)
    unet.load_state_dict(unet_from_jax(uparams, ucfg))
    vae = AutoencoderKL(vcfg)
    vae.load_state_dict(vae_from_jax(vparams, vcfg))
    clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=CLIP_KW))
    clip.module.load_state_dict(clip_text_from_jax(cparams, clip.encoder_config))
    return FlashPipeline(
        unet.eval(), ConditionerWrapper([clip]).eval(), vae.eval(), tokenizer_fn,
        latent_shape=LATENT, vae_scale_factor=2,
    )


@pytest.fixture(scope="module")
def jax_sdxl_pipeline():
    """The tiny SDXL stack in JAX and its (perturbed) params, built once."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    unet = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    uparams = perturbed(jax.jit(unet.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
        {"cond": {"crossattn": jnp.zeros((1, 16, 64)), "vector": jnp.zeros((1, 72))}},
    ), 5)
    vae = jm.AutoencoderKL(jm.AutoencoderKLConfig(**VAE_KW, scaling_factor=0.13025))
    vparams = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 3))), 6)
    towers = [jemb.ClipEmbedder(jemb.ClipEmbedderConfig(**kw)) for kw in sdxl_conditioner_kw()]
    ids = {"text_ids": jnp.zeros((1, 16), jnp.int32)}
    cparams = [perturbed(t.init(jax.random.PRNGKey(6 + i), ids), 7 + i) for i, t in enumerate(towers)]
    sizes = [jemb.TimestepsEmbedder(jemb.TimestepsEmbedderConfig(input_key=k, num_channels=SIZE_CHANNELS))
             for k in SIZE_KEYS]
    pipe = JFlashPipeline(
        unet, uparams, conditioner=jemb.ConditionerWrapper([*towers, *sizes]),
        conditioner_params=[*cparams, {}, {}, {}], vae=vae, vae_params=vparams,
        tokenizer_fn=tokenizer_fn, latent_shape=LATENT, vae_scale_factor=2,
    )
    pipe.size_cond_fn = size_cond_fn
    return pipe, uparams, vparams, cparams


def port_sdxl_pipeline(uparams, vparams, cparams):
    ucfg = TUNetConfig(**SDXL_UNET_KW, use_linear_projection=True)
    vcfg = TVAEConfig(**VAE_KW, scaling_factor=0.13025)
    unet = UNet2DCondition(ucfg)
    unet.load_state_dict(unet_from_jax(uparams, ucfg))
    vae = AutoencoderKL(vcfg)
    vae.load_state_dict(vae_from_jax(vparams, vcfg))
    towers = [ClipEmbedder(ClipEmbedderConfig(**kw)) for kw in sdxl_conditioner_kw()]
    for tower, params in zip(towers, cparams):
        tower.module.load_state_dict(clip_text_from_jax(params, tower.encoder_config))
    sizes = [TimestepsEmbedder(TimestepsEmbedderConfig(input_key=k, num_channels=SIZE_CHANNELS))
             for k in SIZE_KEYS]
    pipe = FlashPipeline(
        unet.eval(), ConditionerWrapper([*towers, *sizes]).eval(), vae.eval(), tokenizer_fn,
        latent_shape=LATENT, vae_scale_factor=2,
    )
    pipe.size_cond_fn = size_cond_fn
    return pipe


def jax_draws(seed, batch, steps):
    """The latents and per-step noise ``FlashPipeline.generate`` draws for a scalar seed."""
    rng, kz = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(kz, (batch, *LATENT))
    noise, key = [], rng
    for _ in range(steps):
        key, sub = split_step_key(key)
        noise.append(torch.tensor(np.asarray(step_noise(sub, latents))))
    return torch.tensor(np.asarray(latents)), noise


@pytest.mark.parametrize("guidance_scale", [0.0, 2.0])
def test_slice_matches_jax_generate(jax_pipeline, guidance_scale):
    """guidance 0 is the published 4-NFE setting; 2.0 takes the CFG branch
    (the unconditional half from the zeroed conditioner output)."""
    jpipe, uparams, vparams, cparams = jax_pipeline
    prompts = ["a raccoon reading a book", "an astronaut"]
    want = np.asarray(jpipe.generate(prompts, num_inference_steps=4, guidance_scale=guidance_scale, seed=3))
    latents, noise = jax_draws(3, len(prompts), 4)
    got = port_pipeline(uparams, vparams, cparams).generate(
        prompts, num_inference_steps=4, guidance_scale=guidance_scale, latents=latents, noise=noise
    )
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("guidance_scale,negative", [(0.0, None), (2.0, ["blurry", "dark"]), (2.0, None)])
def test_sdxl_slice_matches_jax_generate(jax_sdxl_pipeline, guidance_scale, negative):
    """guidance 0 (the published setting); 2.0 with negative prompts, whose
    branch gets the size conditions too; 2.0 without, where ucg zeroes every
    conditioner, the size embeddings included."""
    jpipe, uparams, vparams, cparams = jax_sdxl_pipeline
    prompts = ["a raccoon reading a book", "an astronaut"]
    kw = dict(num_inference_steps=4, guidance_scale=guidance_scale, negative_prompts=negative)
    want = np.asarray(jpipe.generate(prompts, seed=4, **kw))
    latents, noise = jax_draws(4, len(prompts), 4)
    got = port_sdxl_pipeline(uparams, vparams, cparams).generate(
        prompts, latents=latents, noise=noise, **kw)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_size_cond_fn_feeds_the_vector():
    """The size conditions reach the UNet's vector: a different target size
    changes the images, and the vector is 24 + 3·2·8 wide."""
    pipe = tiny_sdxl_port_pipeline()
    seen = []
    embed = pipe._embed
    pipe._embed = lambda *a, **kw: seen.append(embed(*a, **kw)) or seen[-1]
    a = pipe.generate(["x"], seed=1)
    assert seen[0]["cond"]["vector"].shape == (1, 72)
    assert seen[0]["cond"]["crossattn"].shape == (1, 16, 64)
    pipe.size_cond_fn = lambda n, h, w: size_cond_fn(n, 2 * h, w)
    assert not torch.equal(a, pipe.generate(["x"], seed=1))


def test_lcm_schedule_matches_jax(jax_ref):
    from flash_diffusion_tpu.schedulers import lcm as jlcm
    from flash_diffusion_tpu.schedulers.base import SchedulerConfig as JSchedulerConfig

    want = jlcm.set_timesteps(JSchedulerConfig(), 4)
    got = lcm.set_timesteps(SchedulerConfig(), 4)
    assert got.timesteps == [999, 759, 499, 259] == np.asarray(want.timesteps).tolist()
    for name in ("sqrt_acp_t", "sqrt_1macp_t", "sqrt_acp_prev", "sqrt_1macp_prev", "c_skip", "c_out"):
        assert np.asarray(getattr(got, name), np.float32).tolist() == np.asarray(getattr(want, name)).tolist()


def tiny_port_pipeline(device="cpu", dtype=torch.float32):
    torch.manual_seed(0)
    clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=CLIP_KW))
    return FlashPipeline(
        UNet2DCondition(TUNetConfig(**UNET_KW)).to(device, dtype).eval(),
        ConditionerWrapper([clip]).to(device).eval(),
        AutoencoderKL(TVAEConfig(**VAE_KW)).to(device, dtype).eval(),
        tokenizer_fn, latent_shape=LATENT, vae_scale_factor=2,
    )


def tiny_sdxl_port_pipeline(device="cpu", dtype=torch.float32):
    torch.manual_seed(1)
    towers = [ClipEmbedder(ClipEmbedderConfig(**kw)) for kw in sdxl_conditioner_kw()]
    sizes = [TimestepsEmbedder(TimestepsEmbedderConfig(input_key=k, num_channels=SIZE_CHANNELS))
             for k in SIZE_KEYS]
    pipe = FlashPipeline(
        UNet2DCondition(TUNetConfig(**SDXL_UNET_KW, use_linear_projection=True)).to(device, dtype).eval(),
        ConditionerWrapper([*towers, *sizes]).to(device).eval(),
        AutoencoderKL(TVAEConfig(**VAE_KW, scaling_factor=0.13025)).to(device, dtype).eval(),
        tokenizer_fn, latent_shape=LATENT, vae_scale_factor=2,
    )
    pipe.size_cond_fn = size_cond_fn
    return pipe


def test_seeded_generate_is_deterministic():
    pipe = tiny_port_pipeline()
    a = pipe.generate(["x", "y"], seed=5)
    assert torch.equal(a, pipe.generate(["x", "y"], seed=5))
    assert not torch.equal(a, pipe.generate(["x", "y"], seed=6))


def test_conditioner_ucg_dropout():
    """ucg: forced by key, drawn at ucg_rate from a generator, off when
    ``set_ucg_rate_zero``; a dropped conditioner's output is all zeros."""
    torch.manual_seed(0)
    clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", ucg_rate=1.0, text_embedder_config=CLIP_KW))
    wrapper = ConditionerWrapper([clip]).eval()
    batch = tokenizer_fn(["a", "b"])
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        kept = wrapper(batch, generator=g, set_ucg_rate_zero=True)["cond"]["crossattn"]
        dropped = wrapper(batch, generator=g)["cond"]["crossattn"]
        forced = wrapper(batch, ucg_keys=["text"])["cond"]["crossattn"]
        no_generator = wrapper(batch)["cond"]["crossattn"]
    assert kept.abs().sum() > 0 and torch.equal(no_generator, kept)
    assert not dropped.any() and not forced.any()


def test_config_round_trips_through_json(tmp_path):
    cfg = TUNetConfig(**UNET_KW)
    back = TUNetConfig.from_json(cfg.save_json(str(tmp_path)))
    assert back == cfg and back.to_dict()["name"] == "UNetConfig"
    assert isinstance(back, BaseConfig)


def test_save_png_writes_the_images_side_by_side(tmp_path):
    """The CLI's PNG writer: signature, size, and the 8-bit pixels of the
    images laid side by side (each row behind a filter-type-0 byte)."""
    from flash_diffusion_tpu_torch.sample import save_png

    images = np.random.default_rng(0).uniform(-1.2, 1.2, (2, 3, 4, 3)).astype(np.float32)
    path = tmp_path / "x.png"
    save_png(str(path), images)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (8, 3)
    at = data.index(b"IDAT")
    raw = zlib.decompress(data[at + 4: at + 4 + struct.unpack(">I", data[at - 4: at])[0]])
    rows = np.frombuffer(raw, np.uint8).reshape(3, 1 + 8 * 3)
    assert not rows[:, 0].any()
    want = np.clip((np.concatenate(list(images), axis=1) + 1) * 127.5 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(3, 8, 3), want)


def test_port_imports_no_jax():
    """No module of the port imports JAX, flax or the JAX package: none of
    ``flash_diffusion_tpu_torch/**/*.py`` names them in an import statement
    (read with ``ast``), and every module (the Pixart, serving and int8 ones
    included) imports in a subprocess where importing them raises."""
    import ast

    pkg = os.path.join(REPO, "flash_diffusion_tpu_torch")
    banned = lambda name: name.split(".")[0] in ("jax", "jaxlib", "flax", "flash_diffusion_tpu")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            assert not any(banned(n) for n in names), (path, names)
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'flash_diffusion_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import flash_diffusion_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "new = {'quant', 'serving', 'serve', 'ops.gemm', 'models.dit', 'models.text_encoders',\n"
        "       'models.embedders.text', 'models.embedders.misc'}\n"
        "assert new <= {n[len(p.__name__) + 1:] for n in names}, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'flash_diffusion_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_slice_runs_through_the_kernels_on_card(cuda):
    """The tiny slice in bf16 on the card: finite images, and the attention
    and LayerNorm kernels launched during ``generate`` (at these sizes every
    attention call fits the one-shot kernel)."""
    from flash_diffusion_tpu_torch.ops import attention, norms

    pipe = tiny_port_pipeline(cuda, torch.bfloat16)
    for d in (attention.LAUNCHES, norms.LAUNCHES):
        for k in d:
            d[k] = 0
    images = pipe.generate(["a", "b"])
    torch.cuda.synchronize()
    assert images.shape == (2, 16, 16, 3) and torch.isfinite(images).all()
    assert attention.LAUNCHES["flash_fwd_oneshot"] > 0 and norms.LAUNCHES["layer_norm"] > 0


@pytest.mark.cuda
def test_sdxl_slice_runs_through_the_kernels_on_card(cuda):
    """The tiny SDXL slice in bf16 on the card: finite images, the packed
    kernel launched for the D = 64 attention calls, and the bf16 images
    within a relative L2 error of 0.1 of the fp32 slice on the CPU."""
    from flash_diffusion_tpu_torch.ops import attention, norms

    ref = tiny_sdxl_port_pipeline()
    pipe = tiny_sdxl_port_pipeline(cuda, torch.bfloat16)
    for d in (attention.LAUNCHES, norms.LAUNCHES):
        for k in d:
            d[k] = 0
    g = torch.Generator().manual_seed(0)
    latents, noise = torch.randn(2, *LATENT, generator=g), [torch.randn(2, *LATENT, generator=g) for _ in range(4)]
    images = pipe.generate(["a", "b"], latents=latents, noise=noise).cpu()
    torch.cuda.synchronize()
    assert images.shape == (2, 16, 16, 3) and torch.isfinite(images).all()
    assert attention.LAUNCHES["flash_fwd_oneshot_packed"] > 0 and norms.LAUNCHES["layer_norm"] > 0
    want = ref.generate(["a", "b"], latents=latents, noise=noise)
    assert ((images - want).norm() / want.norm()).item() < 0.1
