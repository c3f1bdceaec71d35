"""Parity of the PyTorch port's models with the JAX package.

Tiny SD1.5- and SDXL-shaped configs are initialised in JAX, their params perturbed
(so no bias or norm parameter sits at its trivial init), carried to the
port through ``flash_diffusion_tpu_torch/utils/convert.py``, and both
forwards run in fp32 on the same numpy inputs. Tolerance 1e-4 absolute:
fp32 on both sides, the same math with sums in another order, through a
few dozen layers. The full-size SD1.5 and SDXL UNets, the VAE and the
CLIP-L and OpenCLIP-bigG port state dicts, built on the meta device, are
held against the published checkpoints' key/shape manifests in
``tests/manifests/``.
"""

import os

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    CLIPTextConfig,
    CLIPTextModel,
    UNet2DCondition,
    UNetConfig,
    clip_g_config,
    clip_l_config,
    sd15_unet_config,
    sd_vae_config,
    sdxl_unet_config,
)
from flash_diffusion_tpu_torch.models.embedders import (
    ClipEmbedder,
    ClipEmbedderConfig,
    TimestepsEmbedder,
    TimestepsEmbedderConfig,
)
from flash_diffusion_tpu_torch.utils import clip_text_from_jax, unet_from_jax, vae_from_jax

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.models import embedders as jemb
    from flash_diffusion_tpu.models import text_encoders as jte
    from flash_diffusion_tpu.utils import hf
except ImportError:
    jax = None

torch.set_num_threads(2)

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "manifests")
UNET_KW = dict(
    in_channels=4, out_channels=4, block_out_channels=[16, 32],
    down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=2,
    num_heads=[2, 2], cross_attention_dim=32,
    norm_num_groups=8,
)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=2, max_positions=16, eos_token_id=99)
# SDXL-shaped: DownBlock2D first, transformer depths [1, 2] (the mid block
# takes the last), D = 64 heads (the packed path), vector conditioning
# through the projection class embedding; the port's linear projections
SDXL_UNET_KW = dict(
    in_channels=4, out_channels=4, block_out_channels=[32, 128],
    down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"], layers_per_block=1,
    transformer_layers_per_block=[1, 2], num_heads=[1, 2], cross_attention_dim=32,
    norm_num_groups=8, class_embed_type="projection", projection_class_embeddings_input_dim=24,
)
CLIP_G_KW = dict(CLIP_KW, num_layers=3, hidden_act="gelu", projection_dim=24)


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
    """JAX params as numpy, each leaf moved off its init by N(0, 0.05²)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params
    )


def port(module, state_dict):
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def jax_unet():
    cfg = jm.UNetConfig(**UNET_KW)
    net = jm.UNet2DCondition(cfg)
    cond = {"cond": {"crossattn": jnp.zeros((1, 8, 32))}}
    params = jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), cond
    )
    return net, perturbed(params, 1)


def jax_vae():
    cfg = jm.AutoencoderKLConfig(**VAE_KW)
    vae = jm.AutoencoderKL(cfg)
    params = jax.jit(vae.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    return vae, perturbed(params, 2)


def jax_clip():
    net = jte.CLIPTextModel(jte.CLIPTextConfig(**CLIP_KW))
    return net, perturbed(net.init(jax.random.PRNGKey(2), jnp.zeros((1, 16), jnp.int32)), 3)


def test_unet_matches_jax(jax_ref):
    net, params = jax_unet()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    want = jax.jit(net.apply)(
        params, jnp.asarray(x), jnp.asarray(t), {"cond": {"crossattn": jnp.asarray(ctx)}}
    )
    cfg = UNetConfig(**UNET_KW)
    unet = port(UNet2DCondition(cfg), unet_from_jax(params, cfg))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   {"cond": {"crossattn": torch.from_numpy(ctx)}})
    assert got.shape == (2, 16, 16, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def jax_sdxl_unet():
    net = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    cond = {"cond": {"crossattn": jnp.zeros((1, 8, 32)), "vector": jnp.zeros((1, 24))}}
    params = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)), cond)
    return net, perturbed(params, 4)


def test_sdxl_unet_matches_jax(jax_ref):
    net, params = jax_sdxl_unet()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    vec = rng.standard_normal((2, 24)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    want = jax.jit(net.apply)(
        params, jnp.asarray(x), jnp.asarray(t),
        {"cond": {"crossattn": jnp.asarray(ctx), "vector": jnp.asarray(vec)}},
    )
    cfg = UNetConfig(**SDXL_UNET_KW, use_linear_projection=True)
    unet = port(UNet2DCondition(cfg), unet_from_jax(params, cfg))
    assert unet.down_blocks[0].attentions is None and len(unet.mid_block.attentions[0].transformer_blocks) == 2
    assert isinstance(unet.down_blocks[1].attentions[0].proj_in, torch.nn.Linear)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   {"cond": {"crossattn": torch.from_numpy(ctx), "vector": torch.from_numpy(vec)}})
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_sdxl_unet_state_dict_round_trips_through_import_unet(jax_ref):
    """port state dict (linear projections, depth 2, ``add_embedding``) →
    JAX ``import_unet`` (which reads ``add_embedding`` into
    ``class_embedding``) → ``unet_from_jax`` → the same tensors."""
    cfg = UNetConfig(**SDXL_UNET_KW, use_linear_projection=True)
    torch.manual_seed(1)
    sd = UNet2DCondition(cfg).state_dict()
    assert "add_embedding.linear_1.weight" in sd
    imported = hf.import_unet({k: v.numpy() for k, v in sd.items()}, jm.UNetConfig(**SDXL_UNET_KW))
    assert "class_embedding" in imported["params"]
    back = unet_from_jax(imported, cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_unet_state_dict_round_trips_through_import_unet(jax_ref):
    """port state dict → JAX ``import_unet`` → ``unet_from_jax`` → the same tensors."""
    cfg = UNetConfig(**UNET_KW)
    torch.manual_seed(0)
    sd = UNet2DCondition(cfg).state_dict()
    imported = hf.import_unet({k: v.numpy() for k, v in sd.items()}, jm.UNetConfig(**UNET_KW))
    back = unet_from_jax(imported, cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_vae_decode_matches_jax(jax_ref):
    """Includes the single-head mid-block attention at D = C = 32."""
    vae, params = jax_vae()
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode_latents))(params, jnp.asarray(z))
    cfg = AutoencoderKLConfig(**VAE_KW)
    tvae = port(AutoencoderKL(cfg), vae_from_jax(params, cfg))
    with torch.no_grad():
        got = tvae.decode_latents(torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_unet_and_vae_without_mid_block_attention_match_jax(jax_ref):
    """``mid_block_attn=False`` (diffusers' ``mid_block_add_attention=False``)
    as the JAX package's own tests configure it (``tests/test_distill_paths.
    py``): no mid-block attention in the module or its state dict, and a
    self-attention-only UNet's forward and the VAE's moments and decode
    equal JAX's through ``unet_from_jax``/``vae_from_jax`` to 1e-4."""
    from test_torch_adapters import flax_params

    ukw = dict(in_channels=4, out_channels=4, block_out_channels=[8, 16],
               down_block_types=["AttnDownBlock2D", "DownBlock2D"], layers_per_block=1,
               transformer_layers_per_block=[1, 1], num_heads=[2, 2], cross_attention_dim=None, norm_num_groups=4,
               mid_block_attn=False)
    vkw = dict(block_out_channels=[4, 8], layers_per_block=1, norm_num_groups=2, latent_channels=4,
               mid_block_attn=False)
    net, jvae = jm.UNet2DCondition(jm.UNetConfig(**ukw)), jm.AutoencoderKL(jm.AutoencoderKLConfig(**vkw))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    uparams = flax_params(net, 11, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), None)
    vparams = flax_params(jvae, 12, jnp.zeros((1, 16, 16, 3)))
    assert "mid_attn" not in uparams["params"] and "mid_attn" not in vparams["params"]["decoder"]

    @jax.jit
    def forwards(up, vp):
        mean, logvar = jvae.apply(vp, jnp.asarray(img), method=jvae.moments)
        dec = jvae.apply(vp, jnp.asarray(x), method=jvae.decode_latents)
        return net.apply(up, jnp.asarray(x), jnp.asarray(t), None), mean, logvar, dec

    want = forwards(uparams, vparams)
    ucfg, vcfg = UNetConfig(**ukw), AutoencoderKLConfig(**vkw)
    unet = port(UNet2DCondition(ucfg), unet_from_jax(uparams, ucfg))
    tvae = port(AutoencoderKL(vcfg), vae_from_jax(vparams, vcfg))
    assert unet.mid_block.attentions is None and not any("mid_block.attentions" in k for k in unet.state_dict())
    assert not any("mid_block.attentions" in k for k in tvae.state_dict())
    with torch.no_grad():
        got = (unet(torch.from_numpy(x), torch.from_numpy(t)), *tvae.moments(torch.from_numpy(img)),
               tvae.decode_latents(torch.from_numpy(x)))
    for name, g, w in zip(("unet", "mean", "logvar", "decode"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


def test_clip_text_matches_jax(jax_ref):
    net, params = jax_clip()
    ids = np.random.default_rng(2).integers(0, 99, (2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 15] = 99, 99  # EOS positions
    want = net.apply(params, jnp.asarray(ids))
    cfg = CLIPTextConfig(**CLIP_KW)
    clip = port(CLIPTextModel(cfg), clip_text_from_jax(params, cfg))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids).long())
    for key in ("last_hidden_state", "pooled_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        got["hidden_states"][1].numpy(), np.asarray(want["hidden_states"][1]), atol=1e-4, rtol=0
    )


def test_clip_g_text_matches_jax(jax_ref):
    """Exact-gelu MLP and the text projection: the penultimate layer's
    output (what SDXL takes), the pooled output and its projection."""
    net = jte.CLIPTextModel(jte.CLIPTextConfig(**CLIP_G_KW))
    params = perturbed(net.init(jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32)), 6)
    ids = np.random.default_rng(5).integers(0, 99, (2, 16)).astype(np.int32)
    ids[0, 3], ids[1, 12] = 99, 99
    want = net.apply(params, jnp.asarray(ids))
    cfg = CLIPTextConfig(**CLIP_G_KW)
    clip = port(CLIPTextModel(cfg), clip_text_from_jax(params, cfg))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids).long())
    assert got["text_embeds"].shape == (2, 24)
    for name, g, w in (
        ("hidden_states[-2]", got["hidden_states"][-2], want["hidden_states"][-2]),
        ("pooled_output", got["pooled_output"], want["pooled_output"]),
        ("text_embeds", got["text_embeds"], want["text_embeds"]),
        ("last_hidden_state", got["last_hidden_state"], want["last_hidden_state"]),
    ):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("num_channels,flip,shift", [(256, True, 0.0), (8, False, 1.0), (7, True, 0.0)])
@pytest.mark.parametrize("rank", [1, 2])
def test_timesteps_embedder_matches_jax(jax_ref, num_channels, flip, shift, rank):
    """[B, k] (or [B]) scalars → [B, k·num_channels], odd widths padded.
    Tolerance: the frequencies exp(−log(10⁴)·i/half) from XLA's and from
    PyTorch's exp differ by up to an fp32 ulp (2⁻²³ relative), which moves
    the sinusoid's argument by up to |t|·2⁻²³ = 4.9e-4 at t = 4096."""
    key = "original_size_as_tuple"
    x = np.array([[1024.0, 768.0], [512.0, 0.0], [13.0, 4096.0]], np.float32)
    x = x if rank == 2 else x[:, 0]
    kw = dict(input_key=key, num_channels=num_channels, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    want = jemb.TimestepsEmbedder(jemb.TimestepsEmbedderConfig(**kw))({}, {key: x})["vector"]
    got = TimestepsEmbedder(TimestepsEmbedderConfig(**kw))({key: x})["vector"]
    assert got.shape == (3, (2 if rank == 2 else 1) * num_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4096 * 2**-23, rtol=0)


@pytest.mark.parametrize("layer,layer_idx,pooled,projection", [
    ("last", None, False, False), ("pooled", None, True, False),
    ("hidden", -2, True, True), ("hidden", 1, False, False),
])
def test_clip_embedder_selections_match_jax(jax_ref, layer, layer_idx, pooled, projection):
    kw = dict(input_key="text", text_embedder_config=dict(CLIP_KW, hidden_act="gelu"), layer=layer,
              layer_idx=layer_idx, always_return_pooled=pooled, use_projection=projection)
    jclip = jemb.ClipEmbedder(jemb.ClipEmbedderConfig(**kw))
    batch = {"text_ids": np.random.default_rng(6).integers(0, 100, (2, 16)).astype(np.int32)}
    params = perturbed(jclip.init(jax.random.PRNGKey(6), batch), 7)
    want = jclip.embed(params, batch)
    clip = ClipEmbedder(ClipEmbedderConfig(**kw))
    port(clip.module, clip_text_from_jax(params, clip.encoder_config))
    with torch.no_grad():
        got = clip.embed(batch)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0, err_msg=k)


def load_manifest(name):
    required, optional = {}, {}
    with open(os.path.join(MANIFEST_DIR, f"{name}.txt")) as f:
        for line in f:
            parts = line.split()
            shape = tuple(int(s) for s in parts[1].split(",")) if parts[1] != "-" else ()
            (optional if len(parts) == 3 else required)[parts[0]] = shape
    return required, optional


@pytest.mark.parametrize("name,build,prefixes", [
    ("sd15_unet", lambda: UNet2DCondition(sd15_unet_config()), None),
    ("sd_vae", lambda: AutoencoderKL(sd_vae_config()), None),
    ("clip_vit_l", lambda: CLIPTextModel(clip_l_config()), None),
    ("sdxl_unet", lambda: UNet2DCondition(sdxl_unet_config()), None),
    ("clip_bigg_proj", lambda: CLIPTextModel(clip_g_config()), None),
])
def test_full_size_state_dict_matches_manifest(name, build, prefixes):
    """Key for key and shape for shape, against the published checkpoint."""
    required, optional = load_manifest(name)
    if prefixes:
        required = {k: s for k, s in required.items() if k.startswith(prefixes)}
    with torch.device("meta"):
        sd = build().state_dict()
    got = {k: tuple(v.shape) for k, v in sd.items() if k not in optional}
    assert got == required


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_unet_bf16_on_card_tracks_fp32_on_cpu(cuda):
    """The tiny UNet in bf16 through the kernels vs fp32 plain on the CPU.
    Tolerance: relative L2 error 3e-2 (bf16 keeps ~3 significant digits
    per op, through ~40 layers)."""
    from flash_diffusion_tpu_torch.ops import attention, norms

    cfg = UNetConfig(**UNET_KW)
    torch.manual_seed(0)
    ref = UNet2DCondition(cfg).eval()
    dev = UNet2DCondition(cfg).to(cuda, torch.bfloat16).eval()
    dev.load_state_dict(ref.state_dict())
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 8, 32, generator=g)
    t = torch.tensor([999, 259])
    n = attention.LAUNCHES["flash_fwd_stream"] + attention.LAUNCHES["flash_fwd_oneshot"]
    with torch.no_grad():
        want = ref(x, t, {"cond": {"crossattn": ctx}})
        got = dev(x.to(cuda), t.to(cuda), {"cond": {"crossattn": ctx.to(cuda)}}).cpu()
    assert attention.LAUNCHES["flash_fwd_stream"] + attention.LAUNCHES["flash_fwd_oneshot"] > n
    assert norms.LAUNCHES["layer_norm"] > 0
    assert ((got - want).norm() / want.norm()).item() < 3e-2
