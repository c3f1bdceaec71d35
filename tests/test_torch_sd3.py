"""The port's SD3 slice against the JAX package: the flow-match schedulers,
the 16-channel VAE with its shift, the SD3 conditioner, the MMDiT, its
LoRA paths and int8 layer set, and the whole ``FlashPipeline.generate``.

Tiny configs (an MMDiT of depth 2, hidden 64, 2 heads of 32; CLIP towers of
2 and 3 layers; a 1-layer T5; a 2-level VAE) are initialised in JAX, their
params perturbed (so that no bias or norm sits at its trivial init),
carried to the port through ``utils/convert.py`` (``mmdit_from_jax``,
``vae_from_jax``, ``clip_text_from_jax``, ``t5_from_jax``), and both run in
fp32 on the same numpy inputs. Tolerances: the schedules' float32 tables
to 1e-6 relative (the same float64 math rounded once); one MMDiT, VAE or
conditioner forward to 1e-5, absolute up to outputs of 1 and relative
above (the same math, sums in another order); the slice's images to 1e-4
(four flow-match steps of such forwards). The int8 codes and scales are
bit-exact. The randomness of the slice (latents and step noise) is drawn
with ``jax.random`` as ``flash_diffusion_tpu/pipelines.py`` draws it and
handed to the port. Tests marked ``cuda`` run SD3's shapes through the
kernels on the card.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import FlashPipeline
from flash_diffusion_tpu_torch.lora import from_peft, lora_paths, merge_lora
from flash_diffusion_tpu_torch.models import (
    AutoencoderKL,
    AutoencoderKLConfig,
    MMDiT,
    MMDiTConfig,
    UNet2DCondition,
    UNetConfig,
    sd3_vae_config,
)
from flash_diffusion_tpu_torch.models.embedders import (
    ClipEmbedder,
    ClipEmbedderConfig,
    ConditionerWrapper,
    SD3Conditioner,
    T5AsSD3Embedder,
    T5TextEmbedderConfig,
)
from flash_diffusion_tpu_torch.quant import apply_weights, quantize_dense
from flash_diffusion_tpu_torch.schedulers import REGISTRY, SchedulerConfig, flow_match, lcm
from flash_diffusion_tpu_torch.utils import clip_text_from_jax, lora_from_jax, mmdit_from_jax, t5_from_jax, vae_from_jax
from flash_diffusion_tpu_torch.utils.convert import _MMDIT_BLOCK
from test_torch_quant import rel_l2

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu import quant as jquant
    from flash_diffusion_tpu.models import embedders as jemb
    from flash_diffusion_tpu.models import mmdit as jmmdit
    from flash_diffusion_tpu.pipelines import FlashPipeline as JFlashPipeline
    from flash_diffusion_tpu.schedulers import flow_match as jflow
    from flash_diffusion_tpu.schedulers.base import SchedulerConfig as JSchedulerConfig
    from flash_diffusion_tpu.schedulers.base import split_step_key, step_noise
    from flash_diffusion_tpu.utils import hf
except ImportError:
    jax = None

torch.set_num_threads(2)

CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, max_positions=16,
               eos_token_id=99)
CLIP_G_KW = dict(CLIP_KW, hidden_size=48, intermediate_size=96, num_layers=3, hidden_act="gelu")
T5_KW = dict(vocab_size=50, d_model=96, d_ff=64, d_kv=16, num_layers=1, num_heads=2, relative_buckets=8,
             relative_max_distance=16)
T5_DIM = 96  # the joint width: the CLIP tokens (32 + 48) are padded to it
POOLED = 16 + 32  # the two projections
CLIP_LEN, T5_LEN, T5_FALLBACK = 16, 12, 16
# SD3-shaped at tiny width: 16 latent channels, patch 2, depth 2 (the last
# block context_pre_only), 2 heads of 32, the pos-embed crop of a larger grid
MMDIT_KW = dict(in_channels=16, out_channels=16, patch_size=2, hidden_size=64, depth=2, num_heads=2,
                joint_attention_dim=T5_DIM, pooled_projection_dim=POOLED, pos_embed_max_size=16, sample_size=8)
VAE_KW = dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8)
LATENT = (8, 8, 16)  # 16 image tokens + 32 context tokens: joint 48, padded to 128
SCHED = "FlashFlowMatchEulerDiscreteScheduler"


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


def close(got, want, tol=1e-5):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


def tokenizer_fn(texts, t5=False):
    """Ids (and T5 ids and mask) that depend only on each prompt's text."""
    ids = np.stack([(np.arange(CLIP_LEN) * (len(t) + 3) + sum(map(ord, t))) % 99 for t in texts])
    for i, t in enumerate(texts):
        ids[i, 4 + len(t) % 10] = 99
    out = {"text_ids": ids.astype(np.int32)}
    if t5:
        out["t5_text_ids"] = np.stack([(np.arange(T5_LEN) * (len(t) + 1) + len(t)) % 50 for t in texts]).astype(
            np.int32)
        out["t5_text_mask"] = np.stack([np.arange(T5_LEN) < 4 + len(t) % 8 for t in texts]).astype(np.int32)
    return out


def tokenizer_t5(texts):
    return tokenizer_fn(texts, t5=True)


def clip_kws():
    """ClipEmbedderConfig kwargs of SD3's two towers (``examples/sample.py::
    _build_sd3``) at tiny widths: each with its projection and pooled output."""
    common = dict(input_key="text", layer="hidden", layer_idx=-2, always_return_pooled=True, use_projection=True)
    return (dict(common, text_embedder_config=dict(CLIP_KW, projection_dim=16)),
            dict(common, text_embedder_config=dict(CLIP_G_KW, projection_dim=32)))


# ---------------------------------------------------------------- schedulers
@pytest.mark.parametrize("n", range(1, 9))
def test_flow_match_tables_and_steps_match_jax_and_golden(jax_ref, n):
    """Flow-match tables of n steps (shift 3, shifted twice) against JAX and
    diffusers' ``FlowMatchEulerDiscreteScheduler`` (the golden port), to
    1e-6; the plain and the Flash step with the same injected noise against
    JAX's, to 1e-6; an explicit grid is not shifted again; ``add_noise``
    and ``get_sigmas`` against JAX."""
    from tests.golden.diffusers_port import GoldenFlowMatchEuler

    cfg = SchedulerConfig(shift=3.0)
    got = flow_match.set_timesteps(cfg, n)
    want = jflow.set_timesteps(JSchedulerConfig(shift=3.0), n)
    gold = GoldenFlowMatchEuler(shift=3.0)
    gold.set_timesteps(n)
    np.testing.assert_allclose(got.timesteps, np.asarray(want.timesteps), rtol=1e-6)
    np.testing.assert_allclose(got.timesteps, gold.timesteps, rtol=1e-6)
    np.testing.assert_allclose(got.sigmas, np.asarray(want.sigmas), rtol=1e-6)
    np.testing.assert_allclose(got.sigmas, gold.sigmas, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sigmas_train.numpy(), np.asarray(want.sigmas_train), rtol=1e-6)
    assert got.sigmas[-1] == 0.0 and got.num_inference_steps == n and isinstance(got.timesteps[0], float)

    rng = np.random.default_rng(n)
    x, v = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((n, 2, 4, 4, 3)).astype(np.float32)
    gx, fx, jx, jfx = torch.from_numpy(x), torch.from_numpy(x), jnp.asarray(x), jnp.asarray(x)
    gold_x = x.astype(np.float64)
    for i in range(n):
        gx = flow_match.step(got, torch.from_numpy(v), i, gx)
        jx = jflow.step(want, jnp.asarray(v), i, jx)
        gold_x = gold.step(v, gold_x)
        key = jax.random.PRNGKey(i)
        jnoise = step_noise(key, jfx)
        fx = flow_match.flash_step(got, torch.from_numpy(v), i, fx, noise=torch.tensor(np.asarray(jnoise)))
        jfx = jflow.flash_step(want, jnp.asarray(v), i, jfx, key=key)
    close(gx.numpy(), jx, 1e-6)
    close(gx.numpy(), gold_x, 1e-5)
    close(fx.numpy(), jfx, 1e-6)

    explicit = [900.5, 600.25, 100.0]
    got_e = flow_match.set_timesteps(cfg, timesteps=explicit)
    np.testing.assert_allclose(got_e.sigmas, np.asarray(jflow.set_timesteps(JSchedulerConfig(), timesteps=explicit)
                                                           .sigmas), rtol=1e-6)
    np.testing.assert_allclose(got_e.sigmas[:-1], np.asarray(explicit) / 1000, rtol=1e-6)
    sig = rng.uniform(0, 1, 2).astype(np.float32)
    close(flow_match.add_noise(got, torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(sig)).numpy(),
          jflow.add_noise(want, jnp.asarray(x), jnp.asarray(v), jnp.asarray(sig)), 1e-6)
    ts = np.asarray([999.0, 500.3, 1.0], np.float32) * got.sigmas_train[0].item()
    np.testing.assert_array_equal(flow_match.get_sigmas(got, torch.from_numpy(ts)).numpy(),
                                  np.asarray(jflow.get_sigmas(want, jnp.asarray(ts))))


def test_flow_match_registry():
    """Both flow-match schedulers are registered as JAX registers them: the
    Flash one shares the tables and steps with ``flash_step``."""
    flash = REGISTRY[SCHED]
    assert REGISTRY["FlowMatchEulerDiscreteScheduler"] is flow_match
    assert flash.step is flow_match.flash_step and flash.set_timesteps is flow_match.set_timesteps
    assert SchedulerConfig().shift == 3.0


# ---------------------------------------------------------------- VAE
def test_sd3_vae_encode_decode_matches_jax(jax_ref):
    """The 16-channel SD3 VAE without quant convs: encode ((mean − shift)·
    scaling) and decode_latents (z / scaling + shift; with per-channel
    ``latents_mean``/``latents_std``, z·std / scaling + mean) against JAX,
    1e-5; the state dict holds no quant-conv key, as SD3's checkpoints."""
    vae = jm.AutoencoderKL(jm.sd3_vae_config(**VAE_KW))
    params = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3))), 4)
    cfg = sd3_vae_config(**VAE_KW)
    sd = vae_from_jax(params, cfg)
    assert not any("quant_conv" in k for k in sd) and (cfg.latent_channels, cfg.use_quant_conv) == (16, False)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    per_channel = dict(latents_mean=list(np.linspace(-0.2, 0.2, 16)), latents_std=list(np.linspace(0.5, 1.5, 16)))
    for extra in ({}, per_channel):
        jvae = jm.AutoencoderKL(jm.sd3_vae_config(**VAE_KW, **extra))
        port = AutoencoderKL(sd3_vae_config(**VAE_KW, **extra))
        port.load_state_dict(sd)
        port.eval()
        decode = jax.jit(lambda p, z: jvae.apply(p, z, method=jvae.decode_latents))
        with torch.no_grad():
            close(port.decode_latents(torch.from_numpy(z)).numpy(), decode(params, jnp.asarray(z)))
            if not extra:  # the encode reads no latents_mean/std
                encode = jax.jit(lambda p, x: vae.apply(p, x, method=vae.encode))
                close(port.encode(torch.from_numpy(x)).numpy(), encode(params, jnp.asarray(x)))
                mean, _ = port.moments(torch.from_numpy(x))
                close(port.encode(torch.from_numpy(x)).numpy(), (mean.numpy() - 0.0609) * 1.5305)


# ---------------------------------------------------------------- conditioner
_JAX_TOWERS = {}


def _jax_towers(t5):
    """JAX's SD3 conditioner and its towers' perturbed params, built once."""
    if t5 not in _JAX_TOWERS:
        _JAX_TOWERS[t5] = _make_jax_towers(t5)
    return _JAX_TOWERS[t5]


def _make_jax_towers(t5):
    towers = [jemb.ClipEmbedder(jemb.ClipEmbedderConfig(**kw)) for kw in clip_kws()]
    ids = {"text_ids": jnp.zeros((1, CLIP_LEN), jnp.int32)}
    params = [perturbed(jax.jit(t.init)(jax.random.PRNGKey(20 + i), ids), 21 + i) for i, t in enumerate(towers)]
    if t5:
        jt5 = jemb.T5AsSD3Embedder(jemb.T5TextEmbedderConfig(input_key="t5_text", max_length=T5_LEN,
                                                             text_embedder_config=T5_KW))
        towers.append(jt5)
        t5_ids = {k: jnp.asarray(v) for k, v in tokenizer_t5(["x"]).items()}
        params.append(perturbed(jax.jit(jt5.init)(jax.random.PRNGKey(24), t5_ids), 25))
    return jemb.SD3Conditioner(towers, t5_dim=T5_DIM, t5_fallback_len=T5_FALLBACK), params


def _port_conditioner(params, t5):
    towers = [ClipEmbedder(ClipEmbedderConfig(**kw)) for kw in clip_kws()]
    for tower, p in zip(towers, params):
        tower.module.load_state_dict(clip_text_from_jax(p, tower.encoder_config))
    if t5:
        tower = T5AsSD3Embedder(T5TextEmbedderConfig(input_key="t5_text", max_length=T5_LEN,
                                                     text_embedder_config=T5_KW))
        tower.module.load_state_dict(t5_from_jax(params[2], tower.encoder_config))
        towers.append(tower)
    return SD3Conditioner(towers, t5_dim=T5_DIM, t5_fallback_len=T5_FALLBACK).eval()


@pytest.mark.parametrize("t5", [False, True])
def test_sd3_conditioner_matches_jax(jax_ref, t5):
    """CLIP-L ⊕ CLIP-G hidden states padded to the T5 width, then the T5
    tokens (or, without T5, T5_FALLBACK zero tokens: not dropped), and the
    two projected pooled outputs as the vector, against JAX's
    ``SD3Conditioner``, 1e-5; the T5 mask is popped; ucg zeroes them all."""
    jcond, params = _jax_towers(t5)
    port = _port_conditioner(params, t5)
    batch = tokenizer_fn(["a raccoon", "an astronaut riding"], t5=t5)
    want = jax.jit(jcond)(params, {k: jnp.asarray(v) for k, v in batch.items()})["cond"]
    with torch.no_grad():
        got = port(batch)["cond"]
        zeroed = port(batch, ucg_keys=port.input_keys())["cond"]
    assert set(got) == set(want) == {"crossattn", "vector"}
    assert got["crossattn"].shape == (2, CLIP_LEN + (T5_LEN if t5 else T5_FALLBACK), T5_DIM)
    assert got["vector"].shape == (2, POOLED)
    if not t5:
        assert not got["crossattn"][:, CLIP_LEN:].any() and not got["crossattn"][:, :, 80:].any()
    for k in got:
        close(got[k].numpy(), want[k])
        assert not zeroed[k].any()


# ---------------------------------------------------------------- MMDiT
_JAX_MMDITS = {}


def _jax_mmdit(**kw):
    """A JAX MMDiT of ``MMDIT_KW`` (with ``kw``) and its perturbed params,
    built once per config (the params fit any context length)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_MMDITS:
        cfg = jmmdit.MMDiTConfig(**{**MMDIT_KW, **{k: v for k, v in kw.items() if k != "concat_channels"}})
        net = jm.MMDiT(cfg)
        cond = {"cond": {"crossattn": jnp.zeros((1, CLIP_LEN, T5_DIM)), "vector": jnp.zeros((1, POOLED))}}
        if kw.get("concat_channels"):
            cond["cond"]["concat"] = jnp.zeros((1, *LATENT[:2], kw["concat_channels"]))
        params = jax.jit(net.init)(jax.random.PRNGKey(2), jnp.zeros((1, *LATENT)), jnp.zeros((1,)), cond)
        _JAX_MMDITS[key] = net, perturbed(params, 3)
    return _JAX_MMDITS[key]


_APPLIES = {}


def _jax_apply(net, **kw):
    """``net.apply`` jitted once per net and options."""
    key = (id(net), tuple(sorted(kw.items())))
    if key not in _APPLIES:
        _APPLIES[key] = jax.jit(lambda p, x, t, c: net.apply(p, x, t, c, **kw))
    return _APPLIES[key]


def _port_mmdit(params, **kw):
    cfg = MMDiTConfig(**{**MMDIT_KW, **kw})
    net = MMDiT(cfg)
    net.load_state_dict(mmdit_from_jax(params, cfg))
    return net.eval()


def _inputs(seed, ctx_len, latent=LATENT, concat=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *latent)).astype(np.float32)
    t = np.asarray([912.5, 250.0], np.float32)
    cond = {"crossattn": rng.standard_normal((2, ctx_len, T5_DIM)).astype(np.float32),
            "vector": rng.standard_normal((2, POOLED)).astype(np.float32)}
    if concat:
        cond["concat"] = rng.standard_normal((2, *latent[:2], concat)).astype(np.float32)
    return x, t, cond


def int8_spread(f, xt) -> float:
    """How far an int8 function of (latents, timestep) moves under ±1e-6-
    relative changes of both (fp32 rounding's size): the largest of three."""
    x, t = xt
    base = f((x, t))
    return max(rel_l2(f((x * (1 + e), t * (1 + e))), base) for e in (1e-6, -1e-6, 2e-6))


def _both(net, params, port, x, t, cond, **kw):
    want = _jax_apply(net, **kw)(params, jnp.asarray(x), jnp.asarray(t), {"cond": {k: jnp.asarray(v) for k, v in cond.items()}})
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   {"cond": {k: torch.from_numpy(v) for k, v in cond.items()}}, **kw)
    return got, want


@pytest.mark.parametrize("ctx_len,kw", [
    (CLIP_LEN + T5_FALLBACK, {}),  # joint 48: 80 zero context rows, kv_valid 48
    (112, {}),  # joint 128: aligned, no kv_valid
    (CLIP_LEN + T5_LEN, dict(qk_norm=True)),
    (CLIP_LEN + T5_FALLBACK, dict(concat_channels=4)),
])
def test_mmdit_matches_jax(jax_ref, ctx_len, kw):
    """The MMDiT forward against JAX at an unaligned joint length (the
    context stream padded to 128 and masked by ``kv_valid``) and an aligned
    one, with SD3.5's ``qk_norm`` and with ``concat`` conditioning, 1e-5;
    the output is fp32 [B, H, W, C]."""
    net, params = _jax_mmdit(**kw)
    port = _port_mmdit(params, **kw)
    got, want = _both(net, params, port, *_inputs(7, ctx_len, concat=kw.get("concat_channels", 0)))
    assert got.shape == (2, *LATENT) and got.dtype == torch.float32
    close(got.numpy(), want)


def test_mmdit_edge_cases_and_post_mid_match_jax(jax_ref):
    """JAX's alignment edge cases (``tests/test_models.py``: 64 image
    tokens with 64 context tokens, aligned, and with 90, padded to 256) and
    ``return_features="post_mid"``, the discriminator's tap after block
    depth // 2 − 1, against JAX, 1e-5."""
    latent = (16, 16, 16)
    for ctx_len in (64, 90):
        net, params = _jax_mmdit()
        port = _port_mmdit(params)
        x, t, cond = _inputs(8, ctx_len, latent)
        (got, feats), (want, jfeats) = _both(net, params, port, x, t, cond, return_features="post_mid")
        assert got.shape == feats.shape == (2, *latent)
        close(got.numpy(), want)
        close(feats.numpy(), jfeats)


def test_mmdit_state_dict_reads_through_import_sd3_mmdit(jax_ref):
    """A port MMDiT's ``state_dict()`` (diffusers ``SD3Transformer2DModel``
    names) through JAX ``import_sd3_mmdit`` gives the same output, also with
    ``qk_norm`` (``attn.norm_q``/``norm_k``); the final block has no
    ``to_add_out``, ``ff_context`` or 6-way ``norm1_context``."""
    for kw in ({}, dict(qk_norm=True)):
        net, params = _jax_mmdit(**kw)
        port = _port_mmdit(params, **kw)
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        last = f"transformer_blocks.{MMDIT_KW['depth'] - 1}"
        assert f"{last}.attn.to_add_out.weight" not in sd and f"{last}.ff_context.net.2.weight" not in sd
        assert sd[f"{last}.norm1_context.linear.weight"].shape == (2 * 64, 64)
        assert ("transformer_blocks.0.attn.norm_q.weight" in sd) == bool(kw)
        x, t, cond = _inputs(9, CLIP_LEN + (T5_LEN if kw else T5_FALLBACK))
        jparams = hf.import_sd3_mmdit(sd, jmmdit.MMDiTConfig(**{**MMDIT_KW, **kw}))
        want = net.apply(jparams, jnp.asarray(x), jnp.asarray(t), {"cond": {k: jnp.asarray(v) for k, v in cond.items()}})
        got, _ = _both(net, params, port, x, t, cond)
        close(got.numpy(), want)


def test_mmdit_lora_merge_matches_jax(jax_ref):
    """JAX ``init_lora`` over the MMDiT (B ≠ 0) carried by ``lora_from_jax``
    (``block_i/to_q`` → ``transformer_blocks.i.attn.to_q`` …): the port's
    default targets are JAX's pairs less the inert root ``proj_out``, and
    the merged denoiser (scaling 0.5) gives JAX's merged output, 1e-5."""
    net, params = _jax_mmdit()
    jtree = jlora.init_lora(params, 4, jax.random.PRNGKey(51))
    jtree = jax.tree_util.tree_map(lambda a: np.array(a), jtree)
    rng = np.random.default_rng(52)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for path, leaf in flat:
        if path[-1].key == "b":
            leaf += 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
    cfg = MMDiTConfig(**MMDIT_KW)
    port_tree = lora_from_jax(jtree, cfg)
    port = _port_mmdit(params)
    assert sorted(port_tree) == lora_paths(port)
    assert "transformer_blocks.0.attn.add_k_proj" in port_tree and "transformer_blocks.0.ff.net.2" in port_tree
    assert not any("ff_context" in k for k in port_tree) and "proj_out" not in port_tree
    inert = {k: v for k, v in jtree["params"].items() if k != "proj_out"}
    merged = jlora.merge_lora(params, {"params": inert}, 0.5)
    port.load_state_dict(merge_lora(port.state_dict(), port_tree, 0.5))
    x, t, cond = _inputs(10, CLIP_LEN + T5_FALLBACK)
    got, want = _both(net, merged, port, x, t, cond)
    close(got.numpy(), want)


def test_mmdit_int8_layer_set_and_codes_match_jax(jax_ref):
    """``quantize_dense`` over the MMDiT quantizes JAX's layer set (per
    block q, k, v, out, to_add_out and the two feed-forwards, the final
    block 6; add_q/k/v_proj, context_embedder, the modulation and the root
    proj_out stay float) with bit-equal codes and scales, and the int8
    forward (plain path on the CPU) lies within twice JAX's own int8 spread
    of JAX's (a code flipped by fp32 rounding grows through the blocks; see
    ``tests/test_torch_quant.py``), 3× closer than the float forward. The
    spread moves the timestep too, by the same ±1e-6 relative: the sinusoid
    of t ≈ 900 carries fp32 rounding of the argument into every modulation,
    and JAX's own output moves by ~1e-2 under it."""
    net, params = _jax_mmdit()
    jq, jn = jquant.quantize_dense(params, min_dim=16)
    port = _port_mmdit(params)
    state, n = quantize_dense(port.state_dict(), min_dim=16)
    depth = MMDIT_KW["depth"]
    assert n == jn == (depth - 1) * 9 + 6
    int8 = sorted(k[: -len(".weight")] for k, v in state.items() if v.dtype == torch.int8)
    assert not any("add_q_proj" in k or "context_embedder" in k or "norm" in k for k in int8)
    assert "proj_out" not in int8 and f"transformer_blocks.{depth - 2}.ff_context.net.2" in int8
    want_sd = mmdit_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jq), MMDiTConfig(**MMDIT_KW))
    jflat = {"/".join(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jq)[0]}
    for name in int8:
        b, rest = name.split(".")[1], ".".join(name.split(".")[2:])
        jname = {v: k for k, v in _MMDIT_BLOCK.items()}[rest]
        codes = jflat[f"params/block_{b}/{jname}/kernel"]
        assert codes.dtype == np.int8
        np.testing.assert_array_equal(state[f"{name}.weight"].numpy(), codes.T)
        np.testing.assert_array_equal(state[f"{name}.weight_scale"].numpy(),
                                      jflat[f"params/block_{b}/{jname}/kernel_scale"])
    assert want_sd.keys() == {k for k in state if not k.endswith("weight_scale")}
    apply_weights(port, state)
    x, t, cond = _inputs(11, CLIP_LEN + T5_FALLBACK)
    jcond = {"cond": {k: jnp.asarray(v) for k, v in cond.items()}}
    forward = lambda p, x, t: _jax_apply(net)(p, x, t, jcond)
    spread = int8_spread(lambda xt: forward(jq, *xt), (x, t))
    got, want = _both(net, jq, port, x, t, cond)
    err = rel_l2(got.numpy(), want)
    assert err <= 2 * spread, (err, spread)
    assert rel_l2(want, forward(params, x, t)) >= 3 * err


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def sd3_pipelines():
    """The tiny SD3 stack (dual-CLIP and with T5) in JAX and the port, with
    the same weights, built once per module."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    net, dparams = _jax_mmdit()
    vae = jm.AutoencoderKL(jm.sd3_vae_config(**VAE_KW))
    vparams = perturbed(jax.jit(vae.init)(jax.random.PRNGKey(72), jnp.zeros((1, 16, 16, 3))), 73)
    tvae = AutoencoderKL(sd3_vae_config(**VAE_KW))
    tvae.load_state_dict(vae_from_jax(vparams, tvae.config))
    pipes = {}
    for t5 in (False, True):
        jcond, cparams = _jax_towers(t5)
        tok = tokenizer_t5 if t5 else tokenizer_fn
        jpipe = JFlashPipeline(
            net, dparams, conditioner=jcond, conditioner_params=cparams, vae=vae, vae_params=vparams,
            tokenizer_fn=tok, latent_shape=LATENT, vae_scale_factor=2, scheduler=SCHED,
            scheduler_config=JSchedulerConfig(shift=3.0))
        pipe = FlashPipeline(_port_mmdit(dparams), _port_conditioner(cparams, t5), tvae.eval(), tok,
                             latent_shape=LATENT, vae_scale_factor=2, scheduler=SCHED,
                             scheduler_config=SchedulerConfig(shift=3.0))
        pipes[t5] = jpipe, pipe
    return pipes


def _jax_draws(seed, batch, steps=4):
    """The latents and the step noise JAX's ``generate`` draws from ``seed``."""
    rng, kz = jax.random.split(jax.random.PRNGKey(seed))
    latents = jax.random.normal(kz, (batch, *LATENT))
    noise, key = [], rng
    for _ in range(steps):
        key, sub = split_step_key(key)
        noise.append(torch.tensor(np.asarray(step_noise(sub, latents))))
    return torch.tensor(np.asarray(latents)), noise


@pytest.mark.parametrize("t5,guidance_scale", [(False, 0.0), (True, 0.0), (False, 2.0)])
def test_sd3_slice_matches_jax_generate(sd3_pipelines, t5, guidance_scale):
    """The whole slice: the SD3 conditioner (dual-CLIP with 16 zero T5
    tokens, or with T5) → 4 Flash flow-match steps of the MMDiT (shift 3,
    the joint sequence masked past kv_valid) → the SD3 VAE decode, with
    JAX's draws injected, against JAX ``FlashPipeline.generate``, 1e-4.
    guidance 0 is the published setting; 2.0 takes the CFG branch."""
    jpipe, pipe = sd3_pipelines[t5]
    prompts = ["a raccoon reading a book", "an astronaut"]
    want = np.asarray(jpipe.generate(prompts, num_inference_steps=4, guidance_scale=guidance_scale, seed=5))
    latents, noise = _jax_draws(5, 2)
    got = pipe.generate(prompts, num_inference_steps=4, guidance_scale=guidance_scale, latents=latents,
                        noise=noise)
    assert got.shape == (2, 16, 16, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_sd15_generate_unchanged_by_scheduler_dispatch():
    """SD1.5's tiny ``generate`` through the scheduler dispatch gives the
    bits of the LCM loop it replaced (``lcm.set_timesteps``/``lcm.step``,
    noise at every step but the last), with seeded draws as well as
    injected ones."""
    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig(
        in_channels=4, out_channels=4, block_out_channels=[16, 32],
        down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], layers_per_block=1, num_heads=[2, 2],
        cross_attention_dim=32, norm_num_groups=8)).eval()
    vae = AutoencoderKL(AutoencoderKLConfig(**VAE_KW)).eval()
    clip = ClipEmbedder(ClipEmbedderConfig(input_key="text", text_embedder_config=CLIP_KW))
    pipe = FlashPipeline(unet, ConditionerWrapper([clip]).eval(), vae, tokenizer_fn, latent_shape=(8, 8, 4),
                         vae_scale_factor=2)
    assert pipe.scheduler_name == "LCMScheduler" and pipe.sched_mod is lcm
    prompts = ["a", "bb"]
    got = pipe.generate(prompts, seed=3)

    with torch.inference_mode():
        cond = pipe.conditioner(tokenizer_fn(prompts), set_ucg_rate_zero=True)
        g = torch.Generator().manual_seed(3)
        sample = torch.randn((2, 8, 8, 4), generator=g)
        sched = lcm.set_timesteps(pipe.sched_config, 4)
        for i, t in enumerate(sched.timesteps):
            pred = unet(sample, torch.full((2,), t), cond)
            noise = None if i == 3 else torch.randn(sample.shape, generator=g)
            sample = lcm.step(sched, pred, i, sample, noise=noise)
        want = vae.decode_latents(sample)
    assert torch.equal(got, want)


def test_build_modules_sd3_names():
    """``build_modules("sd3")`` builds SD3-medium as ``examples/sample.py::
    _build_sd3`` does (on the meta device: no memory): 24 joint blocks of
    1536, 24 heads of 64, 2.03 B parameters, the 16-channel VAE without
    quant convs, CLIP-L and CLIP-G with projections (T5-XXL over 256 tokens
    with ``t5``, its ids and mask from the tokenizer), 213 int8 layers; the
    CLIs offer it, training's too, on ``flash_sd3.yaml``."""
    from flash_diffusion_tpu_torch import profiling, serve, train
    from flash_diffusion_tpu_torch.sample import (MODELS, SD3_SCHEDULER, SD3_SCHEDULER_CONFIG, build_modules,
                                                  make_conditioner, sd3_tokenizer)

    with torch.device("meta"):
        mmdit, vae, conds, towers, size_fn = build_modules("sd3")
        _, _, conds5, towers5, _ = build_modules("sd3", t5=True)
    cfg = mmdit.config
    assert (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.patch_size, cfg.in_channels, cfg.joint_attention_dim,
            cfg.pooled_projection_dim, cfg.pos_embed_max_size) == (1536, 24, 24, 2, 16, 4096, 2048, 192)
    assert sum(p.numel() for p in mmdit.parameters()) == 2_028_328_000
    assert (vae.config.latent_channels, vae.config.scaling_factor, vae.config.shift_factor) == (16, 1.5305, 0.0609)
    assert not any("quant_conv" in k for k in vae.state_dict())
    clip_l, clip_g = conds
    assert (clip_l.encoder_config.hidden_size, clip_l.encoder_config.projection_dim) == (768, 768)
    assert (clip_g.encoder_config.hidden_size, clip_g.encoder_config.projection_dim) == (1280, 1280)
    assert all(c.config.use_projection and c.config.always_return_pooled and c.config.layer_idx == -2
               for c in conds)
    t5 = conds5[2]
    assert isinstance(t5, T5AsSD3Embedder) and t5.config.max_length == 256 and t5.ids_key == "t5_text_ids"
    assert [p for p, _ in towers5] == ["text_encoder/model.safetensors", "text_encoder_2/model.safetensors",
                                       "text_encoder_3"] and size_fn is None
    wrapper = make_conditioner("sd3", conds)
    assert isinstance(wrapper, SD3Conditioner) and wrapper.t5_dim == 4096 and wrapper.t5_fallback_len == 77
    assert (SD3_SCHEDULER, SD3_SCHEDULER_CONFIG.shift) == (SCHED, 3.0)
    ids = sd3_tokenizer("", t5=True)(["a", "b"])  # no local tokenizer: zero ids, an all-ones T5 mask
    assert {k: v.shape for k, v in ids.items()} == {"text_ids": (2, 77), "t5_text_ids": (2, 256),
                                                    "t5_text_mask": (2, 256)}
    assert set(sd3_tokenizer("")(["a"])) == {"text_ids"}
    _, n = quantize_dense(mmdit.state_dict())
    assert n == 23 * 9 + 6
    assert "sd3" in MODELS and profiling.MODELS is MODELS and serve.MODELS is MODELS
    assert "sd3" in train.MODELS and train.CONFIGS["sd3"].endswith("flash_sd3.yaml")


def test_load_weights_reads_the_sd3_diffusers_layout(tmp_path):
    """``load_weights("sd3", ...)`` reads ``transformer/``, ``vae/``,
    ``text_encoder{,_2}/model.safetensors`` and a sharded T5 under
    ``text_encoder_3/`` (its ``encoder.embed_tokens`` alone, as
    transformers writes it), from tiny files written here; and a PEFT
    adapter under the ``transformer`` prefix."""
    from safetensors.torch import save_file

    from flash_diffusion_tpu_torch.sample import load_weights

    torch.manual_seed(1)
    mods = [MMDiT(MMDiTConfig(**MMDIT_KW)), AutoencoderKL(sd3_vae_config(**VAE_KW)),
            *[ClipEmbedder(ClipEmbedderConfig(**kw)) for kw in clip_kws()],
            T5AsSD3Embedder(T5TextEmbedderConfig(input_key="t5_text", text_embedder_config=T5_KW))]
    files = ["transformer/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.safetensors",
             "text_encoder/model.safetensors", "text_encoder_2/model.safetensors"]
    for m, f in zip(mods, files):
        (tmp_path / f).parent.mkdir(parents=True, exist_ok=True)
        save_file({k: v.contiguous() for k, v in (m.module if hasattr(m, "module") else m).state_dict().items()},
                  str(tmp_path / f))
    t5_sd = dict(mods[4].module.state_dict())
    t5_sd["encoder.embed_tokens.weight"] = t5_sd.pop("shared.weight")
    (tmp_path / "text_encoder_3").mkdir()
    keys = sorted(t5_sd)
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        save_file({k: t5_sd[k].contiguous() for k in part}, str(tmp_path / f"text_encoder_3/model-0000{i + 1}.safetensors"))

    torch.manual_seed(2)
    fresh = [MMDiT(MMDiTConfig(**MMDIT_KW)), AutoencoderKL(sd3_vae_config(**VAE_KW)),
             *[ClipEmbedder(ClipEmbedderConfig(**kw)) for kw in clip_kws()],
             T5AsSD3Embedder(T5TextEmbedderConfig(input_key="t5_text", text_embedder_config=T5_KW))]
    towers = [("text_encoder/model.safetensors", fresh[2]), ("text_encoder_2/model.safetensors", fresh[3]),
              ("text_encoder_3", fresh[4])]
    load_weights("sd3", str(tmp_path), fresh[0], fresh[1], towers)
    for a, b in zip(mods, fresh):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)

    tensors = {"transformer.transformer_blocks.0.attn.add_q_proj.lora_A.weight": torch.ones(2, 64),
               "transformer.transformer_blocks.0.attn.add_q_proj.lora_B.weight": torch.ones(64, 2),
               "unet.x.lora_A.weight": torch.ones(2, 3)}
    tree, scaling = from_peft(tensors, prefix="transformer")
    assert list(tree) == ["transformer_blocks.0.attn.add_q_proj"] and scaling == 1.0
    assert tree["transformer_blocks.0.attn.add_q_proj"]["a"].shape == (64, 2)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,kv_valid", [(1, 24, 256, 218), (4, 24, 4352, 4250), (1, 12, 1100, 1037)])
def test_joint_attention_kv_valid_on_card(cuda, b, h, s, kv_valid):
    """``dot_product_attention`` with ``kv_valid`` at SD3's joint shapes (the
    128² reference's 218 of 256 on the one-shot kernel, 1024²'s 4250 of
    4352 on the streaming one, a ragged length) on the card against the
    plain version: the keys past ``kv_valid`` (k × 3, v + 1) must not leak;
    ``attention_fwd_gate``."""
    from flash_diffusion_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, h, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    k[:, kv_valid:] *= 3
    v[:, kv_valid:] += 1
    out = attention.dot_product_attention(q, k, v, kv_valid=kv_valid)
    ref = attention.reference_attention(q.float(), k.float(), v.float(), scale=64 ** -0.5, kv_valid=kv_valid)
    stats = attention.attention_fwd_errors(out.float(), None, ref, None)
    ok, report = attention.attention_fwd_gate(stats)
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16384, 1536, 1536), (16384, 1536, 6144), (16384, 6144, 1536),
                                   (1024, 1536, 1536), (1024, 1536, 6144), (1024, 6144, 1536)])
def test_int8_products_at_sd3_widths_on_card(cuda, m, k, n):
    """The int8 GEMM kernel at SD3-medium's six int8 products (batch 4,
    1024²: the image stream's 16384 rows, the padded context's 1024): its
    int32 sums equal the plain version's, its bf16 output equals the plain
    dequantization's."""
    from flash_diffusion_tpu_torch.ops import gemm

    g = torch.Generator(device="cuda").manual_seed(1)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda) * 1e-3 + 1e-5
    sw = torch.rand(n, generator=g, device=cuda) * 1e-3 + 1e-5
    assert torch.equal(gemm.int8_gemm(xq, None, wq, None, out_dtype=torch.int32), gemm.int8_sums_reference(xq, wq))
    assert torch.equal(gemm.int8_gemm(xq, sx, wq, sw), gemm.int8_gemm_reference(xq, sx, wq, sw))
