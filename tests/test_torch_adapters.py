"""The Canny T2I-Adapter run and the DPT depth model of the port against the JAX package, on the CPU.

Same weights (JAX params carried by ``utils/convert.py``), same inputs made
from a numpy seed, fp32 on both sides; each tolerance stated:

- ``pixel_unshuffle`` bit-equal to JAX's, and not ``F.pixel_unshuffle``'s
  channel order; the ``T2IAdapter`` at tiny channels (1e-4);
- the UNet with ``adapter_residuals``, and with ``concat`` through a
  ``conv_in`` widened by ``adapt_state_dict`` (1e-4);
- ``ModuleEmbedder`` over Conv (SAME with strides 1 and 2 on an odd size,
  explicit padding, 1-D), Dense, silu/relu/gelu, its conditioning type
  from the rank, and ``concat`` outputs joined on the channel axis by the
  wrapper (1e-5);
- the Canny mapper bit-equal, the depth mapper through ``make_depth_fn``
  (1e-4), ``resize_like_jax`` (1e-6);
- the adapter distillation step's losses and LoRA and discriminator
  gradients at ``adapter_conditioning_scale`` 0.5, every draw injected
  from JAX's key (1e-4), and the edge map changes the loss; ``sample``
  with the adapter (1e-4);
- the tiny DPT (dim 32, depth 4, 2 heads, 16 features) through
  ``dpt_from_jax`` (1e-4 of max|depth|); ``import_dpt_large`` on a
  synthetic MiDaS state dict, equal to JAX on flipped ConvTranspose
  kernels and not on the same ones;
- ``build_trainer("sd15-canny")`` on tiny modules with the yaml, one step
  on JPEG shards through the Canny mapper, the adapter frozen and out of
  the optimizer, samples at scale 1 and 0 that differ.

The ``cuda``-marked test holds K1 at the DPT's [16, 577, 577, 64] against
its plain version; it skips here and runs on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_adapters.py``.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flash_diffusion_tpu_torch.data import CannyEdgeMapper, CannyEdgeMapperConfig, DepthMapper, DepthMapperConfig
from flash_diffusion_tpu_torch.distill import ConvDiscriminator, DiscriminatorConfig, FlashDiffusion, FlashDiffusionConfig
from flash_diffusion_tpu_torch.models import DPTDepth, T2IAdapter, T2IAdapterConfig, UNetConfig, import_dpt_large
from flash_diffusion_tpu_torch.models import make_depth_fn, pixel_unshuffle
from flash_diffusion_tpu_torch.models.depth import DEAD_MIDAS_PREFIXES, resize_like_jax
from flash_diffusion_tpu_torch.models.embedders import ConditionerWrapper, ModuleEmbedder, ModuleEmbedderConfig
from flash_diffusion_tpu_torch.ops import attention as tattn
from flash_diffusion_tpu_torch.trainer import adapt_state_dict
from flash_diffusion_tpu_torch.utils import (
    adapter_from_jax,
    discriminator_from_jax,
    dpt_from_jax,
    lora_from_jax,
    module_embedder_from_jax,
    unet_from_jax,
)
from test_torch_train import B, HW, UNET_KW, jax_step_draws, perturbed, port_unet, t_

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu.data.mappers import CannyEdgeMapper as JCannyEdgeMapper
    from flash_diffusion_tpu.data.mappers import CannyEdgeMapperConfig as JCannyEdgeMapperConfig
    from flash_diffusion_tpu.distill import FlashDiffusion as JFlashDiffusion
    from flash_diffusion_tpu.distill import FlashDiffusionConfig as JFlashDiffusionConfig
    from flash_diffusion_tpu.distill.discriminator import ConvDiscriminator as JConvDiscriminator
    from flash_diffusion_tpu.distill.discriminator import DiscriminatorConfig as JDiscriminatorConfig
    from flash_diffusion_tpu.models import adapters as jadapters
    from flash_diffusion_tpu.models import depth as jdepth
    from flash_diffusion_tpu.models import embedders as jemb
except ImportError:
    jax = None

torch.set_num_threads(2)
C = 4
ADAPTER_KW = dict(channels=[16, 32], num_res_blocks=1)  # the tiny UNet's levels


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def close(got, want, tol, msg=""):
    """|got − want| ≤ tol · max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0, err_msg=msg)


def flax_params(module, seed, *args):
    """``module.init(key, *args)``'s tree filled as flax fills it, from a
    numpy seed (kernels and embeddings N(0, 1/fan-in), biases 0, norm
    scales 1), then ``perturbed``: the shapes from ``jax.eval_shape``, so
    that no init is compiled or run."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("bias", "scale"):
            return np.full(leaf.shape, float(name == "scale"), np.float32)
        fan_in = max(1, int(np.prod(leaf.shape[:-1])))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return perturbed(jax.tree_util.tree_map_with_path(fill, shapes), seed + 1)


@functools.lru_cache(maxsize=None)
def jax_unet(seed=0):
    """The tiny JAX UNet of test_torch_train and its ``flax_params``."""
    net = jm.UNet2DCondition(jm.UNetConfig(**UNET_KW))
    return net, flax_params(net, seed, jnp.zeros((1, HW, HW, C)), jnp.zeros((1,)),
                            {"cond": {"crossattn": jnp.zeros((1, 8, 16))}})


def edges(seed, b=B, hw=8 * HW):
    return (np.random.default_rng(seed).random((b, hw, hw, 3)) > 0.8).astype(np.float32)


# ---------------------------------------------------------------- the adapter
def test_pixel_unshuffle_matches_jax_not_torch(jax_ref):
    """JAX's NHWC ``pixel_unshuffle`` orders channels (i, j, c): the port's
    equals it bit for bit, ``F.pixel_unshuffle`` (c, i, j) does not."""
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jadapters.pixel_unshuffle(jnp.asarray(x), 4))
    got = pixel_unshuffle(t_(x), 4)
    assert np.array_equal(got.numpy(), want)
    torch_order = F.pixel_unshuffle(t_(x).permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    assert torch_order.shape == got.shape and (torch_order - got).abs().max() > 1.0


@functools.lru_cache(maxsize=None)
def jax_adapter(num_res_blocks=1, seed=0):
    cfg = jadapters.T2IAdapterConfig(channels=[16, 32], num_res_blocks=num_res_blocks)
    net = jadapters.T2IAdapter(cfg)
    return net, flax_params(net, seed, jnp.zeros((1, 8 * HW, 8 * HW, 3)))


def port_adapter(params, num_res_blocks=1):
    cfg = T2IAdapterConfig(channels=[16, 32], num_res_blocks=num_res_blocks)
    adapter = T2IAdapter(cfg)
    adapter.load_state_dict(adapter_from_jax(params, cfg))
    return adapter.eval().requires_grad_(False)


@pytest.mark.parametrize("num_res_blocks", [1, 2])
def test_t2i_adapter_matches_jax(jax_ref, num_res_blocks):
    """Every level's NHWC feature ([B, 16, 16, 16], [B, 8, 8, 32] from a
    128² edge map): 1e-4."""
    net, params = jax_adapter(num_res_blocks)
    e = edges(1)
    want = jax.jit(net.apply)(params, jnp.asarray(e))
    got = port_adapter(params, num_res_blocks)(t_(e))
    assert [tuple(g.shape) for g in got] == [(B, HW, HW, 16), (B, HW // 2, HW // 2, 32)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-4, f"level {lvl}")


def _cond(seed):
    return np.random.default_rng(seed).standard_normal((B, 8, 16)).astype(np.float32)


def test_unet_adapter_residuals_match_jax(jax_ref):
    """The tiny UNet with per-level residuals added after each down level's
    last pair (and into its skip): 1e-4; they change the output."""
    net, params = jax_unet()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    t = np.array([10, 700])
    res = [rng.standard_normal((B, HW // 2 ** i, HW // 2 ** i, c)).astype(np.float32) for i, c in enumerate((16, 32))]
    ctx = _cond(3)
    want = jax.jit(net.apply)(params, jnp.asarray(x), jnp.asarray(t), {"cond": {"crossattn": jnp.asarray(ctx)}},
                              adapter_residuals=[jnp.asarray(r) for r in res])
    unet = port_unet(params)
    with torch.no_grad():
        got = unet(t_(x), t_(t), {"cond": {"crossattn": t_(ctx)}}, adapter_residuals=[t_(r) for r in res])
        plain = unet(t_(x), t_(t), {"cond": {"crossattn": t_(ctx)}})
    close(got, want, 1e-4)
    assert (got - plain).abs().max() > 1e-2


def test_unet_concat_with_widened_conv_in_matches_jax(jax_ref):
    """``concat`` [B, H, W, 2] joined to the latents before ``conv_in``,
    widened 4 → 6 input channels by ``adapt_state_dict`` (normal fill from
    a generator; the same kernel given to JAX, whose conv infers it): 1e-4."""
    net, params = jax_unet()
    sd = unet_from_jax(params, UNetConfig(**UNET_KW))
    wide = adapt_state_dict(sd, {"conv_in.weight": (16, 6, 3, 3)}, key_patterns=[r"conv_in\.weight"],
                            fill="normal", generator=torch.Generator().manual_seed(4))
    assert torch.equal(wide["conv_in.weight"][:, :4], sd["conv_in.weight"])
    jparams = jax.tree_util.tree_map(np.asarray, params)
    jparams["params"]["conv_in"]["kernel"] = wide["conv_in.weight"].permute(2, 3, 1, 0).numpy()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    concat = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    t, ctx = np.array([3, 500]), _cond(6)
    want = jax.jit(net.apply)(jparams, jnp.asarray(x), jnp.asarray(t),
                              {"cond": {"crossattn": jnp.asarray(ctx), "concat": jnp.asarray(concat)}})
    cfg = UNetConfig(**UNET_KW, concat_channels=2)
    from flash_diffusion_tpu_torch.models import UNet2DCondition

    unet = UNet2DCondition(cfg)
    unet.load_state_dict(wide)
    with torch.no_grad():
        got = unet.eval()(t_(x), t_(t), {"cond": {"crossattn": t_(ctx), "concat": t_(concat)}})
    close(got, want, 1e-4)


# ---------------------------------------------------------------- ModuleEmbedder
EMBEDDER_CASES = {
    "conv_same_silu": ((2, 8, 8, 3), [{"layer": "Conv", "features": 4, "kernel_size": [3, 3]}, {"layer": "silu"}]),
    "conv_stride2_odd_relu": ((2, 9, 7, 3), [{"layer": "Conv", "features": 5, "kernel_size": [3, 3], "strides": [2, 2]},
                                             {"layer": "relu"}, {"layer": "Conv", "features": 2, "kernel_size": [1, 1]}]),
    "conv_padded_gelu": ((2, 8, 8, 2), [{"layer": "Conv", "features": 3, "kernel_size": [3, 3], "padding": 1},
                                        {"layer": "gelu"}, {"layer": "Conv", "features": 3, "kernel_size": [2, 2],
                                                            "padding": "VALID", "use_bias": False}]),
    "conv1d_tokens": ((2, 11, 6), [{"layer": "Conv", "features": 8, "kernel_size": [4], "strides": [2]}]),
    "dense_vector_gelu": ((2, 5), [{"layer": "Dense", "features": 7}, {"layer": "gelu"},
                                   {"layer": "Dense", "features": 3}]),
    "dense_tokens": ((2, 6, 5), [{"layer": "Dense", "features": 4, "use_bias": False}, {"layer": "silu"}]),
}


def _jax_embedder(shape, specs, key="cond_in", seed=0):
    emb = jemb.ModuleEmbedder(jemb.ModuleEmbedderConfig(input_key=key, layers=specs))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    params = flax_params(emb, seed, {key: jnp.asarray(x)})
    return emb, params, x


@pytest.mark.parametrize("case", sorted(EMBEDDER_CASES))
def test_module_embedder_matches_jax(jax_ref, case):
    """``ModuleEmbedder`` from flax-style specs (in-channels from the first
    batch) against JAX's: the output (1e-5) and its conditioning type."""
    shape, specs = EMBEDDER_CASES[case]
    emb, params, x = _jax_embedder(shape, specs)
    want = emb.embed(params, {"cond_in": jnp.asarray(x)})
    port = ModuleEmbedder(ModuleEmbedderConfig(input_key="cond_in", layers=specs))
    port.build(shape[-1])
    port.load_state_dict(module_embedder_from_jax(params))
    got = port.embed({"cond_in": x})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 1e-5, case)


def test_module_embedders_concat_through_wrapper_match_jax(jax_ref):
    """Two ``concat`` embedders (in-channels from the config for one, from
    the batch for the other) joined on the channel axis by the wrapper, with
    a forced uncond zeroing one: 1e-5."""
    specs_a = [{"layer": "Conv", "features": 3, "kernel_size": [3, 3]}]
    specs_b = [{"layer": "Conv", "features": 2, "kernel_size": [1, 1]}, {"layer": "relu"}]
    ea, pa, xa = _jax_embedder((2, 6, 6, 3), specs_a, "low", 1)
    eb, pb, xb = _jax_embedder((2, 6, 6, 1), specs_b, "mask", 3)
    batch = {"low": xa, "mask": xb}
    jw = jemb.ConditionerWrapper([ea, eb])
    ta = ModuleEmbedder(ModuleEmbedderConfig(input_key="low", layers=specs_a, in_channels=3))
    ta.load_state_dict(module_embedder_from_jax(pa))
    tb = ModuleEmbedder(ModuleEmbedderConfig(input_key="mask", layers=specs_b))
    tb.build(1)
    tb.load_state_dict(module_embedder_from_jax(pb))
    tw = ConditionerWrapper([ta, tb])
    for ucg in ([], ["mask"]):
        want = jw([pa, pb], {k: jnp.asarray(v) for k, v in batch.items()}, ucg_keys=ucg)["cond"]
        got = tw(batch, ucg_keys=ucg)["cond"]
        assert set(got) == set(want) == {"concat"} and got["concat"].shape == (2, 6, 6, 5)
        close(got["concat"], want["concat"], 1e-5, str(ucg))


# ---------------------------------------------------------------- the mappers
@pytest.mark.parametrize("kind", ["uint8_range", "signed", "gray"])
def test_canny_mapper_matches_jax(jax_ref, kind):
    """The numpy Canny on one image: a 0–255 photo-like gradient with
    shapes, the same in [-1, 1] (as the training chain hands it over), and a
    grey HW image; bit-equal, and a non-trivial edge map."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 3.0, yy * 4.0, ((xx - 32) ** 2 + (yy - 24) ** 2 < 200) * 255.0], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.float32)
    if kind == "signed":
        img = img / 127.5 - 1.0
    elif kind == "gray":
        img = img.mean(-1)
    want = JCannyEdgeMapper(JCannyEdgeMapperConfig())({"image": img})["edge"]
    got = CannyEdgeMapper(CannyEdgeMapperConfig())({"image": img})["edge"]
    assert got.shape == (48, 64, 3) and got.dtype == np.float32
    assert np.array_equal(got, want) and 0 < got.mean() < 0.5


def tiny_dpt_kw():
    return dict(dim=32, depth=4, heads=2, features=16, hooks=(0, 1, 2, 3))


@functools.lru_cache(maxsize=None)
def jax_dpt(seed=0):
    """The tiny JAX DPT's jitted apply and its perturbed params."""
    net = jdepth.DPTDepth(patch=16, **tiny_dpt_kw())
    params = flax_params(net, seed, jnp.zeros((1, 32, 32, 3)))
    params["params"]["head_conv3"]["bias"] = params["params"]["head_conv3"]["bias"] + 3.0  # depth mostly > 0
    return jax.jit(net.apply), params


def port_dpt(params):
    net = DPTDepth(**tiny_dpt_kw(), image_size=32)
    net.load_state_dict(dpt_from_jax(params, depth=4))
    return net.eval()


def test_resize_like_jax(jax_ref):
    """``resize_like_jax`` against ``jax.image.resize(..., "bilinear")``,
    shrinking (antialiased), growing, and both at once: 1e-6."""
    x = np.random.default_rng(8).standard_normal((1, 40, 56, 3)).astype(np.float32)
    for size in ((24, 32), (64, 80), (30, 70)):
        want = jax.image.resize(jnp.asarray(x), (1, *size, 3), "bilinear")
        got = resize_like_jax(t_(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        close(got, want, 1e-6, str(size))


def test_depth_mapper_matches_jax(jax_ref):
    """``DepthMapper(make_depth_fn(tiny DPT, size 32))`` on a 48×40 image in
    0–255 against the JAX depth fn as ``make_depth_fn`` builds it (resize to
    32², the DPT, resize back, min-max), on the same params: 1e-4."""
    apply, params = jax_dpt()

    def jax_depth_fn(image):  # the body of JAX make_depth_fn at size 32
        img = np.asarray(image, np.float32)
        img = img / 255.0 if img.max() > 1.5 else img
        h, w = img.shape[:2]
        x = jax.image.resize(jnp.asarray(img)[None], (1, 32, 32, 3), "bilinear")
        d = apply(params, x)[0]
        d = np.asarray(jax.image.resize(d[None, :, :, None], (1, h, w, 1), "bilinear")[0, :, :, 0])
        return (d - d.min()) / (d.max() - d.min() + 1e-8)

    from flash_diffusion_tpu.data.mappers import DepthMapper as JDepthMapper
    from flash_diffusion_tpu.data.mappers import DepthMapperConfig as JDepthMapperConfig

    img = np.random.default_rng(9).uniform(0, 255, (48, 40, 3)).astype(np.float32)
    want = JDepthMapper(JDepthMapperConfig(), jax_depth_fn)({"image": img})["depth"]
    got = DepthMapper(DepthMapperConfig(), make_depth_fn(port_dpt(params), size=32))({"image": img})["depth"]
    assert got.shape == (48, 40, 3) and got.min() >= 0 and got.max() <= 1
    close(got, want, 1e-4)


def test_dpt_matches_jax(jax_ref):
    """The tiny DPT through ``dpt_from_jax`` (``up_0``, ``up_1`` flipped)
    on a 32² image: 1e-4 of max|depth|."""
    apply, params = jax_dpt()
    x = np.random.default_rng(10).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_dpt(params)(t_(x))
    assert got.shape == (1, 32, 32) and (want > 0).mean() > 0.5
    close(got, want, 1e-4)


def test_import_dpt_large_loads_midas_and_shows_the_flip(jax_ref):
    """A synthetic MiDaS ``dpt_large`` state dict (tiny shapes, MiDaS's
    names, the dead ``refinenet4.resConfUnit1``): ``import_dpt_large`` keeps
    every key the port's module holds, unchanged, and drops only dead ones.
    The port on it equals JAX on the same file with its ConvTranspose
    kernels flipped (2e-6), and differs from JAX on the file as it is by
    more than 50 times that."""
    from test_depth import _synthetic_midas_sd

    sd = _synthetic_midas_sd(np.random.RandomState(0))
    sd["scratch.output_conv.4.bias"] = sd["scratch.output_conv.4.bias"] + 1.0  # depth mostly > 0
    imported = import_dpt_large(sd, depth=4)
    assert all(k.startswith(DEAD_MIDAS_PREFIXES) for k in set(sd) - set(imported))
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in imported.items())
    net = DPTDepth(**tiny_dpt_kw(), image_size=32)
    net.load_state_dict(imported)
    flipped = dict(sd)
    for k in ("pretrained.act_postprocess1.4.weight", "pretrained.act_postprocess2.4.weight"):
        flipped[k] = sd[k][:, :, ::-1, ::-1].copy()
    jnet = jdepth.DPTDepth(patch=16, **tiny_dpt_kw())
    x = np.random.default_rng(11).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(t_(x))
    apply = jax.jit(jnet.apply)
    same = np.asarray(apply(jdepth.import_dpt_large(flipped, depth=4), jnp.asarray(x)))
    as_is = np.asarray(apply(jdepth.import_dpt_large(sd, depth=4), jnp.asarray(x)))
    assert (same > 0).mean() > 0.5
    close(got, same, 2e-6)  # fp32 sums in another order: 2.4e-7 measured
    assert np.abs(got.numpy() - as_is).max() > 50 * 2e-6  # the flip: 1.2e-4 measured


def test_dpt_attention_takes_k1_at_577_keys():
    """The DPT's self-attention at 384² ([16·B, 577, 577, 64]) is K1's: the
    one-shot plan at 64 q rows, (64 + 2·592)·72·2 = 179,712 B of shared
    memory; not the packed one-shot kernel (align128(577) = 640 > 256)."""
    assert tattn.attention_plan(577, 64) == ("flash_fwd_oneshot", 64)
    assert tattn.smem_bytes(64, 592, 64) == 179712 <= tattn._SMEM_LIMIT
    assert not tattn.packed_cross_eligible(torch.empty(1, 577, 16, 64), 577)


# ---------------------------------------------------------------- the step
class _JCond:
    def __call__(self, params, batch, rng=None, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": {"crossattn": batch["crossattn"] * (0.0 if ucg_keys else 1.0)}}


class _TCond:
    def __call__(self, batch, generator=None, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": {"crossattn": batch["crossattn"] * (0.0 if ucg_keys else 1.0)}}


STEP_KW = dict(K=[2, 2], num_iterations_per_K=[2, 2], guidance_scale_min=1.0, guidance_scale_max=3.0,
               mixture_num_components=2, use_dmd_loss=True, gan_loss_type="hinge", adversarial_loss_scale=[0.5, 1.0],
               adapter_input_key="edge", adapter_conditioning_scale=0.5)


@functools.lru_cache(maxsize=None)
def adapter_models():
    """The tiny UNet of test_torch_train with the tiny adapter, DMD, hinge
    GAN, K = [2, 2], in both packages; a perturbed LoRA."""
    net, uparams = jax_unet()
    anet, aparams = jax_adapter()
    jdisc = JConvDiscriminator(JDiscriminatorConfig(feature_dim=8, num_stages=1))
    dparams = flax_params(jdisc, 3, jnp.zeros((B, HW // 2, HW // 2, 32)))
    lora = perturbed(jlora.init_lora(uparams, 2, jax.random.PRNGKey(5)), 6)
    jmodel = JFlashDiffusion(JFlashDiffusionConfig(**STEP_KW), student_module=net, teacher_module=net, adapter=anet,
                             conditioner=_JCond(), discriminator=jdisc, lora_scaling=0.5)
    dcfg = DiscriminatorConfig(feature_dim=8, num_stages=1)
    disc = ConvDiscriminator(dcfg, in_channels=32)
    disc.load_state_dict(discriminator_from_jax(dparams, dcfg))
    tmodel = FlashDiffusion(FlashDiffusionConfig(**STEP_KW), port_unet(uparams).requires_grad_(False),
                            conditioner=_TCond(), discriminator=disc, lora_scaling=0.5, adapter=port_adapter(aparams))
    tl = {k: {n: v.requires_grad_() for n, v in ab.items()}
          for k, ab in lora_from_jax(lora, UNetConfig(**UNET_KW)).items()}
    tmodel.attach_lora(tl)
    frozen = {"teacher": uparams, "adapter": aparams}
    return jmodel, frozen, lora, dparams, tmodel, tl, dcfg


def test_adapter_step_losses_and_grads_match_jax(jax_ref):
    """One adapter distillation step (``test_adapter_train_path``'s
    wiring: residuals at scale 0.5 into the student, the rollout, DMD's
    real and fake scores and the GAN's pass) with pre-staged ``__z`` and
    ``__conds`` and JAX's draws: the losses and the LoRA and
    discriminator gradients against ``jax.value_and_grad``, 1e-4. An
    all-zero edge map gives another loss."""
    jmodel, frozen, lora, dparams, tmodel, tl, dcfg = adapter_models()
    rng = np.random.default_rng(18)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    conds = [rng.standard_normal((B, 8, 16)).astype(np.float32) for _ in range(3)]
    conds[2][:] = 0.0
    e = edges(12)
    stage, key = 1, jax.random.PRNGKey(19)

    def jbatch(edge):
        return {"__z": jnp.asarray(z), "edge": jnp.asarray(edge),
                "__conds": tuple({"cond": {"crossattn": jnp.asarray(c)}} for c in conds)}

    loss_fn = lambda tr, edge: jmodel.losses(tr, frozen, jbatch(edge), key, stage)
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"lora": lora, "disc": dparams}, e)
    draws = jax_step_draws(jmodel, key, stage, z)
    tbatch = {"__z": t_(z), "edge": t_(e), "__conds": tuple({"cond": {"crossattn": t_(c)}} for c in conds)}
    for ab in tl.values():
        for v in ab.values():
            v.grad = None
    tmodel.discriminator.zero_grad(set_to_none=True)
    got, got_aux = tmodel.losses(tbatch, draws, stage)
    got.backward()
    close(got, total, 1e-4, "total")
    for k in ("loss/distill", "loss/dmd", "loss/gan_g", "loss/gan_d", "loss/generator"):
        close(got_aux[k], aux[k], 1e-4, k)
    want_lora = lora_from_jax(grads["lora"], UNetConfig(**UNET_KW))
    for name, ab in tl.items():
        for k in ("a", "b"):
            close(ab[k].grad, want_lora[name][k], 1e-4, f"{name}.{k}")
    want_disc = discriminator_from_jax(grads["disc"], dcfg)
    for name, p in tmodel.discriminator.named_parameters():
        close(p.grad, want_disc[name], 1e-4, name)
    with torch.no_grad():
        other, _ = tmodel.losses({**tbatch, "edge": torch.zeros_like(tbatch["edge"])}, draws, stage)
    assert abs(float(other) - float(got.detach())) > 1e-4


@pytest.mark.parametrize("who", ["student", "teacher"])
def test_sample_with_adapter_matches_jax(jax_ref, who):
    """``sample`` with the edge map at ``adapter_conditioning_scale`` 0.7:
    the LCM student with the LoRA (4 steps, guidance 1, step noise from
    JAX's key splits) or the teacher (Euler, 2 steps, CFG 5, the residuals
    doubled); latents out, 1e-4."""
    from test_torch_trainer_run import jax_step_noise

    jmodel, frozen, lora, _, tmodel, _, _ = adapter_models()
    rng = np.random.default_rng(13)
    z = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    ctx, e = _cond(14), edges(15)
    key, teacher = jax.random.PRNGKey(16), who == "teacher"
    steps = 2 if teacher else 4
    want = jmodel.sample(frozen, None if teacher else lora, jnp.asarray(z),
                         {"crossattn": jnp.asarray(ctx), "edge": jnp.asarray(e)}, num_steps=steps, decode=False,
                         use_teacher=teacher, teacher_guidance_scale=5.0, rng=key, adapter_conditioning_scale=0.7)
    tl = lora_from_jax(lora, UNetConfig(**UNET_KW))
    got = tmodel.sample(None if teacher else tl, t_(z), {"crossattn": t_(ctx), "edge": t_(e)}, num_steps=steps,
                        decode=False, use_teacher=teacher, teacher_guidance_scale=5.0,
                        noise=None if teacher else jax_step_noise(key, z.shape, steps),
                        adapter_conditioning_scale=0.7)
    close(got, want, 1e-4)


# ---------------------------------------------------------------- build_trainer
def test_build_trainer_sd15_canny_reads_the_yaml(monkeypatch, tmp_path):
    """``build_trainer("sd15-canny")`` on tiny modules (a 4-level VAE:
    latents / 8, as the adapter's first level) with
    ``flash_canny_adapter.yaml`` stage 1: the yaml's K, guidance, losses and
    adapter scale, the DDPM teacher and Euler validation sampler, a 0-stage
    discriminator at mid size 1; ``build_data`` over JPEG shards ends in the
    Canny mapper (a binary ``edge`` map), the text ids are zeros; one
    ``fit`` step moves the LoRA and leaves the bf16 adapter, which no
    optimizer holds; ``sample`` at scale 1 and 0 differ. Synthetic batches
    carry an ``edge`` map too."""
    from flash_diffusion_tpu_torch import sample, train
    from flash_diffusion_tpu_torch.models import AutoencoderKLConfig
    from flash_diffusion_tpu_torch.models.embedders import ClipEmbedderConfig
    from flash_diffusion_tpu_torch.schedulers import REGISTRY
    from test_torch_trainer_run import write_shards

    monkeypatch.setattr(sample, "sd15_unet_config", lambda **kw: UNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(sample, "sd_vae_config", lambda: AutoencoderKLConfig(
        block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=8))
    monkeypatch.setattr(sample, "ClipEmbedderConfig", lambda **kw: ClipEmbedderConfig(**kw, text_embedder_config=dict(
        vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, max_positions=77,
        eos_token_id=49407)))
    monkeypatch.setattr(train, "T2IAdapterConfig", lambda: T2IAdapterConfig(**ADAPTER_KW))
    yaml_cfg = train.load_config(train.CONFIGS["sd15-canny"])
    cfg = {**yaml_cfg, "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000], "LORA_RANK": 4, "IMAGE_SIZE": 64,
           "BATCH_SIZE": 2, "SHARDS_PATH_OR_URLS": [os.path.join(str(tmp_path), "{000000..000001}.tar")],
           "SHUFFLE_BUFFER_SIZE": 4}
    write_shards(str(tmp_path), 2, 4, seed=0)
    trainer = train.build_trainer("sd15-canny", device="cpu", config=cfg)
    fl = trainer.model
    mc = fl.config
    assert mc.K == yaml_cfg["K"] == [16] * 4 and mc.adapter_input_key == "edge"
    assert mc.adapter_conditioning_scale == yaml_cfg["ADAPTER_CONDITIONING_SCALE"] and mc.use_empty_prompt
    assert (mc.distill_loss_type, mc.gan_loss_type, mc.use_dmd_loss) == ("l2", "hinge", True)
    assert mc.adversarial_loss_scale == yaml_cfg["ADVERSARIAL_LOSS_SCALE"]
    assert fl.teacher_sched_mod is REGISTRY["DDPMScheduler"]
    assert fl.teacher_sampling_sched_mod is REGISTRY["EulerDiscreteScheduler"]
    assert fl.discriminator.config.num_stages == 0 and train.LORA_PREFIX[train.FAMILY["sd15-canny"]] == "unet"
    adapter = fl.adapter
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in adapter.parameters())
    assert any(p.abs().max() > 0 for p in adapter.parameters())  # from the seed, never the JAX example's zeros
    held = {id(p) for o in (trainer.opt_g, trainer.opt_d) for p in o.params}
    assert not held & {id(p) for p in adapter.parameters()}
    tok = train.make_tokenizer("sd15-canny", cfg)
    data = iter(train.tokenize_batches(train.build_data(cfg, train.data_mappers("sd15-canny"), num_workers=1), tok,
                                       "sd15-canny", 64))
    batch = next(data)
    assert batch["edge"].shape == (2, 64, 64, 3) and set(np.unique(batch["edge"])) <= {0.0, 1.0}
    assert not np.asarray(batch["text_ids"]).any()
    before = [p.detach().clone() for p in adapter.parameters()]
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    aux = trainer.fit([batch], max_steps=1)
    assert all(np.isfinite(float(v)) for v in aux.values())
    assert all(torch.equal(a, b) for a, b in zip(before, adapter.parameters()))
    assert any(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items())
    synth = next(train.synthetic_batches(2, 64, model="sd15-canny"))
    assert synth["edge"].shape == (2, 64, 64, 3) and not synth["text_ids"].any()
    staged = trainer.stage_batch(batch)
    z = torch.randn(2, 8, 8, C, generator=torch.Generator().manual_seed(0))
    outs = [fl.sample(trainer.lora, z, staged, num_steps=2, decode=False,
                      noise=[torch.zeros_like(z)] * 2, adapter_conditioning_scale=s) for s in (1.0, 0.0)]
    assert (outs[0] - outs[1]).abs().max() > 1e-3


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA-only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dpt_attention_k1_matches_plain_on_card(cuda):
    """K1 at the DPT's [16, 577, 577, 64] (ViT-L at 384², batch 1), bf16,
    against the plain version in fp32 under ``attention_fwd_gate``;
    launched once."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(16, 577, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    n = tattn.LAUNCHES["flash_fwd_oneshot"]
    out, lse = tattn.flash_attention_bhsd(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd_oneshot"] == n + 1
    ref_out, ref_lse = tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), 64 ** -0.5)
    ok, report = tattn.attention_fwd_gate(tattn.attention_fwd_errors(out, lse, ref_out, ref_lse))
    assert ok, report
