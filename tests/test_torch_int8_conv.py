"""The port's int8 W8A8 convolutions (``quant.int8_conv``, ``quantize_dense(...,
convs=True)``, the ``QConv2d`` and Upsample2D branches of
``models/layers.py``) against the JAX package.

Inputs are made with numpy from seeds and go through both packages. What
is exact and what has a tolerance:

- a conv's weight codes and scales (``quantize_weight``) and the
  activation codes and per-sample scales, captured from the JAX
  ``int8_conv`` as it hands them to ``lax.conv_general_dilated``, are equal
  bit for bit;
- the int32 sums are exact on both sides, so ``int8_conv`` agrees to 1e-6
  relative in fp32 and to one bf16 ulp in bf16, at 3×3 stride 1, 3×3
  stride 2 and 1×1;
- ``quantize_dense(convs=True)`` picks the same layers as JAX's on a tiny
  UNet, with the same codes; on the full UNets (built on the meta device)
  the counts JAX's allowlist gives: 49 convs in SDXL's, 64 in SD1.5's,
  of which 2 and 3 are upsampler convs, every K = kh·kw·Cin a multiple of
  32 (K11 takes them all);
- a whole tiny UNet with int8 convs and dense layers is held to JAX's own
  spread, as ``test_torch_quant.py`` holds the dense int8 UNet (see its
  docstring), with JAX under ``FLASH_TPU_FOLDED_UPSAMPLE=1``: on its
  default path the JAX upsampler uses the int8 codes without their scale,
  which ``test_jax_default_upsampler_drops_the_int8_scale`` shows.

Tests marked ``cuda`` hold the kernel's int32 sums over the im2col bit for
bit against the plain version at SDXL's conv shapes, and run on the card
only.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.models import UNet2DCondition, sd15_unet_config, sdxl_unet_config
from flash_diffusion_tpu_torch.models.layers import Upsample2D
from flash_diffusion_tpu_torch.ops import gemm
from flash_diffusion_tpu_torch.quant import (
    SCALE_KEY,
    apply_weights,
    im2col,
    int8_conv,
    quantize_conv_activation,
    quantize_dense,
    quantize_weight,
)
from flash_diffusion_tpu_torch.utils import unet_from_jax
from test_torch_adapters import flax_params
from test_torch_pipeline import LATENT, SDXL_UNET_KW
from test_torch_quant import TINY_MIN_DIM, int8_spread, rel_l2, within_bf16_ulp

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import quant as jquant
    from flash_diffusion_tpu.models import layers as jlayers
except ImportError:
    jax = None

torch.set_num_threads(2)

TINY_CONV_MIN_DIM = 32  # every resnet and sampler conv of the tiny SDXL UNet past its 32-channel level's in/out
# (kernel, stride, padding) of the UNet's convs: ResnetBlock2D's 3×3, Downsample2D's, the 1×1 shortcut
CONV_KINDS = [((3, 3), (1, 1), (1, 1)), ((3, 3), (2, 2), (1, 1)), ((1, 1), (1, 1), (0, 0))]


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture(scope="module")
def tiny_sdxl_jax_unet():
    """(the tiny SDXL-shaped JAX UNet, its params from a numpy seed, the
    port's config of it)."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu_torch.models import UNetConfig

    unet = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    params = flax_params(unet, 4, jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
                         {"cond": {"crossattn": jnp.zeros((1, 16, 64)), "vector": jnp.zeros((1, 72))}})
    return unet, params, UNetConfig(**SDXL_UNET_KW, use_linear_projection=True)


def test_quantize_weight_conv_codes_match_jax(jax_ref):
    """[out, in, kh, kw] here, HWIO in JAX: the codes transposed are equal,
    the scales too; the codes are laid out channels-last, so that the
    GEMM's [out, kh·kw·in] in JAX's (kh, kw, in) order is a view."""
    w = np.random.default_rng(0).standard_normal((48, 32, 3, 3)).astype(np.float32)
    w[5] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, scale = quantize_weight(torch.from_numpy(w))
    jq, jscale = jquant.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert q.dtype == torch.int8 and q.shape == (48, 32, 3, 3) and q.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    w2d = q.permute(0, 2, 3, 1).reshape(48, -1)
    assert w2d.data_ptr() == q.data_ptr() and w2d.is_contiguous()
    np.testing.assert_array_equal(w2d.numpy(), np.asarray(jq).reshape(-1, 48).T)


@pytest.mark.parametrize("kind", CONV_KINDS, ids=["3x3s1", "3x3s2", "1x1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_codes_and_output_match_jax(jax_ref, monkeypatch, kind, dtype):
    """The activation codes and per-sample scales, captured from the JAX
    ``int8_conv`` as it hands them to its conv, equal the port's; the
    output agrees to 1e-6 relative in fp32, one bf16 ulp in bf16."""
    (kh, kw), stride, padding = kind
    rng = np.random.default_rng(kh * 10 + stride[0])
    x = (rng.standard_normal((2, 32, 9, 11)) * np.array([1.0, 5.0])[:, None, None, None]).astype(np.float32)
    w = rng.standard_normal((48, 32, kh, kw)).astype(np.float32) * 0.1
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    x_nhwc = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1)).astype(jdtype)
    wq, w_scale = quantize_weight(torch.from_numpy(w))
    jwq, jscale = jquant.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))

    seen = {}
    conv = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *a, **kw):
        seen["xq"] = np.asarray(lhs)
        return conv(lhs, rhs, *a, **kw)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    pad = tuple((p, p) for p in padding)
    want = np.asarray(jquant.int8_conv(x_nhwc, jwq, jscale, stride, pad).astype(jnp.float32)).transpose(0, 3, 1, 2)
    xq, s_x = quantize_conv_activation(xt)
    np.testing.assert_array_equal(xq.numpy().transpose(0, 2, 3, 1), seen["xq"])
    xf = np.asarray(x_nhwc.astype(jnp.float32))
    np.testing.assert_array_equal(s_x.numpy(), np.maximum(np.abs(xf).max(axis=(1, 2, 3)), 1e-8) / 127.0)
    got = int8_conv(xt, wq, w_scale, stride, padding)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        assert within_bf16_ulp(got, torch.from_numpy(want.copy()))


@pytest.mark.parametrize("kind", CONV_KINDS, ids=["3x3s1", "3x3s2", "1x1"])
def test_im2col_rows_are_the_convolution(kind):
    """The int32 sums over ``im2col``'s rows equal an exact convolution of
    the codes (fp64, whose integer sums are exact), row (b, ho, wo), column
    n: the rows in (b, ho, wo) order and K in (kh, kw, c) order, with zero
    codes in the padding."""
    (kh, kw), stride, padding = kind
    g = torch.Generator().manual_seed(3)
    xq = torch.randint(-127, 128, (2, 32, 9, 11), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (16, 32, kh, kw), generator=g, dtype=torch.int8)
    rows = im2col(xq.contiguous(memory_format=torch.channels_last), (kh, kw), stride, padding)
    sums = gemm.int8_sums_reference(rows, wq.permute(0, 2, 3, 1).reshape(16, -1).contiguous())
    want = torch.nn.functional.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    assert rows.shape[1] == kh * kw * 32
    assert torch.equal(sums, want.permute(0, 2, 3, 1).reshape(-1, 16).to(torch.int32))


def test_quantize_dense_convs_match_jax_on_the_tiny_unet(tiny_sdxl_jax_unet):
    """``convs=True`` over the tiny SDXL UNet: the same layers as JAX's
    ``quantize_dense(convs=True)`` (equal counts; each int8 weight's codes
    equal JAX's), the resnet convs, the downsampler's and the upsampler's."""
    _, params, cfg = tiny_sdxl_jax_unet
    kw = dict(min_dim=TINY_MIN_DIM, convs=True, conv_min_dim=TINY_CONV_MIN_DIM)
    jq, jn = jquant.quantize_dense(params, **kw)
    jdense = jquant.quantize_dense(params, min_dim=TINY_MIN_DIM)[1]
    state, n = quantize_dense(unet_from_jax(params, cfg), **kw)
    want = unet_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), jq), cfg)
    convs = sorted(k[: -len(".weight")] for k, t in state.items() if t.dtype == torch.int8 and t.dim() == 4
                   and t.shape[2:] != (1, 1) or k.endswith("conv_shortcut.weight") and t.dtype == torch.int8)
    assert n == jn and n - jdense == len(convs) > 0
    assert any("upsamplers" in k for k in convs) and any("downsamplers" in k for k in convs)
    assert sum(k.endswith(SCALE_KEY) for k in state) == n
    for key, t in state.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.float().numpy(), want[key].numpy())


@pytest.mark.parametrize("config,n_convs,n_up", [(sdxl_unet_config, 49, 2), (sd15_unet_config, 64, 3)])
def test_quantize_dense_conv_counts_of_the_full_unets(config, n_convs, n_up):
    """The full UNets on the meta device: JAX's allowlist counts (49 SDXL,
    64 SD1.5, the upsamplers' 2 and 3 among them), conv_in and conv_out
    (4 channels) left float, and every conv's K = kh·kw·Cin a multiple of
    32, from 320 to 23040: the int8 GEMM kernel takes every one."""
    with torch.device("meta"):
        state = UNet2DCondition(config()).state_dict()
    dense = quantize_dense(state)[1]
    out, n = quantize_dense(state, convs=True)
    convs = {k[: -len(".weight")]: t for k, t in out.items()
             if t.dtype == torch.int8 and k.endswith(("conv1.weight", "conv2.weight", "conv_shortcut.weight",
                                                      "conv.weight"))}
    assert n - dense == len(convs) == n_convs
    assert sum("upsamplers" in k for k in convs) == n_up
    ks = [t.shape[1] * t.shape[2] * t.shape[3] for k, t in convs.items() if "upsamplers" not in k]
    assert all(k % 32 == 0 for k in ks) and (min(ks), max(ks)) == (320, 23040)


def test_upsampler_int8_weight_is_dequantized_as_jax_folded(jax_ref, monkeypatch):
    """An int8 Upsample2D: the port dequantizes codes · scale in fp32, as the
    JAX folded upsampler does (``FLASH_TPU_FOLDED_UPSAMPLE=1``), and agrees
    with it to 1e-5 in fp32."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 6, 32)).astype(np.float32)
    up = jlayers.Upsample2D(32)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 3, up.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    qparams, jn = jquant.quantize_dense(params, convs=True, conv_min_dim=32)
    monkeypatch.setenv("FLASH_TPU_FOLDED_UPSAMPLE", "1")
    want = np.asarray(up.apply(qparams, jnp.asarray(x))).transpose(0, 3, 1, 2)
    port = Upsample2D(32)
    p = params["params"]["conv"]
    state, n = quantize_dense({"conv.weight": torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()),
                               "conv.bias": torch.from_numpy(np.asarray(p["bias"]))}, convs=True, conv_min_dim=32)
    apply_weights(port, state)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert n == jn == 1 and port.conv.weight.dtype == torch.int8
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_jax_default_upsampler_drops_the_int8_scale(jax_ref, monkeypatch):
    """A finding on the JAX side, recorded, not repaired: on the default
    path (``FLASH_TPU_FOLDED_UPSAMPLE`` unset) JAX's Upsample2D promotes the
    int8 codes to float without their ``kernel_scale``, so
    ``quantize_dense(convs=True)``, which picks the upsampler's ``conv``,
    sends its output hundreds of times off the float one; the folded path
    dequantizes and stays within int8's error. The port follows the folded
    path."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((1, 8, 8, 128)).astype(np.float32))
    up = jlayers.Upsample2D(128)
    params = up.init(jax.random.PRNGKey(1), x)
    qparams, n = jquant.quantize_dense(params, convs=True)
    assert n == 1 and qparams["params"]["conv"]["kernel"].dtype == jnp.int8
    monkeypatch.delenv("FLASH_TPU_FOLDED_UPSAMPLE", raising=False)
    ref = up.apply(params, x)
    default = rel_l2(up.apply(qparams, x), ref)
    monkeypatch.setenv("FLASH_TPU_FOLDED_UPSAMPLE", "1")
    folded = rel_l2(up.apply(qparams, x), ref)
    assert default > 100 and folded < 2e-2, (default, folded)


def test_int8_conv_unet_matches_jax_folded(tiny_sdxl_jax_unet, monkeypatch):
    """One forward of the tiny SDXL UNet on ``quantize_dense(convs=True)``
    (dense layers and convs in int8) in fp32 against JAX's under
    ``FLASH_TPU_FOLDED_UPSAMPLE=1``, to 2× JAX's own spread, and the int8
    convs really ran (3× that distance from the dense-only int8 UNet)."""
    unet, params, cfg = tiny_sdxl_jax_unet
    kw = dict(min_dim=TINY_MIN_DIM, convs=True, conv_min_dim=TINY_CONV_MIN_DIM)
    qparams, jn = jquant.quantize_dense(params, **kw)
    dense_only = jquant.quantize_dense(params, min_dim=TINY_MIN_DIM)[0]
    monkeypatch.setenv("FLASH_TPU_FOLDED_UPSAMPLE", "1")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, *LATENT)).astype(np.float32)
    t = np.array([999.0, 259.0], np.float32)
    cond = {"cond": {"crossattn": rng.standard_normal((2, 16, 64)).astype(np.float32),
                     "vector": rng.standard_normal((2, 72)).astype(np.float32)}}
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    forward = jax.jit(lambda p, x: unet.apply(p, x, t, jcond))
    want = forward(qparams, x)
    spread = int8_spread(lambda x: forward(qparams, x), x)

    port = UNet2DCondition(cfg).eval()
    state, n = quantize_dense(unet_from_jax(params, cfg), **kw)
    apply_weights(port, state)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), jax.tree_util.tree_map(torch.tensor, cond))
    assert n == jn
    err = rel_l2(got.numpy(), want)
    assert err <= 2 * spread, (err, spread)
    assert rel_l2(want, forward(dense_only, x)) >= 3 * err  # the int8 convs ran


# SDXL 1024², batch 4: (B, Cin, H, W, Cout, k, stride) of the int8 convs on K11 (chip_smoke.py's INT8_CONVS_SDXL)
SDXL_CONVS = [(4, 320, 128, 128, 320, 3, 1), (4, 320, 128, 128, 320, 3, 2), (4, 320, 64, 64, 640, 1, 1),
              (4, 2560, 32, 32, 1280, 3, 1), (4, 960, 128, 128, 320, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,h,w,cout,k,s", SDXL_CONVS)
def test_int8_conv_sums_bit_equal_plain_on_card(b, cin, h, w, cout, k, s):
    """K11 over the im2col of SDXL's conv shapes: the int32 sums equal the
    plain version's bit for bit, and ``int8_conv`` on the card equals the
    plain version (CPU) within one bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(b, cin, h, w, generator=g, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wq, sw = quantize_weight(torch.randn(cout, cin, k, k, generator=g, device="cuda") * 0.05)
    pad = (k // 2, k // 2)
    xq, _ = quantize_conv_activation(x)
    rows = im2col(xq, (k, k), (s, s), pad)
    w2d = wq.permute(0, 2, 3, 1).reshape(cout, -1)
    sums = gemm.int8_gemm(rows, None, w2d, None, out_dtype=torch.int32)
    assert torch.equal(sums, gemm.int8_sums_reference(rows, w2d))
    got = int8_conv(x, wq, sw, (s, s), pad)
    want = int8_conv(x.cpu(), wq.cpu(), sw.cpu(), (s, s), pad)
    assert within_bf16_ulp(got.cpu(), want)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("channels,layers,down", [
    ((32, 64, 128), 2, ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"]),  # SDXL's levels, narrow
    ((32, 64, 128, 128), 1, ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]),  # SD1.5's
])
def test_chip_smoke_conv_products_follow_the_unet(monkeypatch, channels, layers, down):
    """``chip_smoke.unet_int8_convs``, which names the (M, K, N) phase 2
    gates for phase 14b, gives the products a UNet forward with
    ``convs=True`` hands the int8 GEMM, in order, and its upsampler count
    (at narrow widths with ``min_dim`` 32: the same structure as SDXL's
    and SD1.5's)."""
    from flash_diffusion_tpu_torch import quant

    cs = _chip_smoke()
    n = len(channels)
    cfg = dict(block_out_channels=list(channels), down_block_types=down, layers_per_block=layers,
               num_heads=[2] * n, cross_attention_dim=32, norm_num_groups=8)
    torch.manual_seed(0)
    unet = UNet2DCondition(type(sdxl_unet_config())(**cfg)).eval()
    state, _ = quantize_dense(unet.state_dict(), min_dim=10**9, convs=True, conv_min_dim=32)
    apply_weights(unet, state)
    seen = []
    real = quant.int8_gemm
    monkeypatch.setattr(quant, "int8_gemm", lambda xq, sx, wq, sw, **kw: seen.append(
        (xq.shape[0], xq.shape[1], wq.shape[0])) or real(xq, sx, wq, sw, **kw))
    with torch.no_grad():
        unet(torch.randn(2, 16, 16, 4), torch.tensor([999.0, 500.0]), {"cond": {"crossattn": torch.randn(2, 7, 32)}})
    convs, ups = cs.unet_int8_convs(2, 16, channels, layers, min_dim=32)
    assert seen == [cs.conv_gemm(c) for c in convs]
    assert len(ups) == sum(".upsamplers." in k and t.dtype == torch.int8 for k, t in state.items())
