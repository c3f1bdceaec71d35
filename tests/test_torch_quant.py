"""The port's int8 W8A8 mode (``quant.py``, ``ops/gemm.py``, the int8 branch
of ``lora_dense``, ``FlashPipeline.quantize``) against the JAX package.

Inputs are made with numpy from seeds and go through both packages. What
is exact and what has a tolerance:

- weight codes (``quantize_weight``, ``quantize_dense``) and activation
  codes (``quantize_activation``, captured from the JAX ``int8_matmul``
  itself) are equal bit for bit: the same fp32 amax, division and
  round-half-to-even on both sides;
- the int32 sums are exact on both sides, so ``int8_matmul`` agrees to
  1e-6 relative in fp32 and to one bf16 ulp in bf16;
- through a whole UNet or the slice, the activations reaching each layer
  differ by fp32 rounding (~1e-6 relative) between the frameworks, and a
  code within that of a rounding boundary flips: each flip moves one
  output by s_x·|w| (1/127 of the row's largest term), and every layer
  after it quantizes slightly different inputs, so the difference grows to
  the size of the int8 rounding itself (here a single flip in the first
  block's to_out.0 grew to 2.6e-2 relative by the mid block). So the whole
  UNet and the slice are held to JAX's own spread: the port must lie as
  close to JAX as JAX's int8 output lies to itself under a ±1e-6 relative
  change of its input (``int8_spread``), times 2, and the int8 route must
  really differ from the float one (by 3× that distance). The exactness is
  proven layer by layer, where the inputs are the same.

Tests marked ``cuda`` hold the kernel against its plain version at the
SDXL serving shapes and run on the card only
(``python -m pytest --noconftest -m cuda tests/test_torch_*.py``).
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.lora import merge_lora
from flash_diffusion_tpu_torch.models import UNet2DCondition, sdxl_unet_config
from flash_diffusion_tpu_torch.models import UNetConfig as TUNetConfig
from flash_diffusion_tpu_torch.models.layers import LoraLinear
from flash_diffusion_tpu_torch.ops import gemm
from flash_diffusion_tpu_torch.quant import (
    SCALE_KEY,
    apply_weights,
    int8_matmul,
    quantize_activation,
    quantize_dense,
    quantize_weight,
)
from flash_diffusion_tpu_torch.utils import lora_from_jax, unet_from_jax
from test_torch_pipeline import (
    LATENT,
    SDXL_UNET_KW,
    jax_draws,
    jax_sdxl_parts,  # noqa: F401  (a fixture jax_sdxl_pipeline uses)
    jax_sdxl_pipeline,  # noqa: F401  (a fixture)
    port_sdxl_pipeline,
    tiny_port_pipeline,
)

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp

    from flash_diffusion_tpu import lora as jlora
    from flash_diffusion_tpu import quant as jquant
    from flash_diffusion_tpu.ops import gemm as jgemm
except ImportError:
    jax = None

torch.set_num_threads(2)

# SDXL 1024², batch 4, guidance 0: [M, K, N] of every int8 product
SDXL_SHAPES = [
    (16384, 640, 640), (308, 2048, 640), (16384, 640, 5120), (16384, 2560, 640),
    (4096, 1280, 1280), (308, 2048, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
]
TINY_MIN_DIM = 16  # quantizes every allowlisted layer of the tiny SDXL UNet


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


def within_bf16_ulp(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> bool:
    """|got − want| ≤ one bf16 ulp of ``want`` (or ``floor``, where larger).
    With tanh-gelu the floor is 1e-6: where 1 + tanh(u) cancels, outputs
    ~1e-6 in the negative tail carry the fp32 rounding of that sum."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w), torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((got.float() - w).abs() <= torch.clamp(ulp, min=floor)).all())


@pytest.mark.parametrize("shape", [(96, 80), (48, 40, 1, 1)])
def test_quantize_weight_codes_match_jax(jax_ref, shape):
    """[out, in] here, [in, out] in JAX: the codes transposed are equal, the
    scales too (a 1×1 conv's [out, in, 1, 1] is the same dense layer)."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[3] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, scale = quantize_weight(torch.tensor(w))
    jq, jscale = jquant.quantize_weight(jnp.asarray(w.reshape(shape[:2]).T))
    assert q.dtype == torch.int8 and q.shape == shape and scale.shape == (shape[0],)
    np.testing.assert_array_equal(q.reshape(shape[:2]).numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("m", [77, 111, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_codes_and_output_match_jax(jax_ref, monkeypatch, m, dtype):
    """The activation codes and scales, captured from the JAX ``int8_matmul``
    as it hands them to its kernel, equal the port's; the outputs (JAX's XLA
    route at this K) agree to 1e-6 relative in fp32, one ulp in bf16."""
    rng = np.random.default_rng(m)
    k, n = 64, 48
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 3, (m, 1))).astype(np.float32)
    x[5] = 0.0  # an all-zero token takes the 1e-8 floor
    xt = torch.tensor(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    wq, sw = quantize_weight(torch.tensor(rng.standard_normal((n, k)).astype(np.float32)))
    wj, swj = jnp.asarray(wq.t().numpy()), jnp.asarray(sw.numpy())

    seen = {}

    def capture(xq, sx, *_):
        seen["xq"], seen["sx"] = np.asarray(xq), np.asarray(sx)
        return jnp.zeros((xq.shape[0], n), jnp.bfloat16)

    with monkeypatch.context() as patch:
        patch.setattr(jgemm, "int8_gemm_eligible", lambda *_: True)
        patch.setattr(jgemm, "int8_gemm", capture)
        jquant.int8_matmul(xj, wj, swj)
    xq, s_x = quantize_activation(xt)
    np.testing.assert_array_equal(xq.numpy(), seen["xq"])
    np.testing.assert_array_equal(s_x.numpy(), seen["sx"])

    got = int8_matmul(xt, wq, sw)
    want = jquant.int8_matmul(xj, wj, swj)
    assert got.dtype == dtype and got.shape == (m, n)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        assert within_bf16_ulp(got, torch.tensor(np.asarray(want.astype(jnp.float32))))


@pytest.mark.parametrize("m", [64, 96])
@pytest.mark.parametrize("with_bias,act", [(False, None), (True, "gelu")])
def test_int8_gemm_reference_matches_jax_kernel(jax_ref, m, with_bias, act):
    """The plain version against the Pallas kernel in interpret mode (bf16
    out): equal without gelu; with it, ``within_bf16_ulp`` (1e-6 floor). m = 96 leaves a
    ragged second row block in the JAX grid."""
    rng = np.random.default_rng(1)
    k, n = 256, 128
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sx = rng.uniform(1e-4, 2e-4, m).astype(np.float32)
    sw = rng.uniform(1e-4, 2e-4, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    want = jgemm.int8_gemm(jnp.asarray(xq), jnp.asarray(sx[:, None]), jnp.asarray(wq.T),
                           jnp.asarray(sw[None]), None if bias is None else jnp.asarray(bias[None]), act)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
    got = gemm.int8_gemm(torch.tensor(xq), torch.tensor(sx), torch.tensor(wq), torch.tensor(sw),
                         None if bias is None else torch.tensor(bias), act)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    if act is None:
        assert torch.equal(got, want)
    else:
        assert within_bf16_ulp(got, want, 1e-6)


def test_int8_sums_reference_is_exact():
    """The fp64 route of the plain int32 sums equals integer arithmetic, at
    the largest |sum| a K = 5120 row can reach."""
    xq = torch.full((3, 5120), -127, dtype=torch.int8)
    wq = torch.randint(-127, 128, (5, 5120), generator=torch.Generator().manual_seed(0), dtype=torch.int8)
    wq[0] = -127
    sums = gemm.int8_sums_reference(xq, wq)
    assert sums.dtype == torch.int32 and sums[0, 0].item() == 127 * 127 * 5120
    assert torch.equal(sums, (xq.long() @ wq.long().t()).int())


@pytest.fixture(scope="module")
def tiny_sdxl_jax_unet():
    if jax is None:
        pytest.skip("needs the JAX reference package")
    from flash_diffusion_tpu import models as jm
    from test_torch_pipeline import perturbed

    unet = jm.UNet2DCondition(jm.UNetConfig(**SDXL_UNET_KW))
    params = perturbed(jax.jit(unet.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
        {"cond": {"crossattn": jnp.zeros((1, 16, 64)), "vector": jnp.zeros((1, 72))}},
    ), 5)
    return unet, params, TUNetConfig(**SDXL_UNET_KW, use_linear_projection=True)


@pytest.mark.parametrize("parts", [[1024, 1024], [512] * 4, [256] * 8, [640, 128, 1280]])
def test_int8_sums_split_along_k_add_up_exactly(parts):
    """What K11's split of K rests on: int32 sums over any cut of K into
    parts, added, equal the sums over all of K bit for bit (integer sums
    do not round), at the cross-attention's [308, 2048] · [640, 2048]ᵀ with
    rows of extreme codes; so the bf16 output from them is the same too."""
    rng = np.random.default_rng(12)
    xq = torch.from_numpy(rng.integers(-127, 128, (308, 2048), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (640, 2048), dtype=np.int8))
    xq[0], wq[0] = 127, -127  # the largest |sum|, 127² · 2048
    sx, sw = torch.from_numpy(rng.random(308, dtype=np.float32)), torch.from_numpy(rng.random(640, dtype=np.float32))
    whole = gemm.int8_sums_reference(xq, wq)
    edges = np.cumsum([0, *parts])
    split = sum(gemm.int8_sums_reference(xq[:, a:b].contiguous(), wq[:, a:b].contiguous())
                for a, b in zip(edges[:-1], edges[1:]))
    assert split.dtype == torch.int32 and torch.equal(split, whole) and whole[0, 0] == -127 ** 2 * 2048
    y = (split.float() * sx[:, None] * sw[None, :]).to(torch.bfloat16)
    assert torch.equal(y, gemm.int8_gemm_reference(xq, sx, wq, sw))


# [M, K, N] of K11 on the card: SDXL's int8 products and the checks' extra
# cases (batch 1's k/v, ragged M and N, K off the 128-byte step, odd N)
# Pixart-α 1024² at batch 4: q/k/v/out and attn2 q/out over 16384 tokens,
# attn2 k/v over 4 × 120 T5 tokens, ff.net.0.proj and ff.net.2
PIXART_SHAPES = [(16384, 1152, 1152), (480, 1152, 1152), (16384, 1152, 4608), (16384, 4608, 1152)]
K11_CALLS = SDXL_SHAPES + PIXART_SHAPES + [(77, 2048, 640), (4001, 1280, 1000), (300, 96, 130), (65, 96, 7),
                                           (1000, 640, 1000)]


@pytest.mark.parametrize("m,k,n", K11_CALLS)
def test_int8_gemm_plan_fits_covers_and_splits(m, k, n):
    """K11's plan on 132 SMs: 128 × 128 tiles, 4–8 stages that fit a block
    beside the two warpgroups' output tiles, a launch that covers every
    tile;
    where it splits K (the cross-attention's k/v at M = 77 and 308), a
    split that divides the K steps with tiles × split within the SMs. The
    plan may follow M: the sums are exact in any order."""
    p = gemm.int8_gemm_plan(m, k, n, 132)
    steps = -(-k // 128)
    assert p.bn == 128 and 4 <= p.stages <= 8 and p.threads == 288
    assert p.smem == 1024 + 2 * 128 * 128 * 2 + 16 + p.stages * (256 * 128 + 16) <= 232448
    for split in (1, 2, 4, 8):  # every split the sweep asks for fits as the plan's does
        assert gemm.int8_gemm_plan(m, k, n, 132, split).smem == p.smem
    tiles = -(-m // 128) * -(-n // p.bn)
    if p.split > 1:
        assert p.bn == 128 and steps % p.split == 0 and p.blocks == tiles * p.split <= 132
    else:
        assert p.blocks == min(tiles, 132)
    assert (p.split > 1) == (m in (77, 308))


def test_quantize_dense_matches_jax_on_the_tiny_sdxl_unet(tiny_sdxl_jax_unet):
    """Same count as JAX, and each quantized layer's codes and scale equal
    JAX's for the same weights."""
    _, params, cfg = tiny_sdxl_jax_unet
    jq, jn = jquant.quantize_dense(params, min_dim=TINY_MIN_DIM)
    state, n = quantize_dense(unet_from_jax(params, cfg), min_dim=TINY_MIN_DIM)
    want = unet_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), jq), cfg)  # int8 codes as floats, same layout
    assert n == jn > 0
    assert sum(k.endswith(SCALE_KEY) for k in state) == n
    for key, t in state.items():
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.float().numpy(), want[key].numpy())


def test_quantize_dense_counts_722_layers_of_the_sdxl_unet():
    """The full SDXL UNet, built on the meta device: 70 transformer blocks ×
    10 layers and 11 spatial transformers × 2; the time and add_embedding
    linears stay float."""
    with torch.device("meta"):
        state = UNet2DCondition(sdxl_unet_config()).state_dict()
    out, n = quantize_dense(state)
    assert n == 722
    names = [k[: -len(".weight")] for k, t in out.items() if t.dtype == torch.int8]
    assert sum(".transformer_blocks." in k for k in names) == 700
    assert sum(k.endswith(("proj_in", "proj_out")) and ".ff." not in k for k in names) == 22
    assert all(not k.startswith(("time_embedding", "add_embedding")) for k in names)


def test_quantize_dense_allowlist_and_filters():
    """Only the layers with an int8 branch quantize (a plain linear such as
    a context embedder does not, nor a root-level ``proj_out`` head);
    ``min_dim`` applies to both dims; ``include=None`` takes any layer."""
    w = torch.ones(512, 512)
    state = {
        "context_embedder.weight": w,
        "blocks.0.attn.to_q.weight": w,
        "blocks.0.ff.net.2.weight": w,
        "blocks.0.attn.to_out.0.weight": torch.ones(512, 128),
        "proj_out.weight": w,
        "blocks.0.attn.to_q.bias": torch.ones(512),
    }
    out, n = quantize_dense(state)
    assert n == 2
    assert out["blocks.0.attn.to_q.weight"].dtype == torch.int8
    assert out["blocks.0.ff.net.2.weight"].dtype == torch.int8
    for key in ("context_embedder.weight", "proj_out.weight", "blocks.0.attn.to_out.0.weight"):
        assert out[key] is state[key]
    assert quantize_dense(state, min_dim=128)[1] == 3
    assert quantize_dense(state, include=None)[1] == 4


def test_side_path_on_int8_weights_matches_jax(jax_ref):
    """A LoRA pair attached to an int8 layer still adds (x·A)·B, and the
    layer (int8 product, side path, bias) agrees with the JAX ``LoraDense``."""
    from flash_diffusion_tpu.models.layers import LoraDense

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48)).astype(np.float32)
    dense = LoraDense(64)
    params = jax.tree_util.tree_map(lambda a: a + 0.1, dense.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    qparams, n = jquant.quantize_dense(params, min_dim=32, include=None)
    lora = {"a": rng.standard_normal((48, 2)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((2, 64)).astype(np.float32) * 0.1}
    want = dense.apply({**qparams, "lora": {"kernel": lora}}, jnp.asarray(x))

    layer = LoraLinear(48, 64)
    state, tn = quantize_dense({"weight": torch.tensor(np.asarray(params["params"]["kernel"]).T),
                                "bias": torch.tensor(np.asarray(params["params"]["bias"]))},
                               min_dim=32, include=None)
    apply_weights(layer, state)
    assert tn == n == 1 and layer.weight.dtype == torch.int8
    xt = torch.tensor(x)
    base = layer(xt)
    layer.lora = (torch.tensor(lora["a"]), torch.tensor(lora["b"]), 1.0)
    got = layer(xt)
    np.testing.assert_allclose((got - base).detach().numpy(), x @ lora["a"] @ lora["b"], atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def jax_lora_tree(params, seed):
    tree = jlora.init_lora(params, rank=2, rng=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree)


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def int8_spread(f, x) -> float:
    """How far an int8 function's output moves under ±1e-6-relative changes
    of its input (fp32 rounding's size): the largest of three."""
    base = f(x)
    return max(rel_l2(f(x * (1 + e)), base) for e in (1e-6, -1e-6, 2e-6))


def test_int8_unet_with_merged_lora_matches_jax(tiny_sdxl_jax_unet):
    """One forward of the tiny SDXL UNet on ``quantize_dense(merge_lora(...))``
    in fp32 against the JAX UNet on the same transform, to 2× JAX's own
    spread (see the module docstring)."""
    unet, params, cfg = tiny_sdxl_jax_unet
    tree = jax_lora_tree(params, 7)
    merged = jlora.merge_lora(params, tree, 0.5)
    qparams, jn = jquant.quantize_dense(merged, min_dim=TINY_MIN_DIM)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, *LATENT)).astype(np.float32)
    t = np.array([999.0, 259.0], np.float32)
    cond = {"cond": {"crossattn": rng.standard_normal((2, 16, 64)).astype(np.float32),
                     "vector": rng.standard_normal((2, 72)).astype(np.float32)}}
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    forward = jax.jit(lambda p, x: unet.apply(p, x, t, jcond))
    want = forward(qparams, x)
    spread = int8_spread(lambda x: forward(qparams, x), x)

    port = UNet2DCondition(cfg).eval()
    state, n = quantize_dense(merge_lora(unet_from_jax(params, cfg), lora_from_jax(tree, cfg), 0.5),
                              min_dim=TINY_MIN_DIM)
    apply_weights(port, state)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), jax.tree_util.tree_map(torch.tensor, cond))
    assert n == jn
    err = rel_l2(got.numpy(), want)
    assert err <= 2 * spread, (err, spread)
    assert rel_l2(want, forward(merged, x)) >= 3 * err  # the int8 route ran


def test_int8_sdxl_slice_with_lora_matches_jax(jax_sdxl_pipeline):
    """The tiny SDXL slice: JAX ``load_lora(...)`` then ``quantize("int8")``
    and ``generate`` against the port doing the same on the same latents
    and step noise; fp32; to 2× JAX's own spread (module docstring)."""
    jpipe, uparams, vparams, cparams = jax_sdxl_pipeline
    tree = jax_lora_tree(uparams, 9)
    prompts = ["a raccoon reading a book", "an astronaut"]
    latents, noise = jax_draws(4, len(prompts), 4)
    jgen = lambda z: np.asarray(jpipe.generate(prompts, num_inference_steps=4, seed=4, latents=z))
    try:
        float_want = np.asarray(jpipe.generate(prompts, num_inference_steps=4, seed=4))
        jpipe.load_lora(tree, 0.5)
        jpipe.quantize("int8", min_dim=TINY_MIN_DIM)
        want = np.asarray(jpipe.generate(prompts, num_inference_steps=4, seed=4))
        # latents passed in keep the unsplit key: a different noise chain
        spread = int8_spread(jgen, jnp.asarray(latents.numpy()))
    finally:  # the module-scoped JAX pipeline goes back to float, no adapter
        jpipe.quantize("none")
        jpipe.unload_lora()
    pipe = port_sdxl_pipeline(uparams, vparams, cparams)
    pipe.load_lora(lora_from_jax(tree, pipe.denoiser.config), 0.5)
    pipe.quantize("int8", min_dim=TINY_MIN_DIM)
    assert pipe.adapters == {"default": 0.5}
    got = pipe.generate(prompts, latents=latents, noise=noise)
    err = rel_l2(got.numpy(), want)
    assert err <= 2 * spread, (err, spread)
    assert rel_l2(want, float_want) >= 3 * err  # the int8 route ran


def test_pipeline_int8_mode_and_back():
    """int8 stays near the float images; "none" restores them exactly (the
    base weights stay resident)."""
    pipe = tiny_port_pipeline()
    ref = pipe.generate(["cat"], num_inference_steps=2, seed=[3])
    pipe.quantize("int8", min_dim=8)
    assert any(t.dtype == torch.int8 for t in pipe.denoiser.state_dict().values())
    out = pipe.generate(["cat"], num_inference_steps=2, seed=[3])
    assert torch.isfinite(out).all() and ((out - ref).norm() / ref.norm()).item() < 0.5
    pipe.quantize("none")
    assert not any(k.endswith(SCALE_KEY) for k in pipe.denoiser.state_dict())
    assert torch.equal(pipe.generate(["cat"], num_inference_steps=2, seed=[3]), ref)
    with pytest.raises(ValueError):
        pipe.quantize("int4")


def test_pipeline_int8_no_match_raises_and_keeps_serving():
    pipe = tiny_port_pipeline()
    ref = pipe.generate(["cat"], num_inference_steps=2)
    with pytest.raises(ValueError, match="matched no"):
        pipe.quantize("int8", min_dim=4096)
    assert pipe.state is pipe.base_state
    assert torch.equal(pipe.generate(["cat"], num_inference_steps=2), ref)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SDXL_SHAPES + PIXART_SHAPES + [(77, 2048, 640), (1000, 640, 1000), (65, 96, 7)])
def test_int8_gemm_kernel_matches_plain_on_card(cuda, m, k, n):
    """The kernel's int32 sums equal the plain version's; its bf16 output is
    equal without gelu and within one ulp (1e-6 floor) with bias and gelu."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=cuda) * 1e-3
    sw = torch.rand(n, generator=g, device=cuda) * 1e-3
    bias = torch.randn(n, generator=g, device=cuda)
    sums = gemm.int8_gemm(xq, None, wq, None, out_dtype=torch.int32)
    assert torch.equal(sums, gemm.int8_sums_reference(xq, wq))
    assert torch.equal(gemm.int8_gemm(xq, sx, wq, sw), gemm.int8_gemm_reference(xq, sx, wq, sw))
    assert within_bf16_ulp(gemm.int8_gemm(xq, sx, wq, sw, bias, "gelu"),
                           gemm.int8_gemm_reference(xq, sx, wq, sw, bias, "gelu"), 1e-6)
    with pytest.raises(ValueError, match="K % 32"):
        gemm.int8_gemm(xq[:, :16].contiguous(), sx, wq[:, :16].contiguous(), sw)
    with pytest.raises(ValueError, match="bf16 or int32"):
        gemm.int8_gemm(xq, sx, wq, sw, out_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,big,k,n", [(77, 308, 2048, 640), (4096, 16384, 1280, 1280)])
def test_int8_gemm_rows_bit_equal_alone_and_inside_a_larger_m_on_card(cuda, m, big, k, n):
    """K11's plan follows M (77 and 308 rows split K across 40 and 120
    blocks; 4096 and 16384 rows are 320 and 1280 tiles on persistent
    blocks, so a row's tile lands on another block at another turn), its
    bits do not: batch slot 1's rows alone equal the same rows of the
    larger product, int32 sums and bf16 with bias and gelu."""
    g = torch.Generator(device=cuda).manual_seed(big)
    xq = torch.randint(-127, 128, (big, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    sx = torch.rand(big, generator=g, device=cuda) * 1e-3
    sw = torch.rand(n, generator=g, device=cuda) * 1e-3
    bias = torch.randn(n, generator=g, device=cuda)
    rows = slice(m, 2 * m)
    for args in ((None, None, None, None, torch.int32), (sx, sw, bias, "gelu", torch.bfloat16)):
        xs, ws, b, act, out = args
        whole = gemm.int8_gemm(xq, xs, wq, ws, b, act, out)
        alone = gemm.int8_gemm(xq[rows].contiguous(), None if xs is None else xs[rows].contiguous(), wq, ws, b, act,
                               out)
        assert torch.equal(whole[rows], alone)


@pytest.mark.cuda
def test_int8_pipeline_launches_the_kernel_on_card(cuda):
    """The tiny pipeline in bf16 int8 on the card: every int8 product is a
    launch of the kernel, and the images stay near the CPU fp32 int8 run."""
    ref = tiny_port_pipeline()
    pipe = tiny_port_pipeline(cuda, torch.bfloat16)
    for p in (ref, pipe):
        p.quantize("int8", min_dim=32)  # K11 takes K % 32 == 0
    n = sum(t.dtype == torch.int8 for t in pipe.state.values())
    gemm.LAUNCHES.clear()
    g = torch.Generator().manual_seed(0)
    latents, noise = torch.randn(2, *LATENT, generator=g), [torch.randn(2, *LATENT, generator=g) for _ in range(4)]
    images = pipe.generate(["a", "b"], latents=latents, noise=noise).cpu()
    assert gemm.LAUNCHES["int8_gemm"] == 4 * n
    want = ref.generate(["a", "b"], latents=latents, noise=noise)
    assert ((images - want).norm() / want.norm()).item() < 0.1
