"""Parity of the PyTorch port's ops with the JAX package, and kernel checks.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX Pallas kernels run in interpret mode (``tests/conftest.py``
sets ``FLASH_TPU_PALLAS_INTERPRET=1``) and against the JAX plain paths, in
fp32 on both sides with the same numpy inputs. Tolerances: 1e-5 absolute
for attention and GroupNorm (fp32, same math, sums in another order),
2e-5 for LayerNorm (E[x²] − E[x]² cancels a few more bits at unit scale).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one. The machine with the card has no JAX, so
they run there without the repo's conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.ops import attention as tattn
from flash_diffusion_tpu_torch.ops import norms as tnorms

try:  # the JAX reference; absent where only the port is installed
    import jax.numpy as jnp

    from flash_diffusion_tpu.ops import attention as jattn
    from flash_diffusion_tpu.ops import norms as jnorms
except ImportError:
    jnp = None

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA-only")
    return torch.device("cuda")


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs the JAX reference package")


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# (bh, sq, skv, d, kv_valid): D in {8, 16, 40}; ragged Sq; kv_valid masking;
# the last case has skv > 1024, where JAX takes its streaming kernel
ATTN_CASES = [
    (2, 40, 77, 8, None),
    (3, 37, 64, 16, 50),
    (2, 70, 77, 40, None),
    (1, 33, 96, 40, 77),
    (2, 20, 1100, 8, 1030),
]


@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", ATTN_CASES)
def test_attention_bhsd_matches_jax_flash_kernel(jax_ref, bh, sq, skv, d, kv_valid):
    rng = np.random.default_rng(bh * 1000 + sq)
    q, k, v = (_randn(rng, bh, s, d) for s in (sq, skv, skv))
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = jattn._flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, kv_valid=kv_valid
    )
    t_out, t_lse = tattn.flash_attention_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale, kv_valid
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_valid", [None, 60])
def test_dot_product_attention_matches_jax(jax_ref, kv_valid):
    rng = np.random.default_rng(7)
    q, k, v = _randn(rng, 2, 45, 2, 40), _randn(rng, 2, 77, 2, 40), _randn(rng, 2, 77, 2, 40)
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True, kv_valid=kv_valid
    )
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_valid=kv_valid
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_dot_product_attention_with_bias_matches_jax(jax_ref):
    """The causal-bias path (CLIP) is the plain path on both sides."""
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, 2, 12, 3, 16) for _ in range(3))
    bias = np.where(np.tril(np.ones((12, 12), bool)), 0.0, -1e9).astype(np.float32)[None, None]
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias)
    )
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=torch.from_numpy(bias)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# C = 128 and 256 take the JAX Pallas kernel under interpret; C = 96 its jnp path
@pytest.mark.parametrize("c", [128, 256, 96])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(jax_ref, c, affine):
    rng = np.random.default_rng(c)
    x = _randn(rng, 3, 16, c, scale=2.0) + 0.5
    w = (1.0 + _randn(rng, c, scale=0.1)) if affine else None
    b = _randn(rng, c, scale=0.1) if affine else None
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    want = jnorms.layer_norm(jnp.asarray(x), j(w), j(b), eps=1e-5)
    got = tnorms.layer_norm(torch.from_numpy(x), t(w), t(b), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax(jax_ref, act):
    """JAX is NHWC; the port is channel-first: same numbers, transposed."""
    rng = np.random.default_rng(11)
    x = _randn(rng, 2, 6, 5, 32, scale=3.0) + 1.0
    w, b = 1.0 + _randn(rng, 32, scale=0.2), _randn(rng, 32, scale=0.2)
    want = jnorms.group_norm(jnp.asarray(x), 8, jnp.asarray(w), jnp.asarray(b), 1e-6, act=act)
    got = tnorms.group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 8, torch.from_numpy(w), torch.from_numpy(b),
        1e-6, act=act,
    )
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5, rtol=0)


# Every SD1.5 attention call at 512² (batch folded into BH): kv, head dim,
# and the kernel the plan must give it
SD15_ATTENTION = [
    (4096, 40, "flash_fwd_stream"),  # level-0 self-attention
    (1024, 80, "flash_fwd_stream"),  # level-1 self-attention
    (256, 160, "flash_fwd_oneshot"),  # level-2 self-attention (16-row q tile)
    (64, 160, "flash_fwd_oneshot"),  # mid-block self-attention
    (77, 40, "flash_fwd_oneshot"),  # cross-attention over the 77 text tokens
    (77, 80, "flash_fwd_oneshot"),
    (77, 160, "flash_fwd_oneshot"),
    (4096, 512, "flash_fwd_stream"),  # VAE mid-block, single head, D = C
]


@pytest.mark.parametrize("kv,d,kernel", SD15_ATTENTION)
def test_attention_plan_at_sd15_shapes(kv, d, kernel):
    kind, bq = tattn.attention_plan(kv, d)
    assert kind == kernel and bq % 16 == 0
    if kind == "flash_fwd_oneshot":  # the whole padded KV fits one block
        assert tattn.smem_bytes(bq, -(-kv // 16) * 16, -(-d // 16) * 16) <= tattn._SMEM_LIMIT


def test_cpu_calls_take_the_plain_path_and_launch_nothing():
    before = dict(tattn.LAUNCHES), dict(tnorms.LAUNCHES)
    x = torch.randn(2, 16, 2, 8)
    tattn.dot_product_attention(x, x, x)
    tnorms.layer_norm(torch.randn(4, 32))
    assert (dict(tattn.LAUNCHES), dict(tnorms.LAUNCHES)) == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other non-CUDA device raises."""
    x = torch.empty(2, 16, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bhsd(x, x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.layer_norm(torch.empty(4, 8, device="meta"))


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", [
    (8, 4096, 77, 40, None), (8, 1000, 1024, 80, None), (8, 64, 64, 160, None),
    (2, 300, 256, 160, 200), (2, 512, 512, 512, 500), (3, 37, 1100, 16, 1030),
    (2, 130, 2000, 160, 1999), (4, 200, 4096, 40, None), (2, 77, 700, 8, None),
    (2, 100, 1500, 200, 1400), (1, 64, 4096, 512, None),
])
def test_attention_kernels_match_plain_on_card(cuda, bh, sq, skv, d, kv_valid):
    """bf16 kernel vs the plain version on the same inputs in fp32.
    Tolerance: bf16 rounding of p and of the output, |out| < 4 → 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, skv, skv))
    kind, _ = tattn.attention_plan(kv_valid or skv, d)
    n = tattn.LAUNCHES[kind]
    out, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES[kind] == n + 1
    ref_out, ref_lse = tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), d ** -0.5, kv_valid)
    assert (out.float() - ref_out).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype", [
    (4 * 4096, 320, torch.bfloat16), (4 * 1024 + 3, 640, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16), (4 * 77, 768, torch.float32), (37, 100, torch.bfloat16),
])
def test_layer_norm_kernel_matches_plain_on_card(cuda, rows, c, dtype):
    """Same math on both sides: bf16 differs by at most one rounding of the
    output (|y| < 8 → 1/32), fp32 by summation order (1e-4)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(rows, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    got = tnorms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    want = tnorms.layer_norm_reference(x, w, b)
    tol = 1 / 32 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(1, 8), (2, 1), (2, 4)])
def test_dot_product_attention_on_card_matches_cpu(cuda, b, h):
    """The [B, S, H, D] ⇄ [BH, S, D] relayout around the kernels, batch 1 and
    single head included, against the plain path on the CPU (bf16 tolerance)."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(b, s, h, 40, generator=g).to(torch.bfloat16) for s in (300, 77, 77))
    want = tattn.dot_product_attention(q.float(), k.float(), v.float())
    got = tattn.dot_product_attention(q.to(cuda), k.to(cuda), v.to(cuda)).float().cpu()
    assert (got - want).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(2, 16, 8, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention_bhsd(x, x, x, 1.0)  # fp32
    with pytest.raises(ValueError):
        tnorms.layer_norm(torch.randn(8, 16, device=cuda).t())  # not contiguous
