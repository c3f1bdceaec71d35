"""Parity of the PyTorch port's ops with the JAX package, and kernel checks.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX Pallas kernels run in interpret mode (``tests/conftest.py``
sets ``FLASH_TPU_PALLAS_INTERPRET=1``) and against the JAX plain paths, in
fp32 on both sides with the same numpy inputs. Tolerances: 1e-5 absolute
for attention (the per-head and the packed [B, S, H·D] forms) and GroupNorm
(fp32, same math, sums in another order), 2e-5 for LayerNorm (E[x²] − E[x]²
cancels a few more bits at unit scale).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one. The machine with the card has no JAX, so
they run there without the repo's conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import json
import sys

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.ops import attention as tattn
from flash_diffusion_tpu_torch.ops import gemm as tgemm
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


# (b, sq, h, d, kv): the packed one-shot kernel's cases (77 text tokens,
# KV at the 256 limit, ragged Sq and KV)
PACKED_CASES = [(2, 260, 4, 64, 77), (1, 33, 2, 128, 256), (2, 70, 4, 64, 200)]


@pytest.mark.parametrize("b,sq,h,d,kv", PACKED_CASES)
def test_attention_packed_matches_jax_packed_kernel(jax_ref, b, sq, h, d, kv):
    """The plain version of the packed kernel vs JAX ``_flash_fwd_packed``
    (its one-shot Pallas kernel, in interpret mode) on [B, S, H·D]."""
    rng = np.random.default_rng(b * 100 + sq + kv)
    q, k, v = _randn(rng, b, sq, h, d), _randn(rng, b, kv, h, d), _randn(rng, b, kv, h, d)
    scale = 1.0 / np.sqrt(d)
    want = jattn._flash_fwd_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    flat = lambda a: torch.from_numpy(a).reshape(a.shape[0], a.shape[1], h * d)
    got = tattn.flash_attention_packed(flat(q), flat(k), flat(v), h, scale)
    assert got.shape == (b, sq, h * d)
    np.testing.assert_allclose(got.reshape(b, sq, h, d).numpy(), np.asarray(want), atol=1e-5, rtol=0)


# (b, sq, h, d, kv, kv_valid): eligible (SDXL cross-attention at both levels,
# D = 128, KV 256) and not (D = 40, KV 1024, one head, kv_valid set)
PACKED_DISPATCH = [
    (2, 4096, 10, 64, 77, None), (2, 1024, 20, 64, 77, None), (1, 33, 8, 128, 256, None),
    (2, 64, 8, 40, 77, None), (2, 64, 10, 64, 1024, None), (2, 64, 1, 64, 77, None),
    (2, 64, 4, 64, 96, 77),
]


@pytest.mark.parametrize("b,sq,h,d,kv,kv_valid", PACKED_DISPATCH)
def test_packed_dispatch_matches_jax(jax_ref, monkeypatch, b, sq, h, d, kv, kv_valid):
    """``packed_cross_eligible`` agrees with JAX ``_packed_cross_eligible``,
    and ``dot_product_attention`` sends exactly those calls (and none with
    ``kv_valid``) to the packed path, as ``_attn_primal`` does."""
    q = np.zeros((b, sq, h, d), np.float32)
    want = kv_valid is None and jattn._packed_cross_eligible(q, kv)
    assert (kv_valid is None and tattn.packed_cross_eligible(torch.from_numpy(q), kv)) == want
    calls = []
    real = tattn.flash_attention_packed
    monkeypatch.setattr(tattn, "flash_attention_packed",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    kv_t = torch.zeros(1, kv, h, d)
    tattn.dot_product_attention(torch.zeros(1, 2, h, d), kv_t, kv_t, kv_valid=kv_valid)
    assert bool(calls) == want


def test_dot_product_attention_packed_path_matches_jax(jax_ref):
    """A packed-eligible [B, S, H, D] call (D = 64, 2 heads, 77 keys)
    through both packages' dispatch, the JAX side on its Pallas kernels."""
    rng = np.random.default_rng(9)
    q, k, v = _randn(rng, 2, 50, 2, 64), _randn(rng, 2, 77, 2, 64), _randn(rng, 2, 77, 2, 64)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
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


@pytest.mark.parametrize("b,n,c", [(1, 64 * 64, 128), (2, 16 * 16, 64), (3, 8 * 8, 32)])
def test_group_norm_stats_reference_matches_jax_pallas_stats(jax_ref, b, n, c):
    """The plain version of the statistics kernel against JAX
    ``_gn_stats_pallas`` (interpret mode) on the same tensor, NCHW here and
    the [B·N, C] NHWC view there. Tolerance 1e-6 relative to Σ|x| and Σx²:
    fp32 sums of the same values in another order."""
    rng = np.random.default_rng(b * n + c)
    x = _randn(rng, b, n, c, scale=2.0) + 0.3
    ws, wss = jnorms._gn_stats_pallas(jnp.asarray(x.reshape(b * n, c)), b)
    s, ss = tnorms.group_norm_stats_reference(torch.from_numpy(x).permute(0, 2, 1).reshape(b, c, 8, n // 8))
    mag = np.abs(x).sum(axis=1)
    np.testing.assert_array_less(np.abs(s.numpy() - np.asarray(ws)), 1e-6 * mag + 1e-30)
    np.testing.assert_allclose(ss.numpy(), np.asarray(wss), rtol=1e-6, atol=0)


def test_group_norm_function_matches_jax_gn_p(jax_ref, monkeypatch):
    """The port's ``group_norm`` forward and ``GroupNormFunction`` VJP (dx,
    dscale, dbias) against JAX ``group_norm`` on its Pallas statistics path
    (``FLASH_TPU_GN_PALLAS=1``: batch 1, C = 128, N = 64², interpret mode)
    and ``jax.vjp``. Tolerance 1e-5 absolute: fp32, the same closed form."""
    import jax

    monkeypatch.setenv("FLASH_TPU_GN_PALLAS", "1")
    rng = np.random.default_rng(12)
    x = _randn(rng, 1, 64, 64, 128, scale=2.0) + 0.3
    w, b = 1.0 + _randn(rng, 128, scale=0.1), _randn(rng, 128, scale=0.1)
    dy = _randn(rng, 1, 64, 64, 128)
    assert jnorms._gn_eligible(jnp.asarray(x), 32)
    for act in (None, "silu"):
        want, vjp = jax.vjp(lambda x_, w_, b_: jnorms.group_norm(x_, 32, w_, b_, act=act),
                            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        jdx, jdw, jdb = vjp(jnp.asarray(dy))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_()
        wt, bt = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
        got = tnorms.group_norm(xt, 32, wt, bt, act=act)
        assert got.grad_fn is not None
        got.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jdx), atol=1e-5, rtol=0)
        # dscale and dbias sum 4096 positions: 1e-5 relative to their size
        for got_g, want_g in ((wt.grad, jdw), (bt.grad, jdb)):
            want_g = np.asarray(want_g)
            np.testing.assert_allclose(got_g.numpy(), want_g, atol=1e-5 * np.abs(want_g).max(), rtol=0)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_function_gradcheck(act):
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 8, 3, 5, generator=g, dtype=torch.float64).requires_grad_()
    w = (1 + 0.1 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    b = (0.1 * torch.randn(8, generator=g, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x_, w_, b_: tnorms.group_norm(x_, 4, w_, b_, 1e-5, act=act),
                                    (x, w, b))


# Every SD1.5 attention call at 512² (batch folded into BH): kv, head dim,
# and the kernel the plan must give it
SD15_ATTENTION = [
    (4096, 40, "flash_fwd_stream"),  # level-0 self-attention
    (1024, 80, "flash_fwd_stream"),  # level-1 self-attention
    (256, 160, "flash_fwd_oneshot"),  # level-2 self-attention (a 64-row q tile and 256 keys: 189 KB)
    (64, 160, "flash_fwd_oneshot"),  # mid-block self-attention
    (77, 40, "flash_fwd_oneshot"),  # cross-attention over the 77 text tokens
    (77, 80, "flash_fwd_oneshot"),
    (77, 160, "flash_fwd_oneshot"),
    (4096, 512, "flash_fwd_stream"),  # VAE mid-block, single head, D = C
]


# The SDXL calls at 1024² that take flash_attention_bhsd (batch folded into BH)
SDXL_ATTENTION = [
    (4096, 64, "flash_fwd_stream"),  # level-1 self-attention
    (1024, 64, "flash_fwd_stream"),  # level-2 and mid self-attention (one-shot K and V: 288 KB)
    (16384, 512, "flash_fwd_stream"),  # VAE mid-block
    (77, 64, "flash_fwd_oneshot"),  # cross-attention under a gradient (training: never the packed K4)
]


@pytest.mark.parametrize("kv,d,kernel", SD15_ATTENTION + SDXL_ATTENTION)
def test_attention_plan_at_sd15_shapes(kv, d, kernel):
    kind, bq = tattn.attention_plan(kv, d)
    assert kind == kernel and bq % 16 == 0
    if kind == "flash_fwd_oneshot":  # the whole padded KV fits one block
        assert tattn.smem_bytes(bq, -(-kv // 16) * 16, -(-d // 16) * 16) <= tattn._SMEM_LIMIT


# The ragged forward calls of the card's checks (kv, kv_valid, head dim) and
# the route they take: the one-shot kernel wherever the whole padded K and V
# and a q tile fit a block at D <= 160
FWD_RAGGED_ROUTES = [
    (1024, 900, 80, "flash_fwd_stream"), (77, 70, 40, "flash_fwd_oneshot"), (4096, 3000, 512, "flash_fwd_stream"),
    (4096, 4001, 40, "flash_fwd_stream"), (2000, 1999, 160, "flash_fwd_stream"), (200, 150, 80, "flash_fwd_oneshot"),
    (77, None, 40, "flash_fwd_oneshot"), (77, None, 64, "flash_fwd_oneshot"), (77, 70, 64, "flash_fwd_oneshot"),
]


@pytest.mark.parametrize("kv,kv_valid,d,kernel", [(kv, None, d, k) for kv, d, k in SD15_ATTENTION] + FWD_RAGGED_ROUTES)
def test_oneshot_forward_tiles_fit_a_block(kv, kv_valid, d, kernel):
    """K1's plan: the route of every SD1.5 and ragged call, and a tile set
    (Q, K and V in bf16 at row stride D + 8) that fits 227 KB at the plan's
    q tile: 64 rows at every SD1.5 shape."""
    kind, bq = tattn.attention_plan(kv_valid or kv, d)
    assert kind == kernel
    if kind != "flash_fwd_oneshot":
        return
    kvp, dp = -(-(kv_valid or kv) // 16) * 16, -(-d // 16) * 16
    assert d <= 160 and tattn.smem_bytes(bq, kvp, dp) <= tattn._SMEM_LIMIT
    assert tattn.smem_bytes(bq, kvp, dp) == (bq + 2 * kvp) * (dp + 8) * 2
    assert bq == 64


def test_cpu_calls_take_the_plain_path_and_launch_nothing(monkeypatch):
    before = dict(tattn.LAUNCHES), dict(tnorms.LAUNCHES), dict(tgemm.LAUNCHES)
    x = torch.randn(2, 16, 2, 8)
    tattn.dot_product_attention(x, x, x)
    y = torch.randn(2, 16, 2, 64)  # packed-eligible
    tattn.dot_product_attention(y, y, y)
    monkeypatch.setenv("FLASH_TPU_ATTN_PACKED", "1")  # the packed streaming route
    tattn.dot_product_attention(torch.randn(1, 300, 2, 64), torch.randn(1, 300, 2, 64), torch.randn(1, 300, 2, 64))
    tnorms.layer_norm(torch.randn(4, 32))
    tnorms.group_norm(torch.randn(2, 16, 4, 4), 4, torch.ones(16), torch.zeros(16), act="silu")
    w = torch.randn(128, 2048).bfloat16()
    tgemm.down_proj_gemm(torch.randn(1024, 2048).bfloat16(), w, None)  # K10's route
    tgemm.geglu_down_proj(torch.randn(1024, 4096).bfloat16(), w, None)  # K12's
    assert (dict(tattn.LAUNCHES), dict(tnorms.LAUNCHES), dict(tgemm.LAUNCHES)) == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other non-CUDA device raises."""
    x = torch.empty(2, 16, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bhsd(x, x, x, 1.0)
    p = torch.empty(2, 16, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_packed(p, p, p, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_packed_stream(p, p, p, 2, 1.0)
    w = torch.empty(128, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tgemm.gemm(p[0], w, w[0])
    with pytest.raises(ValueError, match="CUDA"):
        tgemm.geglu_gemm(p[0], w[:, :64], w[0])
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.layer_norm(torch.empty(4, 8, device="meta"))
    g = torch.empty(2, 8, 4, 4, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.group_norm_stats(g)
    with pytest.raises(ValueError, match="CUDA"):
        tnorms.group_norm_apply(g, g[:, :, 0, 0], g[:, :, 0, 0])


def _k4_block(kv, d):
    """(q rows, threads, shared bytes) of K4's block: K1's kernel, one warp
    on 16 q rows of each key half (two past the 80 keys one warp holds)."""
    bq, kvp = tattn.packed_oneshot_tile(kv, d), -(-kv // 16) * 16
    halves = 1 if kvp <= 80 else 2
    return bq, bq * 2 * halves, tattn.smem_bytes(bq, kvp, d)


@pytest.mark.parametrize("d,kv", [(64, 77), (64, 256), (128, 77), (128, 256)])
def test_packed_tiles_fit_a_block(d, kv):
    """K4 is K1's kernel on the packed layout: a shape ``packed_cross_eligible``
    takes maps onto K1's plan (the one-shot route) and K4 takes its q tile,
    in at most K1's 256 threads and 227 KB with the head's padded K and V."""
    assert tattn.packed_cross_eligible(torch.empty(1, 1, 2, d), kv)
    kind, bq1 = tattn.attention_plan(kv, d)
    bq, threads, smem = _k4_block(kv, d)
    assert kind == "flash_fwd_oneshot" and bq == bq1 == 64
    assert threads <= 256 and smem <= tattn._SMEM_LIMIT


def test_packed_oneshot_tile_at_every_eligible_kv():
    """Every KV that ``packed_cross_eligible`` takes (1 to 256) at D = 64 and
    128 has a K4 block within K1's limits: 64 q rows, and past 80 keys the
    split-halves case (256 threads); KV past 256 is refused."""
    for d in (64, 128):
        for kv in range(1, 257):
            assert tattn.packed_cross_eligible(torch.empty(1, 1, 2, d), kv)
            bq, threads, smem = _k4_block(kv, d)
            assert bq == 64 and threads == (128 if kv <= 80 else 256) and smem <= tattn._SMEM_LIMIT
    assert not tattn.packed_cross_eligible(torch.empty(1, 1, 2, 64), 257)
    with pytest.raises(ValueError):
        tattn.packed_oneshot_tile(4096, 64)


@pytest.mark.parametrize("d", [64, 128])
def test_packed_stream_tiles_are_the_stream_forwards(d):
    """K5 is K2's wgmma kernel on the packed layout: its tiles at D = 64 and
    128 are ``stream_fwd_tiles``' (128 q rows in two consumer warpgroups,
    128-key tiles at D = 64 and 64 at D = 128, four stages) and fit 227 KB."""
    t = tattn.stream_fwd_tiles(d)
    assert (t.route, t.dp, t.bq, t.bkv, t.stages, t.threads) == ("wgmma", d, 128, 128 if d == 64 else 64, 4, 384)
    assert t.smem == 128 * d * 2 + 4 * 2 * t.bkv * d * 2 + 9 * 8 <= tattn._SMEM_LIMIT


FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps([time.time(), args]) + "\\n")
if "-c" in args:
    time.sleep(0.3)  # long enough that sequential compiles would not overlap
    if any(a.endswith("bad.cu") for a in args):
        print("bad.cu(1): error: expected a declaration")
        sys.exit(2)
    print("ptxas info    : Used 32 registers")
with open(args[args.index("-o") + 1], "w") as f:
    f.write("binary")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """``ops/kernels.py`` pointed at a scratch source tree and build
    directory, with a stand-in ``nvcc`` that logs its arguments."""
    from flash_diffusion_tpu_torch.ops import kernels

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    (csrc / "tiles.cuh").write_text("// shared\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_INFO", {})
    return kernels, csrc, log


def test_kernel_build_compiles_each_source_at_once_then_links(fake_toolchain):
    kernels, csrc, log = fake_toolchain
    path = kernels.build()
    assert path.exists() and path == kernels.library_path() and path.parent == kernels.BUILD_DIR
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    compiles = [(t, a) for t, a in calls if "-c" in a]
    assert sorted(a[a.index("-c") + 1] for _, a in compiles) == [str(csrc / n) for n in ("a.cu", "b.cu", "c.cu")]
    assert all("-gencode" in a and "arch=compute_90a,code=sm_90a" in a for _, a in compiles)
    # started together: every compile began before the first one ended (each takes 0.3 s)
    starts = [t for t, _ in compiles]
    assert max(starts) - min(starts) < 0.25
    (_, link), = [(t, a) for t, a in calls if "-shared" in a]
    assert sorted(x for x in link if x.endswith(".o")) == sorted(a[a.index("-o") + 1] for _, a in compiles)
    assert kernels.BUILD_INFO["log"].count("Used 32 registers") == 3
    assert list(kernels.BUILD_DIR.iterdir()) == [path]  # objects and temporaries cleaned up
    n = len(calls)
    assert kernels.build() == path and len(log.read_text().splitlines()) == n  # cached by hash


def test_kernel_library_name_follows_sources_and_headers(fake_toolchain):
    kernels, csrc, _ = fake_toolchain
    first = kernels.library_path()
    (csrc / "tiles.cuh").write_text("// shared, changed\n")
    second = kernels.library_path()
    (csrc / "b.cu").write_text("// b, changed\n")
    assert len({first, second, kernels.library_path()}) == 3


def test_kernel_build_failure_raises_with_the_compiler_output(fake_toolchain):
    kernels, csrc, _ = fake_toolchain
    (csrc / "bad.cu").write_text("oops\n")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        kernels.build()
    assert not kernels.library_path().exists()


# (bh, sq, kv, d, kv_valid, pair): the K8 route (cross-attention over 77 keys,
# the 64-token self-attention at D = 160) and, with JAX forced off its
# one-shot backward at 128-row blocks, the K6 + K7 route, kv_valid included
BWD_CASES = [
    (2, 200, 77, 40, None, False), (2, 64, 64, 160, None, False),
    (2, 300, 260, 40, None, True), (2, 300, 260, 40, 200, True),
]


@pytest.mark.parametrize("bh,sq,kv,d,kv_valid,pair", BWD_CASES)
def test_attention_bwd_reference_matches_jax_flash_bwd(jax_ref, monkeypatch, bh, sq, kv, d, kv_valid, pair):
    """The plain version of K6–K8 vs JAX ``_flash_bwd_bhsd`` (its Pallas
    kernels in interpret mode), fp32 on both sides, from the same forward's
    out and lse. Tolerance 1e-4: the same products summed in another order."""
    rng = np.random.default_rng(bh * 100 + sq + kv)
    q, k, v = (_randn(rng, bh, s, d) for s in (sq, kv, kv))
    do = _randn(rng, bh, sq, d)
    scale = 1.0 / np.sqrt(d)
    o, lse = jattn._flash_fwd_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, kv_valid=kv_valid)
    kw = {}
    if pair:
        monkeypatch.setattr(jattn, "_ONESHOT_BWD_MAX", 0)
        kw = dict(block_q=128, block_kv=128)
    want = jattn._flash_bwd_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(do),
                                 scale, kv_valid=kv_valid, **kw)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = tattn.flash_attention_bwd_bhsd(t(q), t(k), t(v), t(o), t(lse)[:, 0], t(do), scale, kv_valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kv_valid", [None, 6])
def test_attention_function_gradcheck(kv_valid):
    """``FlashAttention`` (forward and plain backward) in fp64 on the CPU."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, s, 2, 8, generator=g, dtype=torch.float64, requires_grad=True)
               for s in (7, 9, 9))
    out = tattn.dot_product_attention(q, k, v, kv_valid=kv_valid)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.autograd.gradcheck(lambda *x: tattn.dot_product_attention(*x, kv_valid=kv_valid), (q, k, v))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_function_gradcheck(affine):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=g, dtype=torch.float64, requires_grad=True)
    w, b = ((torch.randn(16, generator=g, dtype=torch.float64) + 1).requires_grad_(), 
            torch.randn(16, generator=g, dtype=torch.float64).requires_grad_()) if affine else (None, None)
    args = (x, w, b) if affine else (x,)
    assert type(tnorms.layer_norm(*args).grad_fn).__name__ == "LayerNormFunctionBackward"
    assert torch.autograd.gradcheck(lambda *a: tnorms.layer_norm(*a), args)


@pytest.mark.parametrize("kv_valid", [None, 60])
def test_attention_grads_match_jax_grad(jax_ref, kv_valid):
    """Grads of q, k, v through ``dot_product_attention`` vs ``jax.grad`` of
    the JAX one on its Pallas forward and backward, fp32, tolerance 1e-4."""
    import jax

    rng = np.random.default_rng(12)
    q, k, v = _randn(rng, 2, 45, 2, 40), _randn(rng, 2, 77, 2, 40), _randn(rng, 2, 77, 2, 40)
    w = _randn(rng, 2, 45, 2, 40)
    loss = lambda q_, k_, v_: jnp.sum(
        jattn.dot_product_attention(q_, k_, v_, use_pallas=True, kv_valid=kv_valid) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tattn.dot_product_attention(tq, tk, tv, kv_valid=kv_valid) * torch.from_numpy(w)).sum().backward()
    for g, ww in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=1e-4, rtol=0)


@pytest.mark.parametrize("c", [128, 96])
def test_layer_norm_grads_match_jax_grad(jax_ref, c):
    """dx, dweight, dbias vs ``jax.grad`` of the JAX ``layer_norm`` (its
    Pallas custom VJP at C = 128, its plain path at C = 96). Tolerance 1e-4."""
    import jax

    rng = np.random.default_rng(c + 1)
    x = _randn(rng, 3, 16, c, scale=2.0) + 0.5
    wt, b, up = 1.0 + _randn(rng, c, scale=0.1), _randn(rng, c, scale=0.1), _randn(rng, 3, 16, c)
    loss = lambda x_, w_, b_: jnp.sum(jnorms.layer_norm(x_, w_, b_, eps=1e-5) * up)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, b))
    (tnorms.layer_norm(tx, tw, tb, eps=1e-5) * torch.from_numpy(up)).sum().backward()
    for g, ww in zip((tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=1e-4, rtol=0)


# Every SD1.5 training backward (kv, head dim) and the route the plan must give it
SD15_BWD = [
    (4096, 40, "flash_bwd_pair"), (1024, 80, "flash_bwd_pair"), (256, 160, "flash_bwd_pair"),
    (64, 160, "flash_bwd_oneshot"), (77, 40, "flash_bwd_oneshot"), (77, 80, "flash_bwd_oneshot"),
    (77, 160, "flash_bwd_oneshot"), (4096, 512, "flash_bwd_pair"),
]


@pytest.mark.parametrize("kv,d,route", SD15_BWD)
def test_attention_bwd_plan_at_sd15_shapes(kv, d, route):
    """Every KV = 77 cross-attention reaches K8; each plan's layout fits a block."""
    got, tiles = tattn.attention_bwd_plan(kv, d)
    assert got == route
    if route == "flash_bwd_oneshot":
        assert tiles.kvp == -(-kv // 16) * 16 and tiles.dp == (-(-d // 16) * 16 if d <= 80 else 160)
        assert tiles.threads <= 320 and tiles.smem <= tattn._SMEM_LIMIT
    else:
        assert tiles == tattn.bwd_pair_tiles(d)
        assert all(t.smem <= tattn._SMEM_LIMIT for t in tiles)


# Every SDXL training backward at 1024² (D = 64): cross-attention over the 77
# text tokens on K8, the 4096- and 1024-token self-attention on the pair,
# the VAE decoder's mid-attention under the LPIPS loss
SDXL_BWD = [
    (77, 64, "flash_bwd_oneshot"), (4096, 64, "flash_bwd_pair"), (1024, 64, "flash_bwd_pair"),
    (4096, 512, "flash_bwd_pair"),
]


@pytest.mark.parametrize("kv,d,route", SDXL_BWD)
def test_attention_bwd_plan_at_sdxl_shapes(kv, d, route):
    """SDXL's D = 64: the 77-key cross-attention reaches K8 (80 padded keys,
    five warps of one 16-row band each, 32-row q tiles) and the 1024- and
    4096-key self-attention the pair at D = 64's wgmma tiles; each fits a
    block."""
    got, tiles = tattn.attention_bwd_plan(kv, d)
    assert got == route
    if route == "flash_bwd_oneshot":
        assert (tiles.kvp, tiles.dp, tiles.bs, tiles.threads) == (80, 64, 32, 160)
        assert tiles.smem == tattn.bwd_smem_bytes(80, 64) <= tattn._SMEM_LIMIT
    else:
        assert tiles == tattn.bwd_pair_tiles(d) and all(t.smem <= tattn._SMEM_LIMIT for t in tiles)
        assert all(t.wgmma == (d <= 128) for t in tiles)


# Pixart-α's training step at 512² (16 heads of D = 72 over 1024 tokens):
# the self-attention forward and backward; a ragged D = 72 case off the tiles
PIXART_ATTENTION = [(1024, None, 72), (1100, 1037, 72), (999, None, 72)]


@pytest.mark.parametrize("kv,kv_valid,d", PIXART_ATTENTION)
def test_attention_plans_at_pixart_d72(kv, kv_valid, d):
    """D = 72: the forward on K2's wgmma kernel and the backward on the pair,
    each with D zero-padded to 80 (the kernels drop columns 72..79 on
    store); the pair's tiles are D = 80's, wgmma, and fit a block."""
    kv_len = kv_valid or kv
    assert tattn.attention_plan(kv_len, d)[0] == "flash_fwd_stream"
    assert tattn.stream_fwd_tiles(d).route == "wgmma" and tattn.stream_fwd_tiles(d).dp == 80
    route, tiles = tattn.attention_bwd_plan(kv_len, d)
    assert route == "flash_bwd_pair" and tiles == tattn.bwd_pair_tiles(80)
    assert all(t.dp == 80 and t.wgmma and t.smem <= tattn._SMEM_LIMIT for t in tiles)


# The ragged backward calls of the card's checks (kv, kv_valid, head dim) and
# their route: K8 wherever the whole padded KV fits its warps
BWD_RAGGED_ROUTES = [
    (77, None, 40, "flash_bwd_oneshot"), (200, 150, 80, "flash_bwd_pair"), (4096, 3001, 40, "flash_bwd_pair"),
    (77, 70, 40, "flash_bwd_oneshot"), (4096, 3000, 512, "flash_bwd_pair"), (2000, 1999, 160, "flash_bwd_pair"),
    (77, 70, 64, "flash_bwd_oneshot"), (1100, 1037, 64, "flash_bwd_pair"), (4096, 4001, 64, "flash_bwd_pair"),
]


@pytest.mark.parametrize("kv,kv_valid,d,route", [(kv, None, d, r) for kv, d, r in SD15_BWD + SDXL_BWD]
                         + BWD_RAGGED_ROUTES)
def test_oneshot_backward_tiles_fit_and_split_without_bh(kv, kv_valid, d, route):
    """K8's plan: the route of every SD1.5 training backward and ragged call,
    a block of at most 10 warps (one on each 16-row kv band, two above
    D = 80) whose K, V, two q stages (32 rows, 16 at D = 160) and dSᵀ fit
    227 KB; and an Sq split that covers every q tile once, uses at most
    sms / 8 splits of at least 128 rows, and takes no BH."""
    got, tiles = tattn.attention_bwd_plan(kv_valid or kv, d)
    assert got == route
    if route != "flash_bwd_oneshot":
        return
    assert tiles.threads == tiles.kvp // 16 * (1 if tiles.dp <= 80 else 2) * 32 <= 320
    assert tiles.smem == tattn.bwd_smem_bytes(tiles.kvp, tiles.dp) <= tattn._SMEM_LIMIT
    assert tiles.bs == (16 if tiles.dp == 160 else 32)
    for sq in (1, 64, 256, 1024, 4000, 4096):
        nsplit, per = tattn.bwd_splits(sq, tiles.bs, 132)
        q_tiles = -(-sq // tiles.bs)
        assert (nsplit - 1) * per < q_tiles <= nsplit * per and nsplit <= 16 and (nsplit == 1 or per * tiles.bs >= 128)


def test_attention_bwd_plan_takes_every_head_dim_of_the_pair():
    """K6 and K7 take every D % 8 == 0 up to 512 at a tile set that fits a
    block: D padded (up to 160 to a multiple of 16, or 160; above, of 64),
    16-row bands split into whole 16-column blocks, streamed tiles of 16-row
    k-steps, wgmma (two warpgroups of 64 rows) up to D = 128; D above 512
    or off the 8-step raises."""
    for d in range(8, 513, 8):
        route, tiles = tattn.attention_bwd_plan(4096, d)
        assert route == "flash_bwd_pair"
        for t in tiles:
            assert d <= t.dp < d + 64 and t.dp % 16 == 0 and t.dp % t.dc == 0
            assert (t.dc // t.wb) % 16 == 0 and t.stream % 16 == 0 and t.rows * t.wb == (128 if t.wgmma else 64)
            assert t.smem <= tattn._SMEM_LIMIT
    for d in (520, 44):
        with pytest.raises(ValueError):
            tattn.attention_bwd_plan(4096, d)


# The streaming forward's calls on the card's paths and in its checks
# (BH, Sq, KV, head dim): SD1.5, SDXL, Pixart, the VAE, and the ragged ones
STREAM_CALLS = [
    (32, 4096, 4096, 40), (32, 1024, 1024, 80), (40, 4096, 4096, 64), (80, 1024, 1024, 64), (64, 4096, 4096, 72),
    (4, 4096, 4096, 512), (4, 16384, 16384, 512), (32, 1000, 900, 80), (4, 700, 3000, 512), (32, 4000, 4001, 40),
    (32, 300, 1999, 160), (40, 1000, 1037, 64), (16, 700, 1433, 72), (40, 1000, 1030, 64), (16, 999, 999, 72),
]


@pytest.mark.parametrize("bh,sq,kv,d", STREAM_CALLS)
def test_stream_forward_tiles_fit_and_follow_the_head_dim(bh, sq, kv, d):
    """K2's plan at every streaming call of the paths and checks: the call
    takes the streaming route, its tiles fit a block, D ≤ 128 goes to the
    wgmma kernel (128 q rows, four stages) and D above it keeps the mma.sync
    kernel (64 q rows, its old tiles); the tiles come from D alone, never
    from Sq, KV or BH."""
    assert tattn.attention_plan(kv, d)[0] == "flash_fwd_stream"
    t = tattn.stream_fwd_tiles(d)
    assert t.smem <= tattn._SMEM_LIMIT and d <= t.dp < d + 64 and t.dp % 16 == 0
    if d <= 128:
        assert (t.route, t.bq, t.stages, t.threads) == ("wgmma", 128, 4, 384) and t.bkv in (64, 128)
        assert t.smem == 128 * t.dp * 2 + 4 * 2 * t.bkv * t.dp * 2 + 9 * 8
    else:
        assert (t.route, t.bq) == ("mma", 64) and t.smem == (64 + 4 * t.bkv) * (t.dp + 8) * 2
    assert tattn.attention_plan(kv, d)[1] == t.bq


def test_stream_forward_tiles_at_every_head_dim():
    """Every D % 8 == 0 up to 512 has streaming tiles that fit a block, on
    the wgmma kernel exactly up to D = 128; D above 512 or off the 8-step
    raises."""
    for d in range(8, 513, 8):
        t = tattn.stream_fwd_tiles(d)
        assert t.route == ("wgmma" if d <= 128 else "mma") and t.smem <= tattn._SMEM_LIMIT
    for d in (520, 44):
        with pytest.raises(ValueError):
            tattn.stream_fwd_tiles(d)


def _plain_fwd_variant(q, k, v, scale, kv_valid, fault):
    """The plain forward at the one-shot kernel's rounding points (p rounded
    to q's dtype before p·v, the fp32 row sum, out rounded once), or a copy
    with one ``fault``: the key mask dropped, the KV's zero padding to a
    multiple of 16 leaked into the softmax (score 0, v 0), or out × 1.01."""
    kv_len = kv_valid or k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    if fault == "padding leaked":
        pad = -(-kv_len // 16) * 16 - k.shape[1]
        kf, vf = (torch.cat([t, t.new_zeros(t.shape[0], max(pad, 0), t.shape[2])], 1) for t in (kf, vf))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if fault != "mask dropped":
        s[..., kv_len:k.shape[1]] = -1e30
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), vf) / l
    if fault == "out x 1.01":
        out = out * 1.01
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _plain_packed_variant(q, k, v, num_heads, scale, fault):
    """``_plain_fwd_variant`` on the packed [B, S, H·D] layout: each head's
    [B·H, S, D] slice, without an lse (the packed kernels return none)."""
    b, d = q.shape[0], q.shape[2] // num_heads
    heads = lambda x: x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2).reshape(b * num_heads, x.shape[1], d)
    out, _ = _plain_fwd_variant(heads(q), heads(k), heads(v), scale, None, fault)
    return out.reshape(b, num_heads, q.shape[1], d).transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize("fault", [None, "mask dropped", "padding leaked", "out x 1.01"])
def test_attention_fwd_gate_passes_the_plain_forward_and_catches_faults(fault):
    """The gate of the forward kernels, on the CPU, on the kinds of case that
    the card's checks add: ragged (keys at or past ``kv_valid`` are k × 3
    and v + 1), 77 keys with v + 1 everywhere, and a packed [B, S, H·D]
    case with v + 1 and no lse (K4, K5). The plain forward in bf16 (the
    kernels' rounding points) against the plain version in fp32 passes
    every case; out × 1.01 fails every case (the relative-L2 term), and each
    other fault fails at least one."""
    g = torch.Generator().manual_seed(14)
    bh, sq, kv, d = 2, 100, 77, 40
    verdicts = []
    for kv_valid in (50, None):
        q, k, v = (torch.randn(bh, s, d, generator=g).to(torch.bfloat16) for s in (sq, kv, kv))
        if kv_valid is None:
            v += 1
        else:
            k[:, kv_valid:] *= 3
            v[:, kv_valid:] += 1
        scale = d ** -0.5
        want = tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), scale, kv_valid)
        out, lse = _plain_fwd_variant(q, k, v, scale, kv_valid, fault)
        verdicts.append(tattn.attention_fwd_gate(tattn.attention_fwd_errors(out, lse, *want)))
    h, d = 2, 64
    q, k, v = (torch.randn(2, s, h * d, generator=g).to(torch.bfloat16) for s in (sq, kv, kv))
    v += 1
    want = tattn.attention_packed_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
    out = _plain_packed_variant(q, k, v, h, d ** -0.5, fault)
    verdicts.append(tattn.attention_fwd_gate(tattn.attention_fwd_errors(out, None, want, None)))
    print(fault, verdicts)
    if fault is None:
        assert all(ok for ok, _ in verdicts), verdicts
    elif fault == "out x 1.01":
        assert not any(ok for ok, _ in verdicts), verdicts
    else:
        assert not all(ok for ok, _ in verdicts), verdicts


# (bh, sq, kv, d, kv_valid, v + 1): the card's kinds of forward case, at a
# few rows: unit-normal at 77 to 16384 keys and D 40 to 512, ragged, and v
# + 1 at 77, 200 (D = 128, packed) and 1030 keys
FWD_L2_CASES = [
    (2, 100, 77, 40, 50, False), (2, 100, 77, 64, None, True), (2, 64, 200, 128, None, True),
    (2, 100, 1030, 64, None, True), (1, 64, 16384, 64, None, False), (1, 64, 4096, 512, None, False),
]


@pytest.mark.parametrize("bh,sq,kv,d,kv_valid,shift", FWD_L2_CASES)
def test_plain_bf16_forward_sits_inside_the_gate(bh, sq, kv, d, kv_valid, shift):
    """Where ``FWD_REL_L2_TOL`` comes from: the plain forward in bf16 at the
    kernels' rounding points against fp32 (its rel. L2 is printed: run with
    ``-rP``) stays within the gate with a margin of 1.5×, and out × 1.01
    fails it."""
    g = torch.Generator().manual_seed(bh * sq + kv + d)
    q, k, v = (torch.randn(bh, s, d, generator=g).to(torch.bfloat16) for s in (sq, kv, kv))
    if shift:
        v += 1
    if kv_valid is not None:
        k[:, kv_valid:] *= 3
        v[:, kv_valid:] += 1
    want = tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), d ** -0.5, kv_valid)
    stats = tattn.attention_fwd_errors(*_plain_fwd_variant(q, k, v, d ** -0.5, kv_valid, None), *want)
    print(f"plain bf16 forward rel L2 {stats['rel_l2']:.3e} at {(bh, sq, kv, d, kv_valid, shift)}")
    assert tattn.attention_fwd_gate(stats)[0] and stats["rel_l2"] * 1.5 <= tattn.FWD_REL_L2_TOL
    faulty = tattn.attention_fwd_errors(*_plain_fwd_variant(q, k, v, d ** -0.5, kv_valid, "out x 1.01"), *want)
    assert not tattn.attention_fwd_gate(faulty)[0]


def _plain_bwd_variant(q, k, v, o, lse, do, scale, kv_valid, fault):
    """``attention_bwd_reference`` in q's dtype, or a copy of it with one
    ``fault``: the key mask dropped, Δ dropped, or dv × 1.03."""
    if fault is None:
        return tattn.attention_bwd_reference(q, k, v, o, lse, do, scale, kv_valid)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if fault != "mask dropped":
        s[..., kv_valid:] = -1e30
    p = torch.exp(s - lse[..., None])
    delta = (dof * o.float()).sum(-1) if fault != "delta dropped" else torch.zeros_like(lse)
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), dof) * (1.03 if fault == "dv x 1.03" else 1.0)
    ds = (p * (torch.einsum("bqd,bkd->bqk", dof, vf) - delta[..., None])).to(q.dtype).float()
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("fault", [None, "mask dropped", "delta dropped", "dv x 1.03"])
def test_attention_bwd_gate_passes_the_plain_backward_and_catches_faults(fault):
    """The gate of the backward kernels, on the CPU: the plain backward in
    bf16 (the kernels' rounding points) against itself in fp32 passes; a
    copy with the key mask dropped, with Δ dropped, or with dv × 1.03 fails.
    Ragged: keys at or past ``kv_valid`` are k × 3 and v + 1."""
    g = torch.Generator().manual_seed(11)
    bh, sq, kv, d, kv_valid = 2, 100, 80, 40, 50
    q, k, v, do = (torch.randn(bh, s, d, generator=g).to(torch.bfloat16) for s in (sq, kv, kv, sq))
    k[:, kv_valid:] *= 3
    v[:, kv_valid:] += 1
    scale = d ** -0.5
    o, lse = tattn.attention_bhsd_reference(q, k, v, scale, kv_valid)
    want = tattn.attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale,
                                         kv_valid)
    got = _plain_bwd_variant(q, k, v, o, lse, do, scale, kv_valid, fault)
    ok, report = tattn.attention_bwd_gate(tattn.attention_bwd_errors(got, want, kv_valid))
    assert ok == (fault is None), report


def test_bwd_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty(2, 16, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention_bwd_bhsd(x, x, x, x, torch.empty(2, 16, device="meta"), x, 1.0)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", [
    (8, 4096, 77, 40, None), (8, 1000, 1024, 80, None), (8, 64, 64, 160, None),
    (2, 300, 256, 160, 200), (2, 512, 512, 512, 500), (3, 37, 1100, 16, 1030),
    (2, 130, 2000, 160, 1999), (4, 200, 4096, 40, None), (2, 77, 700, 8, None),
    (2, 100, 1500, 200, 1400), (1, 64, 4096, 512, None),
    (3, 1000, 1100, 64, 1037), (2, 700, 1500, 72, 1433), (2, 130, 333, 128, 301),
])
def test_attention_kernels_match_plain_on_card(cuda, bh, sq, skv, d, kv_valid):
    """bf16 kernel vs the plain version on the same inputs in fp32, held to
    ``attention_fwd_gate`` (K1 and K2 alike); keys at or past ``kv_valid``
    are k × 3 and v + 1, so that a masked key that leaks moves the mean."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, skv, skv))
    if kv_valid is not None:
        k[:, kv_valid:] *= 3
        v[:, kv_valid:] += 1
    kind, _ = tattn.attention_plan(kv_valid or skv, d)
    n = tattn.LAUNCHES[kind]
    out, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES[kind] == n + 1
    ref_out, ref_lse = tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), d ** -0.5, kv_valid)
    ok, report = tattn.attention_fwd_gate(tattn.attention_fwd_errors(out, lse, ref_out, ref_lse))
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype", [
    (4 * 4096, 320, torch.bfloat16), (4 * 1024 + 3, 640, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16), (4 * 77, 768, torch.float32), (37, 100, torch.bfloat16),
])
def test_layer_norm_kernel_matches_plain_on_card(cuda, rows, c, dtype):
    """The kernel against the plain version in fp32 on the same inputs, held
    to ``layer_norm_gate`` (bf16: one rounding of the output, relative; fp32:
    the summation order)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(rows, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    got = tnorms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    want = tnorms.layer_norm_reference(x.float(), w.float(), b.float())
    ok, report = tnorms.layer_norm_gate(tnorms.layer_norm_errors(got, want))
    assert ok, report


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
@pytest.mark.parametrize("b,sq,kv,h,d,v_offset", [
    (4, 4096, 77, 10, 64, 0.0), (4, 1024, 77, 20, 64, 0.0), (1, 4000, 77, 10, 64, 1.0),
    (2, 1000, 200, 20, 64, 1.0), (1, 33, 256, 8, 128, 1.0), (2, 1024, 77, 8, 128, 1.0),
    (8, 100, 77, 20, 64, 0.0), (3, 130, 16, 4, 64, 1.0), (2, 70, 250, 2, 128, 1.0),
])
def test_packed_kernel_matches_plain_on_card(cuda, b, sq, kv, h, d, v_offset):
    """K4 (bf16) vs the plain version on the same inputs in fp32, batch 1
    and ragged Sq/KV included, held to ``attention_fwd_gate`` without the
    lse term; the v + 1 cases would show a zero-filled padding key past KV
    that leaked into the softmax as a mean error."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, kv, kv))
    v += v_offset
    n = tattn.LAUNCHES["flash_fwd_oneshot_packed"]
    out = tattn.flash_attention_packed(q, k, v, h, d ** -0.5)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd_oneshot_packed"] == n + 1
    want = tattn.attention_packed_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
    ok, report = tattn.attention_fwd_gate(tattn.attention_fwd_errors(out, None, want, None))
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_dot_product_attention_packed_on_card_matches_cpu(cuda, b):
    """The [B, S, H, D] ⇄ [B, S, H·D] reshape around the packed kernel from
    the projections' layout, batch 1 included, against the plain path on
    the CPU in fp32, held to ``attention_fwd_gate`` without the lse term."""
    g = torch.Generator().manual_seed(4)
    lin = torch.nn.Linear(640, 640, bias=False)
    x, ctx = torch.randn(b, 300, 640, generator=g), torch.randn(b, 77, 640, generator=g)
    q = lin(x).detach().reshape(b, 300, 10, 64).to(torch.bfloat16)
    k, v = (lin(ctx).detach().reshape(b, 77, 10, 64).to(torch.bfloat16) for _ in range(2))
    want = tattn.dot_product_attention(q.float(), k.float(), v.float())
    n = tattn.LAUNCHES["flash_fwd_oneshot_packed"]
    got = tattn.dot_product_attention(q.to(cuda), k.to(cuda), v.to(cuda)).float().cpu()
    assert tattn.LAUNCHES["flash_fwd_oneshot_packed"] == n + 1
    ok, report = tattn.attention_fwd_gate(tattn.attention_fwd_errors(got, None, want, None))
    assert ok, report


@pytest.mark.cuda
def test_packed_oneshot_batch_invariant_and_routed_on_card(cuda):
    """A [B, S, H, D] cross-attention over 77 keys launches K4, and slot 1
    of a batch of 4 gets the bits it gets alone: K4's q tile follows D and
    KV alone, never the batch."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(4, 1024, 20, 64, generator=g, device=cuda).bfloat16()
    kv = torch.randn(4, 77, 20, 64, generator=g, device=cuda).bfloat16()
    before = tattn.LAUNCHES["flash_fwd_oneshot_packed"]
    out = tattn.dot_product_attention(q, kv, kv)
    assert tattn.LAUNCHES["flash_fwd_oneshot_packed"] == before + 1
    assert torch.equal(out[1], tattn.dot_product_attention(q[1:2], kv[1:2], kv[1:2])[0])


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(2, 16, 8, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention_bhsd(x, x, x, 1.0)  # fp32
    p = torch.randn(2, 16, 3 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.flash_attention_packed(p, p, p, 4, 1.0)  # head dim 48
    with pytest.raises(ValueError):
        tattn.flash_attention_packed(p, p[:, :, :128], p[:, :, :128], 3, 1.0)  # K/V width
    with pytest.raises(ValueError):
        tattn.flash_attention_packed(p.float(), p.float(), p.float(), 3, 1.0)  # fp32
    with pytest.raises(ValueError):
        tnorms.layer_norm(torch.randn(8, 16, device=cuda).t())  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", [
    (4, 512, 512, 40, None), (4, 300, 77, 40, None), (2, 200, 77, 80, 70), (1, 130, 77, 160, None),
    (2, 64, 64, 160, None), (2, 256, 256, 160, None), (1, 1000, 1024, 80, 900), (2, 128, 128, 512, 100),
    (1, 4000, 77, 40, None), (3, 300, 260, 40, 200),
])
def test_attention_bwd_kernels_match_plain_on_card(cuda, bh, sq, skv, d, kv_valid):
    """K6+K7 or K8 (bf16) vs the plain backward in fp32 on the same inputs,
    batch 1 and ragged Sq/KV included, held to ``attention_bwd_gate``; keys
    at or past ``kv_valid`` are k × 3 and v + 1, and the dk, dv rows there
    must be exactly 0."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv))
    do = torch.randn(bh, sq, d, generator=g, device=cuda).to(torch.bfloat16)
    if kv_valid is not None:
        k[:, kv_valid:] *= 3
        v[:, kv_valid:] += 1
    o, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    route = tattn.attention_bwd_plan(kv_valid or skv, d)[0]
    keys = ("flash_bwd_oneshot",) if route == "flash_bwd_oneshot" else ("flash_bwd_dkv", "flash_bwd_dq")
    n = [tattn.LAUNCHES[kk] for kk in keys]
    got = tattn.flash_attention_bwd_bhsd(q, k, v, o, lse, do, d ** -0.5, kv_valid)
    torch.cuda.synchronize()
    assert [tattn.LAUNCHES[kk] for kk in keys] == [m + 1 for m in n]
    want = tattn.attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                         d ** -0.5, kv_valid)
    ok, report = tattn.attention_bwd_gate(tattn.attention_bwd_errors(got, want, kv_valid))
    assert ok, report


# (bh, sq, kv, d, kv_valid) of the SDXL training step at batch 2, 1024²
# (D = 64: 10 heads at 4096 tokens, 20 at 1024; BH at B = 2 and, in the
# GAN's teacher pass, 2B) and the VAE decoder's mid-attention under the LPIPS
# loss (64² latent crops), plus kv_valid cases at D = 64
SDXL_TRAIN_ATTENTION = [
    (20, 4096, 77, 64, None), (40, 1024, 77, 64, None), (40, 4096, 77, 64, None), (80, 1024, 77, 64, None),
    (20, 4096, 4096, 64, None), (40, 1024, 1024, 64, None), (40, 4096, 4096, 64, None), (80, 1024, 1024, 64, None),
    (2, 4096, 4096, 512, None), (20, 4000, 77, 64, 70), (40, 1000, 1100, 64, 1037),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", SDXL_TRAIN_ATTENTION)
def test_sdxl_training_attention_on_card(cuda, bh, sq, skv, d, kv_valid):
    """The forward (K1 or K2) and backward (K8, or K6 then K7) kernels at the
    SDXL training step's shapes, held to ``attention_fwd_gate`` and
    ``attention_bwd_gate`` against the plain versions in fp32 (one head
    group at a time for the backward), each launch counted under its shape
    in ``LAUNCHES``; keys at or past ``kv_valid`` are k × 3 and v + 1."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv, sq))
    if kv_valid is not None:
        k[:, kv_valid:] *= 3
        v[:, kv_valid:] += 1
    scale = d ** -0.5
    keys = [(tattn.attention_plan(kv_valid or skv, d)[0], (bh, sq, skv, d, kv_valid))]
    route = tattn.attention_bwd_plan(kv_valid or skv, d)[0]
    keys += [(r, keys[0][1]) for r in ((route,) if route == "flash_bwd_oneshot" else ("flash_bwd_dkv", "flash_bwd_dq"))]
    before = [tattn.LAUNCHES[key] for key in keys]
    out, lse = tattn.flash_attention_bhsd(q, k, v, scale, kv_valid)
    grads = tattn.flash_attention_bwd_bhsd(q, k, v, out, lse, do, scale, kv_valid)
    torch.cuda.synchronize()
    assert [tattn.LAUNCHES[key] for key in keys] == [n + 1 for n in before]
    ok, report = tattn.attention_fwd_gate(tattn.attention_fwd_errors(
        out, lse, *tattn.attention_bhsd_reference(q.float(), k.float(), v.float(), scale, kv_valid)))
    assert ok, report
    stats, step = None, max(1, 2 ** 26 // (sq * skv))
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        ref = tattn.attention_bwd_reference(*(t[sl].float() for t in (q, k, v, out)), lse[sl], do[sl].float(),
                                            scale, kv_valid)
        part = tattn.attention_bwd_errors([t[sl] for t in grads], ref, kv_valid)
        stats = part if stats is None else tattn.merge_bwd_errors(stats, part)
    ok, report = tattn.attention_bwd_gate(stats)
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,d,kv_valid", [(64, 1024, 1024, 72, None), (128, 1024, 1024, 72, None),
                                                  (16, 1000, 1100, 72, 1037), (16, 999, 999, 72, None)])
def test_pixart_training_attention_on_card(cuda, bh, sq, skv, d, kv_valid):
    """The Pixart training step's self-attention (16 heads of D = 72 over
    1024 tokens at B = 4 and 2B) and ragged D = 72 cases: the forward and
    the K6 + K7 pair, each held to its gate as in the SDXL test above; dk
    and dv exactly 0 past ``kv_valid``."""
    test_sdxl_training_attention_on_card(cuda, bh, sq, skv, d, kv_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d,kv_valid", [(1000, 1024, 80, None), (300, 2000, 160, 1999), (300, 700, 512, 600)])
def test_attention_bwd_pair_bit_equal_run_to_run_and_batched_on_card(cuda, sq, skv, d, kv_valid):
    """K6 and K7 use no atomics and no split that follows BH: their outputs
    are ``torch.equal`` from run to run, and a head alone equals the same
    head in slot 1 of a batch of 4."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (torch.randn(4, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv, sq))
    assert tattn.attention_bwd_plan(kv_valid or skv, d)[0] == "flash_bwd_pair"
    o, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    run = lambda *t: tattn.flash_attention_bwd_bhsd(*t, d ** -0.5, kv_valid)
    first, again = run(q, k, v, o, lse, do), run(q, k, v, o, lse, do)
    alone = run(*(t[1:2].contiguous() for t in (q, k, v, o, lse, do)))
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, alone):
        assert torch.equal(a, b) and torch.equal(a[1:2], c)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d,kv_valid", [(1000, 1100, 64, 1037), (700, 1500, 72, None), (300, 2000, 40, 1999),
                                              (130, 1024, 128, None)])
def test_attention_stream_bit_equal_run_to_run_and_batched_on_card(cuda, sq, skv, d, kv_valid):
    """K2 splits no head's keys across blocks and uses no atomics: out and
    lse are ``torch.equal`` from run to run, and a head alone equals the
    same head in slot 1 of a batch of 4."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn(4, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv))
    assert tattn.attention_plan(kv_valid or skv, d)[0] == "flash_fwd_stream"
    run = lambda *t: tattn.flash_attention_bhsd(*t, d ** -0.5, kv_valid)
    first, again = run(q, k, v), run(q, k, v)
    alone = run(*(t[1:2].contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, alone):
        assert torch.equal(a, b) and torch.equal(a[1:2], c)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d,kv_valid", [(64, 77, 160, None), (4000, 77, 40, 70), (1000, 200, 80, 120)])
def test_attention_bwd_oneshot_bit_equal_run_to_run_and_batched_on_card(cuda, sq, skv, d, kv_valid):
    """K8 splits Sq by Sq and the card alone (``bwd_splits``), never by BH,
    and sums its partials in a fixed order: dq, dk and dv are ``torch.equal``
    from run to run, and a head alone equals the same head in slot 1 of a
    batch of 4 (its 8-warp block at 128 padded keys, D = 80, included)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, do = (torch.randn(4, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv, sq))
    assert tattn.attention_bwd_plan(kv_valid or skv, d)[0] == "flash_bwd_oneshot"
    o, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    run = lambda *t: tattn.flash_attention_bwd_bhsd(*t, d ** -0.5, kv_valid)
    first, again = run(q, k, v, o, lse, do), run(q, k, v, o, lse, do)
    alone = run(*(t[1:2].contiguous() for t in (q, k, v, o, lse, do)))
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, alone):
        assert torch.equal(a, b) and torch.equal(a[1:2], c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,kv", [(1, 3, 300, 77), (2, 2, 64, 64), (2, 1, 128, 128)])
def test_grads_on_card_carry_grad_fn_and_match_cpu(cuda, b, h, sq, kv):
    """The autograd fault of the serving-only port: on the card,
    ``dot_product_attention`` and ``layer_norm`` outputs carry a
    ``grad_fn`` and their gradients match the CPU path's (bf16 tolerance:
    2e-2 times max(1, max|grad|))."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(b, s, h, 40, generator=gen) for s in (sq, kv, kv))
    up = torch.randn(b, sq, h, 40, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.dot_product_attention(*leaves).backward(up)
    dev = [t.to(cuda, torch.bfloat16).requires_grad_() for t in (q, k, v)]
    out = tattn.dot_product_attention(*dev)
    assert out.grad_fn is not None
    out.backward(up.to(cuda, torch.bfloat16))
    for a, d in zip(leaves, dev):
        assert (a.grad - d.grad.float().cpu()).abs().max().item() <= 2e-2 * max(1.0, a.grad.abs().max().item())
    x, w = torch.randn(b * sq, 320, generator=gen), 1 + 0.1 * torch.randn(320, generator=gen)
    dy = torch.randn(b * sq, 320, generator=gen)
    xc = x.clone().requires_grad_()
    tnorms.layer_norm(xc, w, torch.zeros(320)).backward(dy)
    xd = x.to(cuda, torch.bfloat16).requires_grad_()
    y = tnorms.layer_norm(xd, w.to(cuda, torch.bfloat16), torch.zeros(320, device=cuda, dtype=torch.bfloat16))
    assert y.grad_fn is not None
    y.backward(dy.to(cuda, torch.bfloat16))
    assert (xc.grad - xd.grad.float().cpu()).abs().max().item() <= 2e-2 * max(1.0, xc.grad.abs().max().item())


# every GroupNorm shape of the card's paths (batch 1 here: the kernel's work
# per sample does not depend on the batch) and ragged ones: SD1.5 and SDXL
# UNet levels, the VAE decoder at 1024² (its largest), N off the 16-byte
# step, N of one element per row, fp32 (the discriminator); in both layouts
# the kernels take: contiguous NCHW and channels-last (the port's
# convolutions run channels-last), where C·2 bytes off the 16-byte step
# (C = 36) takes the scalar loads
GN_CARD_CASES = [
    ((1, 320, 64, 64), torch.bfloat16, False), ((1, 1280, 8, 8), torch.bfloat16, False),
    ((1, 640, 64, 64), torch.bfloat16, False), ((1, 128, 1024, 1024), torch.bfloat16, False),
    ((3, 96, 37, 29), torch.bfloat16, False), ((2, 64, 4099, 1), torch.bfloat16, False),
    ((2, 32, 1, 1), torch.bfloat16, False), ((2, 512, 8, 8), torch.float32, False),
    ((2, 96, 37, 29), torch.float32, False),
    ((1, 320, 64, 64), torch.bfloat16, True), ((1, 1280, 8, 8), torch.bfloat16, True),
    ((1, 128, 1024, 1024), torch.bfloat16, True), ((3, 96, 37, 29), torch.bfloat16, True),
    ((2, 36, 5, 7), torch.bfloat16, True), ((2, 512, 8, 8), torch.float32, True),
    ((2, 36, 37, 29), torch.float32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,channels_last", GN_CARD_CASES)
def test_group_norm_kernels_match_plain_on_card(cuda, shape, dtype, channels_last):
    """The statistics kernel against the plain version in fp64 (Σx to 1e-5
    of Σ|x|, Σx² to 1e-5 relative: fp32 sums in another order), and the
    apply kernel bit-equal to the plain version on the same inputs (the same
    roundings: x·w, then + shift, in x's dtype, then SiLU in fp32), its
    output in x's layout."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    n = tnorms.LAUNCHES.totals()
    s, ss = tnorms.group_norm_stats(x)
    torch.cuda.synchronize()
    x64 = x.double().reshape(shape[0], shape[1], -1)
    assert (s.double() - x64.sum(-1)).abs().le(1e-5 * x64.abs().sum(-1)).all()
    assert (ss.double() - (x64 * x64).sum(-1)).abs().le(1e-5 * (x64 * x64).sum(-1)).all()
    w = (1 + 0.1 * torch.randn(shape[:2], generator=g, device=cuda)).to(dtype)
    shift = (0.1 * torch.randn(shape[:2], generator=g, device=cuda)).to(dtype)
    for act in (None, "silu"):
        got = tnorms.group_norm_apply(x, w, shift, act)
        torch.cuda.synchronize()
        assert torch.equal(got, tnorms.group_norm_apply_reference(x, w, shift, act))
        assert got.stride() == x.stride()
    assert tnorms.LAUNCHES["group_norm_stats"] == n["group_norm_stats"] + 1
    assert tnorms.LAUNCHES["group_norm_apply"] == n["group_norm_apply"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 320, 64, 64), (4, 1280, 8, 8), (4, 128, 256, 256), (4, 96, 37, 29)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm_stats_batch_invariant_on_card(cuda, shape, channels_last):
    """K9 gives a sample the same bits alone, in a batch of 4 at any slot,
    and from run to run (a fixed split of N, fixed reduction orders, no
    atomics); so does the whole ``group_norm``. A slice of a channels-last
    batch is channels-last, as the sample alone is on the path."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    s, ss = tnorms.group_norm_stats(x)
    again = tnorms.group_norm_stats(x)
    assert torch.equal(s, again[0]) and torch.equal(ss, again[1])
    wt, bt = torch.ones(shape[1], device=cuda, dtype=torch.bfloat16), torch.zeros(shape[1], device=cuda,
                                                                               dtype=torch.bfloat16)
    y = tnorms.group_norm(x, 32, wt, bt, act="silu")
    for i in range(shape[0]):
        si, ssi = tnorms.group_norm_stats(x[i:i + 1])
        assert torch.equal(si[0], s[i]) and torch.equal(ssi[0], ss[i])
        assert torch.equal(tnorms.group_norm(x[i:i + 1], 32, wt, bt, act="silu")[0], y[i])


@pytest.mark.cuda
def test_group_norm_grads_on_card_match_cpu(cuda):
    """Under a gradient ``group_norm`` on the card goes through
    ``GroupNormFunction`` (K9 forward): its output carries a ``grad_fn`` and
    dx, dscale, dbias match the fp32 CPU path (fp32 on both: 1e-4 of the
    largest gradient)."""
    gen = torch.Generator().manual_seed(9)
    x, dy = torch.randn(2, 64, 16, 16, generator=gen), torch.randn(2, 64, 16, 16, generator=gen)
    w, b = 1 + 0.1 * torch.randn(64, generator=gen), 0.1 * torch.randn(64, generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_() for t in (x, w, b)]
        out = tnorms.group_norm(leaves[0], 8, leaves[1], leaves[2], act="silu")
        assert out.grad_fn is not None
        out.backward(dy.to(dev))
        grads.append([t.grad.cpu() for t in leaves])
    for a, d in zip(*grads):
        assert (a - d).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_attention_d72_on_card_matches_cpu(cuda, b):
    """Pixart's self-attention: 16 heads of D = 72 (zero-padded to 80 in
    the streaming kernel) over 4096 tokens, through the [B, S, 16, 72] ⇄
    [BH, S, 72] relayout, batch 1 included, against the plain version in
    fp32 (bf16 tolerance, |out| < 4: 2e-2)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(b, 4096, 16, 72, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    assert tattn.attention_plan(4096, 72)[0] == "flash_fwd_stream"
    n = tattn.LAUNCHES["flash_fwd_stream"]
    got = tattn.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd_stream"] == n + 1
    want = tattn.reference_attention(q.float(), k.float(), v.float(), scale=72 ** -0.5)
    assert (got.float() - want).abs().max().item() < 2e-2
