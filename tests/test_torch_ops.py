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
    (256, 160, "flash_fwd_oneshot"),  # level-2 self-attention (16-row q tile)
    (64, 160, "flash_fwd_oneshot"),  # mid-block self-attention
    (77, 40, "flash_fwd_oneshot"),  # cross-attention over the 77 text tokens
    (77, 80, "flash_fwd_oneshot"),
    (77, 160, "flash_fwd_oneshot"),
    (4096, 512, "flash_fwd_stream"),  # VAE mid-block, single head, D = C
]


# The SDXL calls at 1024² that take flash_attention_bhsd (batch folded into BH)
SDXL_ATTENTION = [
    (4096, 64, "flash_fwd_stream"),  # level-1 self-attention
    (1024, 64, "flash_fwd_stream"),  # level-2 and mid self-attention (one-shot tiles: 295 KB)
    (16384, 512, "flash_fwd_stream"),  # VAE mid-block
]


@pytest.mark.parametrize("kv,d,kernel", SD15_ATTENTION + SDXL_ATTENTION)
def test_attention_plan_at_sd15_shapes(kv, d, kernel):
    kind, bq = tattn.attention_plan(kv, d)
    assert kind == kernel and bq % 16 == 0
    if kind == "flash_fwd_oneshot":  # the whole padded KV fits one block
        assert tattn.smem_bytes(bq, -(-kv // 16) * 16, -(-d // 16) * 16) <= tattn._SMEM_LIMIT


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


@pytest.mark.parametrize("d,kv", [(64, 77), (64, 256), (128, 77), (128, 256)])
def test_packed_tiles_fit_a_block(d, kv):
    """Every shape ``packed_cross_eligible`` takes fits one block's shared memory."""
    assert tattn.packed_cross_eligible(torch.empty(1, 1, 2, d), kv)
    assert tattn.packed_smem_bytes(d, -(-kv // 16) * 16) <= tattn._SMEM_LIMIT


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
    got, bq, bkv, dc = tattn.attention_bwd_plan(kv, d)
    dp = -(-d // 16) * 16
    assert got == route and bq % 16 == 0 and bkv % 16 == 0 and dp % dc == 0
    if route == "flash_bwd_oneshot":
        need = tattn.bwd_smem_bytes(bq, bkv, dp, bkv, dp, 2, tattn._BWD_SCRATCH)
    else:
        need = tattn.bwd_smem_bytes(bq, bkv, dp, bkv, dc, 2)
    assert need <= tattn._SMEM_LIMIT


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
@pytest.mark.parametrize("b,sq,kv,h,d", [
    (4, 4096, 77, 10, 64), (4, 1024, 77, 20, 64), (1, 4000, 77, 10, 64),
    (2, 1000, 200, 20, 64), (1, 33, 256, 8, 128), (2, 1024, 77, 8, 128),
    (8, 100, 77, 20, 64), (3, 130, 16, 4, 64), (2, 70, 250, 2, 128),
])
def test_packed_kernel_matches_plain_on_card(cuda, b, sq, kv, h, d):
    """bf16 kernel vs the plain version on the same inputs in fp32, batch 1
    and ragged Sq/KV included. Tolerance: bf16 rounding of p and of the
    output, |out| < 4 → 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, kv, kv))
    n = tattn.LAUNCHES["flash_fwd_oneshot_packed"]
    out = tattn.flash_attention_packed(q, k, v, h, d ** -0.5)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_fwd_oneshot_packed"] == n + 1
    want = tattn.attention_packed_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
    assert (out.float() - want).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_dot_product_attention_packed_on_card_matches_cpu(cuda, b):
    """The [B, S, H, D] ⇄ [B, S, H·D] reshape around the packed kernel from
    the projections' layout, batch 1 included, against the plain path on
    the CPU (bf16 tolerance)."""
    g = torch.Generator().manual_seed(4)
    lin = torch.nn.Linear(640, 640, bias=False)
    x, ctx = torch.randn(b, 300, 640, generator=g), torch.randn(b, 77, 640, generator=g)
    q = lin(x).detach().reshape(b, 300, 10, 64).to(torch.bfloat16)
    k, v = (lin(ctx).detach().reshape(b, 77, 10, 64).to(torch.bfloat16) for _ in range(2))
    want = tattn.dot_product_attention(q.float(), k.float(), v.float())
    n = tattn.LAUNCHES["flash_fwd_oneshot_packed"]
    got = tattn.dot_product_attention(q.to(cuda), k.to(cuda), v.to(cuda)).float().cpu()
    assert tattn.LAUNCHES["flash_fwd_oneshot_packed"] == n + 1
    assert (got - want).abs().max().item() < 2e-2


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
    batch 1 and ragged Sq/KV included. Tolerance: the forward's 2e-2 times
    max(1, max|grad|) (p, ds and the outputs are rounded to bf16)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda).to(torch.bfloat16) for s in (sq, skv, skv))
    do = torch.randn(bh, sq, d, generator=g, device=cuda).to(torch.bfloat16)
    o, lse = tattn.flash_attention_bhsd(q, k, v, d ** -0.5, kv_valid)
    route = tattn.attention_bwd_plan(kv_valid or skv, d)[0]
    keys = ("flash_bwd_oneshot",) if route == "flash_bwd_oneshot" else ("flash_bwd_dkv", "flash_bwd_dq")
    n = [tattn.LAUNCHES[kk] for kk in keys]
    got = tattn.flash_attention_bwd_bhsd(q, k, v, o, lse, do, d ** -0.5, kv_valid)
    torch.cuda.synchronize()
    assert [tattn.LAUNCHES[kk] for kk in keys] == [m + 1 for m in n]
    want = tattn.attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                         d ** -0.5, kv_valid)
    for a, b in zip(got, want):
        assert (a.float() - b).abs().max().item() <= 2e-2 * max(1.0, b.abs().max().item())


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
    n = dict(tnorms.LAUNCHES)
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
