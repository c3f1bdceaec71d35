"""The JAX package's opt-in kernel modes in the PyTorch port: the
feed-forward GEMMs (K10 under ``FLASH_TPU_FFN_DOWN_GEMM=1``, K12 under
``FLASH_TPU_FFN_FUSED=1``) and the packed streaming attention (K5 under
``FLASH_TPU_ATTN_PACKED=1``).

On the CPU the port's wrappers run their plain versions; these are held
against the JAX Pallas kernels in interpret mode (``tests/conftest.py``),
with the same numpy inputs, and the tests check that both packages route
each call alike (JAX's kernels are seen through a spy on
``pl.pallas_call``). Tolerances in fp32, measured first and set at about
twice the largest error (the JAX package's own tests hold its kernels to
2e-2): K10 3e-6 absolute (measured 1.4e-6), K5 4e-7 (1.8e-7), a
transformer block 7e-6 (3.5e-6). In bf16, 2e-2 relative L2 for K10, K12
and the block (measured 2.7e-5, 4.0e-3 and 4.4e-3: JAX rounds each bf16
elementwise op, the port rounds h once). Gradients as the JAX package's
own tests (``tests/test_ops.py``).

Tests marked ``cuda`` hold K5, K10 and K12 against their plain versions on
the card (K5 to its own, tighter tolerance, with v offset on the ragged
cases so that a leak of padded keys would show) and skip without one:
``python -m pytest --noconftest -m cuda tests/test_torch_ffn.py``.
"""

import functools

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.models.layers import BasicTransformerBlock
from flash_diffusion_tpu_torch.ops import attention as tattn
from flash_diffusion_tpu_torch.ops import gemm as tgemm
from flash_diffusion_tpu_torch.quant import apply_weights, quantize_weight
from flash_diffusion_tpu_torch.utils import convert

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from flash_diffusion_tpu.models import layers as jlayers
    from flash_diffusion_tpu.models.layers import BasicTransformerBlock as JBlock
    from flash_diffusion_tpu.ops import attention as jattn
    from flash_diffusion_tpu.ops import gemm as jgemm
except ImportError:
    jax = None

torch.set_num_threads(2)

SWITCHES = ("FLASH_TPU_ATTN_PACKED", "FLASH_TPU_FFN_FUSED", "FLASH_TPU_FFN_DOWN_GEMM")
MODES = {
    "packed_fused": {"FLASH_TPU_ATTN_PACKED": "1", "FLASH_TPU_FFN_FUSED": "1"},
    "down_gemm": {"FLASH_TPU_FFN_DOWN_GEMM": "1"},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def mode(monkeypatch):
    """Sets one of MODES (or none) for the test, the other switches unset."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)

    def set_mode(name=None):
        for k in SWITCHES:
            monkeypatch.delenv(k, raising=False)
        for k, v in MODES.get(name, {}).items():
            monkeypatch.setenv(k, v)

    return set_mode


@pytest.fixture
def jax_kernels(jax_ref, monkeypatch):
    """The names of the Pallas kernels the JAX package calls. Its models'
    attention asks for them too (on the CPU ``dot_product_attention``
    defaults to XLA; biased calls stay there)."""
    names = []
    real = pl.pallas_call
    monkeypatch.setattr(jlayers, "dot_product_attention",
                        functools.partial(jattn.dot_product_attention, use_pallas=True))

    def spy(kernel, *args, **kwargs):
        names.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", spy)
    return names


@pytest.fixture
def port_kernels(monkeypatch):
    """The names of the port's kernel wrappers called (on the CPU, their
    plain versions run inside)."""
    names = []
    for module, name in ((tgemm, "gemm"), (tgemm, "geglu_gemm"), (tattn, "flash_attention_packed_stream"),
                         (tattn, "flash_attention_packed"), (tattn, "flash_attention_bhsd")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _f=real, **kw: names.append(_n) or _f(*a, **kw))
    return names


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


_DT = {"float32": (jnp.float32 if jax else None, torch.float32), "bfloat16": (jnp.bfloat16 if jax else None, torch.bfloat16)}


def _both(a, dtype):
    """(the JAX array, the torch tensor) of a float32 numpy array in ``dtype``."""
    jdt, tdt = _DT[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1024, 1032])
def test_down_proj_gemm_matches_jax(jax_kernels, port_kernels, m, dtype):
    """K10 (its plain version) vs JAX ``down_proj_gemm`` on its Pallas
    kernel; M = 1032 leaves JAX's 512-row block ragged."""
    rng = np.random.default_rng(m)
    x, w, b = _randn(rng, 4, m // 4, 2048, scale=0.5), _randn(rng, 2048, 128, scale=0.02), _randn(rng, 128, scale=0.1)
    (jx, tx), (jw, tw), (jb, tb) = _both(x, dtype), _both(np.ascontiguousarray(w.T), dtype), _both(b, dtype)
    want = jgemm.down_proj_gemm(jx, jw.T, jb)
    got = tgemm.down_proj_gemm(tx, tw, tb)
    assert jax_kernels == ["_gemm_kernel"] and port_kernels == ["gemm"]
    assert got.dtype == tx.dtype and got.shape == (4, m // 4, 128)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-6, rtol=0)
    else:
        assert rel_l2(_f32(got), _f32(want)) <= 2e-2


@pytest.mark.parametrize("m", [1032, 2048])
def test_down_proj_gemm_grads_match_jax(jax_kernels, port_kernels, m):
    """dx, dW, db of ``DownProjGemmFunction`` vs JAX's custom VJP (fp32, the
    tolerance of ``tests/test_ops.py``); at M = 2048, dW = xᵀ·dy goes
    through K10 on both sides."""
    rng = np.random.default_rng(m + 1)
    x, w, b = _randn(rng, m, 2048, scale=0.5), _randn(rng, 2048, 128, scale=0.02), _randn(rng, 128, scale=0.1)
    loss = lambda x, w, b: jnp.sum(jnp.sin(jgemm.down_proj_gemm(x, w, b)))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, np.ascontiguousarray(w.T), b))
    torch.sin(tgemm.down_proj_gemm(tx, tw, tb)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad.t(), tb.grad), want):
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=5e-2, rtol=0)
    through_k10 = m >= 2048
    assert port_kernels == ["gemm"] * (1 + through_k10)
    assert jax_kernels.count("_gemm_kernel") == 1 + through_k10


def test_geglu_down_proj_matches_jax(jax_kernels, port_kernels):
    """K12 (its plain version, h rounded once) vs JAX ``geglu_down_proj`` on
    its Pallas kernel in bf16, forward and the custom VJP's gradients."""
    rng = np.random.default_rng(5)
    x2k, w, b = _randn(rng, 2, 512, 4096), _randn(rng, 2048, 128, scale=0.02), _randn(rng, 128, scale=0.1)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, "bfloat16") for a in (x2k, np.ascontiguousarray(w.T), b))
    want = jgemm.geglu_down_proj(jx, jw.T, jb)
    got = tgemm.geglu_down_proj(tx, tw, tb)
    assert jax_kernels == ["_geglu_gemm_kernel"] and port_kernels == ["geglu_gemm"]
    assert got.dtype == torch.bfloat16 and rel_l2(_f32(got), _f32(want)) <= 2e-2

    loss = lambda *a: jnp.sum(jnp.sin(jgemm.geglu_down_proj(*a).astype(jnp.float32)))
    gwant = jax.grad(loss, argnums=(0, 1, 2))(jx, jw.T, jb)
    leaves = [t.clone().requires_grad_() for t in (tx, tw, tb)]
    torch.sin(tgemm.geglu_down_proj(*leaves).float()).sum().backward()
    for got, ref in zip((leaves[0].grad, leaves[1].grad.t(), leaves[2].grad), gwant):
        d = np.abs(_f32(got) - _f32(ref))
        assert d.max() <= 0.1 + 0.05 * np.abs(_f32(ref)).max(), d.max()


@pytest.mark.parametrize("kv", [1280, 1100])
def test_packed_stream_matches_jax(jax_kernels, port_kernels, mode, kv):
    """Under ``FLASH_TPU_ATTN_PACKED=1`` both packages send [2, 256, 4, 64]
    over 1280 keys (the JAX test's shape) or a ragged 1100 to the packed
    streaming kernel; fp32, the port's plain version vs JAX's K5."""
    mode("packed_fused")
    rng = np.random.default_rng(kv)
    q, k, v = _randn(rng, 2, 256, 4, 64), _randn(rng, 2, kv, 4, 64), _randn(rng, 2, kv, 4, 64)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert jax_kernels == ["_flash_fwd_packed_kernel"] and port_kernels == ["flash_attention_packed_stream"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4e-7, rtol=0)


# [M, K, N] of the down projection: SDXL 1024² at batch 4 (levels 1 and 2)
# and K10's dW shapes there; ineligible: SD1.5's 320-channel level (K =
# 1280), M < 1024, M % 8 != 0, N > 2048, K < 2N
GEMM_ROUTES = [
    ((16384, 2560, 640), True), ((4096, 5120, 1280), True), ((2560, 16384, 640), True), ((5120, 4096, 1280), True),
    ((16384, 1280, 320), False), ((512, 2048, 128), False), ((1028, 2048, 128), False), ((1024, 8192, 4096), False),
    ((4096, 2048, 1280), False),
]


@pytest.mark.parametrize("shape,eligible", GEMM_ROUTES)
def test_gemm_route_matches_jax(jax_ref, shape, eligible):
    assert tgemm.gemm_eligible(*shape) == jgemm.gemm_eligible(*shape) == eligible


# (b, sq, kv, h, d, kv_valid, grad, the port's route, JAX's): SDXL's self-
# attention at levels 1 and 2 (the departure: JAX's 1024-token call falls
# back to the per-head kernels) and its cross-attention; a kv_valid call
# (SD3's joint attention), a call under gradient, D = 72 (Pixart), 1 head
ATTN_ROUTES = [
    (1, 4096, 4096, 10, 64, None, False, "packed_stream", "packed_stream"),
    (1, 1024, 1024, 20, 64, None, False, "packed_stream", "bhsd"),
    (1, 4096, 77, 10, 64, None, False, "packed_oneshot", "packed_oneshot"),
    (1, 4352, 4352, 24, 64, 4250, False, "bhsd", "bhsd"),
    (1, 1024, 1024, 10, 64, None, True, "bhsd", "bhsd"),
    (1, 4096, 4096, 16, 72, None, False, "bhsd", "bhsd"),
    (1, 1024, 1024, 1, 64, None, False, "bhsd", "bhsd"),
]
_JAX_ROUTE = {"_flash_fwd_packed_kernel": "packed_stream", "_flash_fwd_oneshot_packed_kernel": "packed_oneshot",
              "_flash_fwd_kernel": "bhsd", "_flash_fwd_oneshot_kernel": "bhsd"}
_PORT_ROUTE = {"flash_attention_packed_stream": "packed_stream", "flash_attention_packed": "packed_oneshot",
               "flash_attention_bhsd": "bhsd"}


@pytest.mark.parametrize("b,sq,kv,h,d,kv_valid,grad,port,want", ATTN_ROUTES)
def test_attention_route_matches_jax(jax_kernels, mode, monkeypatch, b, sq, kv, h, d, kv_valid, grad, port, want):
    """Under ``FLASH_TPU_ATTN_PACKED=1``, which kernel each package's
    dispatch picks (JAX traced abstractly, the port's kernels stubbed)."""
    mode("packed_fused")
    q = jax.ShapeDtypeStruct((b, sq, h, d), jnp.bfloat16)
    kk = jax.ShapeDtypeStruct((b, kv, h, d), jnp.bfloat16)
    call = lambda q, k, v: jattn.dot_product_attention(q, k, v, use_pallas=True, kv_valid=kv_valid)
    if grad:
        jax.eval_shape(jax.grad(lambda q, k, v: call(q, k, v).astype(jnp.float32).sum()), q, kk, kk)
    else:
        jax.eval_shape(call, q, kk, kk)
    assert {_JAX_ROUTE[n] for n in jax_kernels if "fwd" in n} == {want}

    taken = []
    for name, route in _PORT_ROUTE.items():
        stub = (lambda q, *a, _r=route: taken.append(_r) or (torch.zeros_like(q), torch.zeros(q.shape[:2]))
                if _r == "bhsd" else taken.append(_r) or torch.zeros_like(q))
        monkeypatch.setattr(tattn, name, stub)
    qt, kt = torch.zeros(b, sq, h, d, dtype=torch.bfloat16), torch.zeros(b, kv, h, d, dtype=torch.bfloat16)
    tattn.dot_product_attention(qt.requires_grad_(grad), kt, kt, kv_valid=kv_valid)
    assert taken == [port]


def _block_state(p):
    """Port state dict of a JAX ``BasicTransformerBlock``'s params, through
    the converter's own pieces."""
    sd = {}
    for i in ("1", "2"):
        convert._norm(sd, f"norm{i}", p[f"norm{i}"])
        convert._attention(sd, f"attn{i}", p[f"attn{i}"])
    convert._norm(sd, "norm3", p["norm3"])
    convert._lin(sd, "ff.net.0.proj", p["ff"]["proj_in"])
    convert._lin(sd, "ff.net.2", p["ff"]["proj_out"])
    return sd


# (mode, dtype, proj_out: plain, a non-zero LoRA pair, or int8), and the
# kernels each package takes
BLOCK_CASES = [
    ("packed_fused", "bfloat16", "plain"), ("packed_fused", "bfloat16", "lora"),
    ("packed_fused", "bfloat16", "int8"), ("down_gemm", "float32", "plain"), ("down_gemm", "float32", "lora"),
]
BLOCK_KERNELS = {
    "packed_fused": ({"_flash_fwd_packed_kernel", "_geglu_gemm_kernel"}, {"flash_attention_packed_stream", "geglu_gemm"}),
    "down_gemm": ({"_gemm_kernel"}, {"gemm"}),
}


@functools.lru_cache(maxsize=None)
def _jax_block(dtype):
    """A JAX ``BasicTransformerBlock`` at width 512 (8 heads of 64) and its
    params, initialised once per dtype for all of BLOCK_CASES."""
    jblock = JBlock(8, 64, dtype=_DT[dtype][0])
    x, ctx = jnp.zeros((1, 1296, 512), _DT[dtype][0]), jnp.zeros((1, 77, 64), _DT[dtype][0])
    return jblock, jax.jit(jblock.init)(jax.random.PRNGKey(0), x, ctx)["params"]


@pytest.mark.parametrize("mode_name,dtype,proj_out", BLOCK_CASES)
def test_transformer_block_in_mode_matches_jax(jax_kernels, port_kernels, mode, mode_name, dtype, proj_out):
    """One ``BasicTransformerBlock`` at width 512 (8 heads of 64) over 36×36
    tokens, 77 context tokens: the port (weights through the converter)
    against JAX under the same switches, and both took the mode's kernels."""
    mode(mode_name)
    rng = np.random.default_rng(11)
    x, ctx = _randn(rng, 1, 1296, 512), _randn(rng, 1, 77, 64)
    (jx, tx), (jc, tc) = _both(x, dtype), _both(ctx, dtype)
    jblock, params = _jax_block(dtype)
    block = BasicTransformerBlock(512, 8, 64)
    block.load_state_dict(_block_state(params))
    block = block.to(_DT[dtype][1]).eval()
    variables = {"params": params}
    out = block.ff.net[2]
    if proj_out == "lora":
        a, b = _randn(rng, 2048, 4, scale=0.05), _randn(rng, 4, 512, scale=0.1)
        variables["lora"] = {"ff": {"proj_out": {"kernel": {"a": jnp.asarray(a), "b": jnp.asarray(b)}}}}
        out.lora = (torch.from_numpy(a), torch.from_numpy(b), 1.0)
    elif proj_out == "int8":
        wq, scale = quantize_weight(out.weight.detach().float())
        ff = dict(params["ff"])
        ff["proj_out"] = {**ff["proj_out"], "kernel": jnp.asarray(wq.numpy().T), "kernel_scale": jnp.asarray(scale.numpy())}
        variables["params"] = {**params, "ff": ff}
        apply_weights(block, {"ff.net.2.weight": wq, "ff.net.2.weight_scale": scale})
    want = jblock.apply(variables, jx, jc)
    with torch.no_grad():
        got = block(tx, tc)
    jax_want, port_want = BLOCK_KERNELS[mode_name]
    assert jax_want <= set(jax_kernels) and port_want <= set(port_kernels)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=7e-6, rtol=0)
    else:
        assert rel_l2(_f32(got), _f32(want)) <= 2e-2


def test_switches_keep_the_parameters(mode):
    """The switches change no parameter: the same state-dict keys, shapes
    and dtypes in every mode, as JAX's ``_ProjParams`` mirrors
    ``LoraDense``."""
    layouts = []
    for name in (None, *MODES):
        mode(name)
        torch.manual_seed(0)
        block = BasicTransformerBlock(64, 2, 32)
        block(torch.randn(1, 8, 64), torch.randn(1, 5, 32))
        layouts.append({k: (v.shape, v.dtype) for k, v in block.state_dict().items()})
    assert layouts[0] == layouts[1] == layouts[2]


def test_default_mode_takes_the_default_routes(mode, port_kernels):
    """With no switch set the feed-forward and the self-attention take the
    default path, as in JAX (every switch defaults to "0")."""
    mode(None)
    block = BasicTransformerBlock(512, 8, 64).eval()
    with torch.no_grad():
        block(torch.randn(1, 1040, 512), torch.randn(1, 7, 64))
    assert port_kernels == ["flash_attention_bhsd", "flash_attention_packed"]


# [M, K, N] of K10 on the card's paths and in its checks: SDXL's forward
# shapes, the ragged ones, and the dW shapes
K10_CALLS = [(16384, 2560, 640), (4096, 5120, 1280), (4096, 2560, 640), (1024, 5120, 1280), (4001, 2560, 640),
             (1032, 2048, 128), (2560, 16384, 640), (5120, 4096, 1280)]


@pytest.mark.parametrize("m,k,n", K10_CALLS)
def test_gemm_plan_fits_and_follows_k_and_n(m, k, n):
    """K10's plan: a built tile width, 4–8 stages of x [128, 64] and w [bn,
    64] that fit a block with their barriers and the alignment slack, the
    same for any M (so a row's bits do not depend on it), and one
    persistent block per SM or per tile."""
    p = tgemm.gemm_plan(k, n)
    assert p.bn in (112, 128, 160, 224, 256) and 4 <= p.stages <= 8 and p.threads == 288
    assert p.smem == 1024 + p.stages * ((128 + p.bn) * 64 * 2 + 16) <= 232448
    assert all(tgemm.gemm_plan(k, n) == p for _ in (m, 1, 2 * m))  # no M in the plan
    for bn in (112, 128, 160, 224, 256):
        assert tgemm.gemm_plan(k, n, bn).smem <= 232448
    tiles = -(-m // 128) * -(-n // p.bn)
    assert tgemm.gemm_blocks(m, n, p.bn, 132) == min(tiles, 132)


@pytest.mark.parametrize("fault", [None, "bias dropped", "y x 1.01", "K step zeroed"])
@pytest.mark.parametrize("geglu", [False, True])
def test_gemm_gate_passes_the_plain_gemm_and_catches_faults(geglu, fault):
    """The gate of K10 and K12, on the CPU: the plain version on the bf16
    inputs (the kernels' rounding points) against itself in fp32 passes; a
    copy with the bias dropped, with y × 1.01, or with the last 64-deep K
    step zeroed fails."""
    g = torch.Generator().manual_seed(16)
    m, k, n = 1032, 2048, 128
    x = torch.randn(m, 2 * k if geglu else k, generator=g).bfloat16()
    w = (torch.randn(n, k, generator=g) * k ** -0.5).bfloat16()
    b = (0.1 * torch.randn(n, generator=g)).bfloat16()
    plain = tgemm.geglu_down_proj_reference if geglu else tgemm.down_proj_gemm_reference
    want = plain(x.float(), w.float(), b.float())
    if fault == "bias dropped":
        b = torch.zeros_like(b)
    if fault == "K step zeroed":
        w[:, k - 64:] = 0
    got = plain(x, w, b)
    if fault == "y x 1.01":
        got = (got.float() * 1.01).bfloat16()
    ok, report = tgemm.gemm_gate(tgemm.gemm_errors(got, want))
    assert ok == (fault is None), report


# -- on the card ----------------------------------------------------------

# (M, K, N): SDXL's two shapes, batch 1, ragged M (odd), the dW shapes
CARD_GEMMS = [(16384, 2560, 640), (4096, 5120, 1280), (4096, 2560, 640), (4001, 2560, 640), (1032, 2048, 128),
              (2560, 16384, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("geglu", [False, True])
@pytest.mark.parametrize("m,k,n", CARD_GEMMS)
def test_ffn_gemm_kernels_match_plain_on_card(cuda, geglu, m, k, n):
    """K10 and K12 vs their plain version in fp32, held to ``gemm_gate``
    (bf16 out; K12 rounds h too), and vs the plain version on the same bf16
    inputs within 2^-7 of max|y|."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, 2 * k if geglu else k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).bfloat16()
    b = (0.1 * torch.randn(n, generator=g, device=cuda)).bfloat16()
    kernel, plain = (tgemm.geglu_gemm, tgemm.geglu_down_proj_reference) if geglu else (
        tgemm.gemm, tgemm.down_proj_gemm_reference)
    before = tgemm.LAUNCHES["geglu_gemm" if geglu else "gemm"]
    y = kernel(x, w, b)
    assert tgemm.LAUNCHES["geglu_gemm" if geglu else "gemm"] == before + 1
    ref = plain(x.float(), w.float(), b.float())
    ok, report = tgemm.gemm_gate(tgemm.gemm_errors(y, ref))
    assert ok, report
    assert (y.float() - plain(x, w, b).float()).abs().max().item() <= 2 ** -7 * ref.abs().max().item()


@pytest.mark.cuda
def test_ffn_gemm_refuses_what_it_does_not_take_on_card(cuda):
    """K10 is built for bf16: an fp32 call JAX would send to K10 raises
    instead of taking another product; so do shapes off the kernel's grid."""
    x, w = torch.randn(1024, 2048, device=cuda), torch.randn(128, 2048, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tgemm.down_proj_gemm(x, w, None)
    xb, wb = x.bfloat16(), w.bfloat16()
    with pytest.raises(ValueError, match="K % 64"):
        tgemm.gemm(xb[:, :2000].contiguous(), wb[:, :2000].contiguous(), wb[:, 0].contiguous())
    with pytest.raises(ValueError, match="2K"):
        tgemm.geglu_gemm(xb, wb, wb[:, 0].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("geglu", [False, True])
def test_ffn_gemm_batch_invariant_on_card(cuda, geglu):
    """A row's bits do not depend on M: slot 1 of a batch of 4 equals the
    same rows alone (no split of K that follows M)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    k, n = 2560, 640
    x = torch.randn(4, 4096, 2 * k if geglu else k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).bfloat16()
    b = torch.randn(n, generator=g, device=cuda).bfloat16()
    kernel = tgemm.geglu_gemm if geglu else tgemm.gemm
    batched = kernel(x.reshape(-1, x.shape[-1]), w, b).reshape(4, 4096, n)
    assert torch.equal(batched[1], kernel(x[1].contiguous(), w, b))


@pytest.mark.cuda
def test_gemm_rows_bit_equal_alone_and_inside_a_larger_m_on_card(cuda):
    """K10's rows 1000..2030 alone (M = 1031, off the 128-row tile) equal
    the same rows inside M = 4001, where they start 104 rows into a tile,
    and a second run gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    k, n = 2560, 640
    x = torch.randn(4001, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).bfloat16()
    b = torch.randn(n, generator=g, device=cuda).bfloat16()
    whole = tgemm.gemm(x, w, b)
    assert torch.equal(whole, tgemm.gemm(x, w, b))
    assert torch.equal(whole[1000:2031], tgemm.gemm(x[1000:2031].contiguous(), w, b))


@pytest.mark.cuda
def test_down_proj_grads_at_a_dw_shape_match_cpu(cuda):
    """``DownProjGemmFunction`` at a shape whose dW = xᵀ·dy is K10's too
    (M = 2048): forward and gradients on the card vs the same function on
    the CPU (the plain versions), all in bf16, to a relative L2 of 1e-2
    (the same roundings; sums in another order)."""
    g = torch.Generator().manual_seed(5)
    m, k, n = 2048, 2048, 128
    assert tgemm.gemm_eligible(m, k, n) and tgemm.gemm_eligible(k, m, n)
    x = torch.randn(m, k, generator=g).bfloat16()
    w = (torch.randn(n, k, generator=g) * 0.02).bfloat16()
    b = (0.1 * torch.randn(n, generator=g)).bfloat16()
    dy = torch.randn(m, n, generator=g).bfloat16()
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).detach().requires_grad_() for t in (x, w, b)]
        before = tgemm.LAUNCHES["gemm"]
        y = tgemm.down_proj_gemm(*leaves)
        y.backward(dy.to(dev))
        assert tgemm.LAUNCHES["gemm"] - before == (0 if dev == "cpu" else 2)
        grads.append([y.detach().float().cpu()] + [t.grad.float().cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("geglu", [False, True])
@pytest.mark.parametrize("m", [1032, 2048])
def test_ffn_gemm_functions_grads_on_card(cuda, geglu, m):
    """``DownProjGemmFunction`` (dW through K10 at M = 2048) and
    ``GegluGemmFunction``: forward and gradients on the card vs plain
    autograd of the same function in fp32, to a relative L2 of 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(m)
    k, n = 2048, 128
    x = torch.randn(m, 2 * k if geglu else k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(n, k, generator=g, device=cuda) * 0.02).bfloat16()
    b = (0.1 * torch.randn(n, generator=g, device=cuda)).bfloat16()
    dy = torch.randn(m, n, generator=g, device=cuda)
    fn = tgemm.geglu_down_proj if geglu else tgemm.down_proj_gemm
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = dict(tgemm.LAUNCHES)
    (fn(*leaves).float() * dy).sum().backward()
    grown = {k2: tgemm.LAUNCHES[k2] - before[k2] for k2 in before}
    assert grown == {"int8_gemm": 0, "gemm": 0 if geglu else 1 + (m >= 2048), "geglu_gemm": int(geglu)}
    refs = [t.float().requires_grad_() for t in (x, w, b)]
    h = tgemm.geglu_h(refs[0]) if geglu else refs[0]
    ((h @ refs[1].t() + refs[2]) * dy).sum().backward()
    for got, ref in zip(leaves, refs):
        assert ((got.grad.float() - ref.grad).norm() / ref.grad.norm()).item() <= 2e-2


# K5 vs its plain version in fp32 on the card: max|err| within 4e-3 +
# 2^-8·max|ref| (out and p rounded to bf16; measured 1.2e-3 where a typical
# |out| is ~0.03), and the mean signed error within 5e-4 (rounding to
# nearest has no bias). The ragged cases offset v by +1, so that zero-filled
# keys past KV that leaked into the softmax would pull every row towards 0,
# by 0.5% (KV 4000) to 3.3% (KV 1030) of |out| ~ 1
K5_TOL, K5_BIAS_TOL = 4e-3, 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,kv,h,d,v_offset", [
    (4, 4096, 4096, 10, 64, 0.0), (4, 1024, 1024, 20, 64, 0.0), (4, 4000, 4000, 10, 64, 1.0),
    (1, 1000, 1030, 20, 64, 1.0), (2, 700, 1500, 8, 128, 1.0), (1, 70, 77, 2, 64, 1.0),
])
def test_packed_stream_kernel_matches_plain_on_card(cuda, b, sq, kv, h, d, v_offset):
    """K5 vs the packed plain version in fp32 (K5_TOL, K5_BIAS_TOL), at
    SDXL's shapes and ragged ones (Sq and KV off the tiles, v offset)."""
    g = torch.Generator(device=cuda).manual_seed(sq + kv)
    q, k, v = (torch.randn(b, s, h * d, generator=g, device=cuda).bfloat16() for s in (sq, kv, kv))
    v = v + v_offset
    out = tattn.flash_attention_packed_stream(q, k, v, h, d ** -0.5)
    ref = tattn.attention_packed_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
    diff = out.float() - ref
    assert diff.abs().max().item() <= K5_TOL + 2 ** -8 * ref.abs().max().item()
    assert abs(diff.mean().item()) <= K5_BIAS_TOL


@pytest.mark.cuda
def test_packed_stream_batch_invariant_and_routed_on_card(cuda, mode):
    """Under ``FLASH_TPU_ATTN_PACKED=1`` a [B, S, H, D] self-attention
    launches K5, and slot 1 of a batch of 4 gets the bits it gets alone."""
    mode("packed_fused")
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 1024, 20, 64, generator=g, device=cuda).bfloat16()
    before = tattn.LAUNCHES["flash_fwd_packed"]
    out = tattn.dot_product_attention(x, x, x)
    assert tattn.LAUNCHES["flash_fwd_packed"] == before + 1
    assert torch.equal(out[1], tattn.dot_product_attention(x[1:2], x[1:2], x[1:2])[0])
