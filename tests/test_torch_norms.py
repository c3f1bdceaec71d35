"""The gates of the LayerNorm kernel (K3) and of the whole GroupNorm.

On the CPU: the plain versions in bf16 (the kernels' rounding points)
against fp32 sit inside ``layer_norm_gate`` and ``group_norm_gate`` with a
printed margin (run with ``-rP``), and copies of the plain versions with
one fault each (the faults ``gate_mutants.py`` writes into the kernels)
fail them. Tests marked ``cuda`` hold the kernels to the gates on the card
and skip without one: ``python -m pytest --noconftest -m cuda
tests/test_torch_norms.py``.
"""

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch.ops import norms as tnorms

try:  # the JAX reference; absent where only the port is installed
    import jax.numpy as jnp

    from flash_diffusion_tpu.ops import norms as jnorms
except ImportError:
    jnp = None

torch.set_num_threads(2)


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA-only")
    return torch.device("cuda")


# (rows, C, dtype, scale of x, offset of x): the card's kinds of LayerNorm
# case at a few rows: unit scale at the paths' widths (bf16 and CLIP's fp32)
# and a ragged width, and rows of small variance (var ≈ eps)
LN_CASES = [
    (64, 320, torch.bfloat16, 2.0, 0.5), (32, 1280, torch.bfloat16, 2.0, 0.5), (24, 1152, torch.bfloat16, 2.0, 0.5),
    (21, 100, torch.bfloat16, 2.0, 0.5), (40, 768, torch.float32, 2.0, 0.5),
    (64, 320, torch.bfloat16, 3e-3, 0.0), (40, 768, torch.float32, 3e-3, 0.0),
]


def _ln_inputs(rows, c, dtype, scale, offset):
    g = torch.Generator().manual_seed(rows * c)
    x = (torch.randn(rows, c, generator=g) * scale + offset).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g)).to(dtype)
    return x, w, b


def _plain_ln_variant(x, w, b, fault):
    """``layer_norm_reference`` in x's dtype, or a copy of it with one fault:
    the bias dropped, the last 16-byte pack of each row skipped (left out of
    the statistics, its outputs unwritten: zeros), eps dropped, y × 1.01."""
    if fault == "last pack skipped":
        k = x.shape[-1] - 16 // x.element_size()
        y = torch.zeros_like(x)
        y[:, :k] = tnorms.layer_norm_reference(x[:, :k], w[:k], b[:k])
        return y
    y = tnorms.layer_norm_reference(x, w, None if fault == "bias dropped" else b,
                                    eps=0.0 if fault == "eps dropped" else 1e-5)
    return (y.float() * 1.01).to(x.dtype) if fault == "y x 1.01" else y


@pytest.mark.parametrize("rows,c,dtype,scale,offset", LN_CASES)
def test_plain_bf16_layer_norm_sits_inside_the_gate(rows, c, dtype, scale, offset):
    """Where ``LN_GATE`` comes from: the plain version in x's dtype against
    fp32 on the same inputs passes with a margin of 1.5× on the relative L2
    (printed), and y × 1.01 fails it."""
    x, w, b = _ln_inputs(rows, c, dtype, scale, offset)
    want = tnorms.layer_norm_reference(x.float(), w.float(), b.float())
    stats = tnorms.layer_norm_errors(tnorms.layer_norm_reference(x, w, b), want)
    ok, report = tnorms.layer_norm_gate(stats)
    l2 = tnorms.LN_GATE[dtype][2]
    print(f"plain {stats['dtype']} layer_norm rel L2 {stats['rel_l2']:.3e} (tol {l2}, margin "
          f"{l2 / max(stats['rel_l2'], 1e-12):.1f}x) at {(rows, c, scale)}: {report}")
    assert ok and stats["rel_l2"] * 1.5 <= l2, report
    assert not tnorms.layer_norm_gate(tnorms.layer_norm_errors(_plain_ln_variant(x, w, b, "y x 1.01"), want))[0]


@pytest.mark.parametrize("fault", [None, "bias dropped", "last pack skipped", "eps dropped", "y x 1.01"])
def test_layer_norm_gate_catches_faults(fault):
    """The four K3 faults of ``gate_mutants.py`` in the plain version: each
    fails at least one of the card's kinds of case, y × 1.01 every case,
    and the plain version none."""
    verdicts = []
    for case in LN_CASES:
        x, w, b = _ln_inputs(*case)
        want = tnorms.layer_norm_reference(x.float(), w.float(), b.float())
        verdicts.append(tnorms.layer_norm_gate(tnorms.layer_norm_errors(_plain_ln_variant(x, w, b, fault), want))[0])
    if fault is None:
        assert all(verdicts), verdicts
    elif fault == "y x 1.01":
        assert not any(verdicts), verdicts
    else:
        assert not all(verdicts), verdicts


# (shape, groups, dtype): the card's kinds of GroupNorm case at a small
# size: UNet widths (C/G = 10, 40), the VAE's (4, 16), ragged N and C, fp32
GN_CASES = [
    ((2, 320, 16, 16), 32, torch.bfloat16), ((1, 1280, 8, 8), 32, torch.bfloat16),
    ((2, 128, 32, 32), 32, torch.bfloat16), ((1, 512, 16, 16), 32, torch.bfloat16),
    ((3, 96, 7, 5), 32, torch.bfloat16), ((2, 36, 5, 7), 4, torch.bfloat16), ((2, 64, 3, 3), 32, torch.float32),
]


def _gn_inputs(shape, dtype):
    g = torch.Generator().manual_seed(shape[1] * shape[2])
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g)).to(dtype)
    return x, w, b


def _plain_gn_variant(x, groups, w, b, fault):
    """(y, y with SiLU, mean, inv) of ``group_norm_reference`` in x's dtype,
    or of a copy with one fault: the last quarter of N left out of the
    statistics, the group boundary one channel on, the SiLU dropped, or
    y × 1.01."""
    bsz, c = x.shape[:2]
    x3 = x.reshape(bsz, c, -1)
    if fault == "part of N dropped":
        s, ss = tnorms.group_norm_stats_reference(x3[:, :, : x3.shape[-1] * 3 // 4].contiguous())
        n = (x3.shape[-1] * 3 // 4) * (c // groups)
    else:
        s, ss = tnorms.group_norm_stats_reference(x)
        n = x3.shape[-1] * (c // groups)
    if fault == "boundary shifted":
        s, ss = s.roll(-1, 1), ss.roll(-1, 1)
    scale, shift, mean, inv = tnorms._gn_fold_stats(s, ss, w, b, groups, n, 1e-5, x.dtype)
    y = tnorms.group_norm_apply_reference(x, scale, shift)
    y_act = y if fault == "silu dropped" else tnorms.group_norm_apply_reference(x, scale, shift, "silu")
    if fault == "y x 1.01":
        y, y_act = ((t.float() * 1.01).to(x.dtype) for t in (y, y_act))
    return y, y_act, mean, inv


def _gn_want(x, groups, w, b):
    want = [tnorms.group_norm_reference(x.float(), groups, w.float(), b.float(), 1e-5, act)[0] for act in (None, "silu")]
    want64 = tnorms.group_norm_reference(x.double(), groups, w.double(), b.double(), 1e-5)[1:]
    return want, want64


@pytest.mark.parametrize("shape,groups,dtype", GN_CASES)
def test_plain_bf16_group_norm_sits_inside_the_gate(shape, groups, dtype):
    """Where ``GN_GATE`` comes from: the plain GroupNorm in x's dtype (the
    fold's scale and shift rounded to it, as JAX rounds them) against fp32
    from the same x, weight and bias, with and without SiLU, passes with a
    margin of 1.5× on the relative L2 (printed), its mean and inv within
    ``GN_STATS_REL`` of fp64; y × 1.01 fails."""
    x, w, b = _gn_inputs(shape, dtype)
    want, want64 = _gn_want(x, groups, w, b)
    stats = tnorms.group_norm_errors(_plain_gn_variant(x, groups, w, b, None), want, want64)
    ok, report = tnorms.group_norm_gate(stats)
    l2 = tnorms.GN_GATE[dtype][2]
    worst = max(stats["y"]["rel_l2"], stats["silu"]["rel_l2"])
    print(f"plain {stats['dtype']} group_norm rel L2 {stats['y']['rel_l2']:.3e}, with SiLU "
          f"{stats['silu']['rel_l2']:.3e} (tol {l2}, margin {l2 / max(worst, 1e-12):.1f}x) at {shape}: {report}")
    assert ok and worst * 1.5 <= l2, report
    faulty = tnorms.group_norm_errors(_plain_gn_variant(x, groups, w, b, "y x 1.01"), want, want64)
    assert not tnorms.group_norm_gate(faulty)[0]


@pytest.mark.parametrize("fault", [None, "part of N dropped", "boundary shifted", "silu dropped", "y x 1.01"])
def test_group_norm_gate_catches_faults(fault):
    """The four GroupNorm faults of ``gate_mutants.py`` in the plain
    version: each fails at least one of the card's kinds of case, y × 1.01
    every case, and the plain version none."""
    verdicts = []
    for shape, groups, dtype in GN_CASES:
        x, w, b = _gn_inputs(shape, dtype)
        want, want64 = _gn_want(x, groups, w, b)
        stats = tnorms.group_norm_errors(_plain_gn_variant(x, groups, w, b, fault), want, want64)
        verdicts.append(tnorms.group_norm_gate(stats)[0])
    if fault is None:
        assert all(verdicts), verdicts
    elif fault == "y x 1.01":
        assert not any(verdicts), verdicts
    else:
        assert not all(verdicts), verdicts


# (C, element bytes) of every LayerNorm of the paths: the UNets' bf16 widths,
# Pixart's 1152, CLIP-L's and bigG's fp32 768 and 1280
LN_PATH_WIDTHS = [(320, 2), (640, 2), (1280, 2), (1152, 2), (768, 4), (1280, 4)]


@pytest.mark.parametrize("c,elem", LN_PATH_WIDTHS)
def test_layer_norm_plan_keeps_every_lane_busy_at_the_paths_widths(c, elem):
    """K3's lanes a row times packs a lane cover each path width exactly in
    16-byte packs (no idle lane), with a built pack count."""
    tpr, ppt = tnorms.layer_norm_plan(c, elem, True)
    assert tpr in (8, 16, 32) and ppt in tnorms.LN_PPT and tpr * ppt * (16 // elem) == c


@pytest.mark.parametrize("c,elem,vec,want", [
    (100, 2, False, (32, 4)), (37, 4, False, (32, 2)), (96, 2, True, (32, 1)), (8192, 2, True, (32, 0)),
    (1000, 2, False, (32, 0)), (4096, 2, True, (32, 16)),
])
def test_layer_norm_plan_covers_other_widths(c, elem, vec, want):
    """Widths off the exact covers take 32 lanes of the least built count
    that covers the row; past 16 packs a lane, the wide kernel (0)."""
    tpr, ppt = tnorms.layer_norm_plan(c, elem, vec)
    assert (tpr, ppt) == want
    packs = c // (16 // elem) if vec else c
    assert ppt == 0 or tpr * ppt >= packs


# every GroupNorm of the paths (batch 4; the training UNet also at batch 8):
# [C, H, W] and the plan the channels-last layout takes (the paths' layout)
GN_PATH_SHAPES = [
    ((320, 64, 64), "resident"), ((640, 32, 32), "resident"), ((1280, 16, 16), "resident"),
    ((1280, 8, 8), "resident"), ((320, 128, 128), "stream"), ((640, 64, 64), "resident"),
    ((1280, 32, 32), "resident"), ((512, 64, 64), "resident"), ((512, 128, 128), "resident"),
    ((512, 256, 256), "stream"), ((256, 256, 256), "stream"), ((256, 512, 512), "stream"),
    ((128, 512, 512), "stream"), ((512, 512, 512), "stream"), ((256, 1024, 1024), "stream"),
    ((128, 1024, 1024), "stream"),
]


@pytest.mark.parametrize("chw,kind", GN_PATH_SHAPES)
def test_group_norm_plans_follow_n_c_g_layout_and_dtype_not_the_batch(chw, kind):
    """Both plan functions choose by N, C, G, the layout and the dtype: the
    same plan at batch 1, 4 and 8, in each layout and dtype; the paths'
    channels-last GroupNorms take the resident plan where a slice fits a
    cluster (the UNets' levels but SDXL's 128² one, the VAE's 64² and 128²
    levels), else two launches; a resident block fits the shared-memory
    limit."""
    for nhwc in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            plans = {tnorms.group_norm_plan((b, *chw), 32, nhwc, dtype) for b in (1, 4, 8)}
            assert len(plans) == 1, plans
            got, plan = plans.pop()
            if got == "resident":
                assert plan.cluster in tnorms.GN_CLUSTERS and plan.smem <= 232448
            else:
                assert plan == tnorms.gn_stream_plan(chw[1] * chw[2], nhwc)
                assert plan.parts <= tnorms.GN_MAX_PARTS
    assert tnorms.group_norm_plan((4, *chw), 32, True, torch.bfloat16)[0] == kind


@pytest.mark.parametrize("n,nhwc,want", [
    (1, False, (8, 1)), (4099, False, (520, 1)), (512 * 512, False, (32768, 1)),
    (1024 * 1024, False, (131072, 1)), (4096, True, (512, 8)), (1000, True, (512, 2)), (256 * 256, True, (2048, 32)),
    (1024 * 1024, True, (32768, 32)),
])
def test_stream_plan_splits_n_by_n_and_layout(n, nhwc, want):
    """The statistics kernel's split: an NCHW row to one block's 8 warps in
    chunks of whole packs; GN_NHWC_ROWS rows a part, longer parts past
    GN_MAX_PARTS."""
    assert tuple(tnorms.gn_stream_plan(n, nhwc)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_reference_in_kernel_order_matches_jax(jax_ref, dtype):
    """The kernels' fold in plain PyTorch (each group's channel sums added in
    channel order) against JAX ``_gn_fold_stats`` on the same channel sums,
    and the GroupNorm it makes (plain statistics, this fold, the plain
    apply) against JAX ``group_norm``, at a tiny size: fp32 to 1e-6
    relative, 1e-5 on y; bf16 within one bf16 ulp on the scale and shift
    (the fp32 sums may round the other way once) and 2⁻⁷·|y| + 2⁻⁷ on y."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(21)
    b, hw, c, g = 2, 5 * 6, 64, 8
    x = (rng.standard_normal((b, 5, 6, c)) * 2 + 0.5).astype(np.float32)
    w, bias = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    wt, bt = torch.from_numpy(w).to(dtype), torch.from_numpy(bias).to(dtype)
    s, ss = tnorms.group_norm_stats_reference(xt)
    got = tnorms.group_norm_fold_reference(s, ss, wt, bt, g, hw * (c // g), 1e-5, dtype)
    want = jnorms._gn_fold_stats(jnp.asarray(s.numpy()), jnp.asarray(ss.numpy()), jnp.asarray(wt.float().numpy()).astype(jdt),
                                 jnp.asarray(bt.float().numpy()).astype(jdt), b, c, g, hw * (c // g), 1e-5, jdt)
    for t, j in zip(got, want):
        t, j = t.float().numpy(), np.asarray(j, dtype=np.float32)
        if dtype == torch.float32 or t.shape == (b, g):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_less(np.abs(t - j), np.abs(j) * 2**-7 + 1e-30)
    y = tnorms.group_norm_apply_reference(xt, got[0], got[1], "silu").permute(0, 2, 3, 1).float().numpy()
    jy = np.asarray(jnorms.group_norm(jnp.asarray(xt.permute(0, 2, 3, 1).float().numpy()).astype(jdt), g,
                                      jnp.asarray(wt.float().numpy()).astype(jdt),
                                      jnp.asarray(bt.float().numpy()).astype(jdt), 1e-5, act="silu"), dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_less(np.abs(y - jy), np.abs(jy) * 2**-7 + 2**-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_cpu_group_norm_output_unchanged(dtype, act):
    """On the CPU ``group_norm`` is the plain statistics, JAX's fold (the
    group sums as ``sum`` takes them) and the plain apply, bit for bit as
    before the kernels' fold existed; ``group_norm_forward`` returns its
    mean and inv."""
    g = torch.Generator().manual_seed(22)
    x = (torch.randn(2, 64, 5, 7, generator=g) * 2 + 0.5).to(dtype)
    w, b = (1 + 0.1 * torch.randn(64, generator=g)).to(dtype), (0.1 * torch.randn(64, generator=g)).to(dtype)
    xf = x.reshape(2, 64, -1).float()
    s, ss = xf.sum(-1), (xf * xf).sum(-1)
    n = 35 * 2
    mean = s.reshape(2, 32, -1).sum(-1) / n
    inv = torch.rsqrt(torch.clamp(ss.reshape(2, 32, -1).sum(-1) / n - mean * mean, min=0.0) + 1e-5)
    mean_c, inv_c = mean.repeat_interleave(2, dim=1), inv.repeat_interleave(2, dim=1)
    scale = (inv_c * w.float()[None]).to(dtype)
    shift = (b.float()[None] - mean_c * inv_c * w.float()[None]).to(dtype)
    want = x.reshape(2, 64, -1) * scale[:, :, None] + shift[:, :, None]
    want = (torch.nn.functional.silu(want) if act else want).reshape(x.shape)
    before = dict(tnorms.LAUNCHES)
    y, got_mean, got_inv = tnorms.group_norm_forward(x, 32, w, b, 1e-5, act)
    assert torch.equal(y, want) and torch.equal(tnorms.group_norm(x, 32, w, b, 1e-5, act=act), want)
    assert torch.equal(got_mean, mean) and torch.equal(got_inv, inv) and dict(tnorms.LAUNCHES) == before


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,channels_last", [
    (s, g, d, cl) for s, g, d in [((1, 320, 64, 64), 32, torch.bfloat16), ((2, 1280, 8, 8), 32, torch.bfloat16),
                                  ((1, 512, 128, 128), 32, torch.bfloat16), ((1, 128, 512, 512), 32, torch.bfloat16),
                                  ((3, 96, 37, 29), 32, torch.bfloat16), ((2, 36, 5, 7), 4, torch.bfloat16),
                                  ((2, 64, 9, 9), 32, torch.float32), ((2, 512, 16, 16), 32, torch.float32)]
    for cl in (False, True)])
def test_group_norm_matches_plain_on_card(cuda, shape, groups, dtype, channels_last):
    """The whole ``group_norm`` (statistics, fold, apply; SiLU or not) held
    to ``group_norm_gate`` against the plain version in fp32 from the same
    x, weight and bias, mean and inv against fp64; y in x's layout."""
    x, w, b = (t.to(cuda) for t in _gn_inputs(shape, dtype))
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    y, mean, inv = tnorms.group_norm_forward(x, groups, w, b, 1e-5)
    y_act = tnorms.group_norm(x, groups, w, b, 1e-5, act="silu")
    torch.cuda.synchronize()
    assert y.stride() == x.stride() and y_act.stride() == x.stride()
    want, want64 = _gn_want(x, groups, w, b)
    ok, report = tnorms.group_norm_gate(tnorms.group_norm_errors((y, y_act, mean, inv), want, want64))
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype,scale", [
    (4 * 4096, 320, torch.bfloat16, 2.0), (4 * 1024, 640, torch.bfloat16, 2.0), (4 * 64, 1280, torch.bfloat16, 2.0),
    (4 * 4096, 1152, torch.bfloat16, 2.0), (4 * 77, 768, torch.float32, 2.0), (4 * 77, 1280, torch.float32, 2.0),
    (1001, 320, torch.bfloat16, 3e-3), (4 * 77, 1280, torch.float32, 3e-3), (37, 100, torch.bfloat16, 2.0),
    (5, 8200, torch.bfloat16, 2.0),
])
def test_layer_norm_kernel_at_the_paths_widths_on_card(cuda, rows, c, dtype, scale):
    """K3 at every width of the paths (Pixart's 1152 and bigG's fp32 1280
    included), rows of small variance, one-element packs and the wide
    kernel, held to ``layer_norm_gate``; one launch a call, and a row's
    bits alone equal to the same row among all."""
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (torch.randn(rows, c, generator=g, device=cuda) * scale + (0.5 if scale > 1 else 0.0)).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    n = tnorms.LAUNCHES["layer_norm"]
    y = tnorms.layer_norm(x, w, b)
    alone = tnorms.layer_norm(x[rows // 2:rows // 2 + 1], w, b)
    torch.cuda.synchronize()
    assert tnorms.LAUNCHES["layer_norm"] == n + 2
    ok, report = tnorms.layer_norm_gate(tnorms.layer_norm_errors(y, tnorms.layer_norm_reference(x.float(), w.float(),
                                                                                               b.float())))
    assert ok, report
    assert torch.equal(alone[0], y[rows // 2])


# (shape, layout): both plans in both layouts, and the streaming plan's
# scalar loads (N off the 16-byte step)
GN_EXACT_CASES = [
    ((4, 320, 64, 64), False), ((4, 320, 64, 64), True), ((4, 320, 128, 128), True), ((4, 256, 256, 256), False),
    ((4, 512, 256, 256), False), ((4, 512, 256, 256), True), ((3, 96, 37, 29), False), ((3, 96, 37, 29), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,channels_last", GN_EXACT_CASES)
def test_group_norm_bit_equal_alone_batched_and_run_to_run_on_card(cuda, shape, channels_last):
    """Under either plan a sample's y, mean and inv are the same bits alone,
    at any slot of its batch, and from run to run (splits by N, C, G, the
    layout and the dtype only; fixed orders; no atomics on a sum)."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    w = (1 + 0.1 * torch.randn(shape[1], generator=g, device=cuda)).to(torch.bfloat16)
    b = (0.1 * torch.randn(shape[1], generator=g, device=cuda)).to(torch.bfloat16)
    y, mean, inv = tnorms.group_norm_forward(x, 32, w, b, 1e-5, "silu")
    again = tnorms.group_norm_forward(x, 32, w, b, 1e-5, "silu")
    assert all(torch.equal(u, v) for u, v in zip((y, mean, inv), again))
    for i in range(shape[0]):
        alone = tnorms.group_norm_forward(x[i:i + 1], 32, w, b, 1e-5, "silu")
        assert torch.equal(alone[0][0], y[i]) and torch.equal(alone[1][0], mean[i]) and torch.equal(alone[2][0], inv[i])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,channels_last,launches", [
    ((4, 320, 64, 64), True, 1), ((4, 640, 32, 32), False, 1), ((4, 512, 256, 256), True, 2),
    ((4, 128, 512, 512), False, 2),
])
def test_group_norm_launches_only_the_ports_kernels_on_card(cuda, shape, channels_last, launches):
    """A GroupNorm forward on the card runs the port's kernels only: one
    under the resident plan, two under the streaming plan, and no plain
    PyTorch kernel between them (the profiler's kernels, after a first call
    that allocates the arrival counters)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(shape, device=cuda).to(torch.bfloat16)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    w, b = torch.ones(shape[1], device=cuda, dtype=torch.bfloat16), torch.zeros(shape[1], device=cuda,
                                                                               dtype=torch.bfloat16)
    tnorms.group_norm(x, 32, w, b, act="silu")
    torch.cuda.synchronize()
    before = dict(tnorms.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tnorms.group_norm(x, 32, w, b, act="silu")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert len(names) == launches and all("gn_" in name for name in names), names
    counted = {k: tnorms.LAUNCHES[k] - before[k] for k in before}
    want = ({"group_norm_fused": 1} if launches == 1 else {"group_norm_stats": 1, "group_norm_apply": 1})
    assert {k: v for k, v in counted.items() if v} == want
