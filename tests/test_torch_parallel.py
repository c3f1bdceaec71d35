"""The port's tensor parallelism (``parallel/``) against the JAX package.

Two gloo ranks on the CPU through ``parallel.spawn`` run the rank bodies
of ``tests/torch_parallel_workers.py``; JAX runs here alone. fp32, tiny
models whose heads and feed-forward widths split over two ranks:

- TP = 2 forwards of an SD1.5-shaped and an SDXL-shaped UNet (2 and 4
  heads), the DiT with its cross-attention mask bias, the MMDiT at a joint
  length masked by ``kv_valid``, CLIP and T5 (its relative-position bias
  sliced by heads) equal JAX's unsharded ``apply`` within 1e-4 relative
  L2 (fp32 sums in another order);
- the traps: GEGLU's halves split contiguously, and the row-parallel bias
  added on both ranks in the K10 mode, each move the UNet's output by far
  more than that tolerance; the K12 mode (bf16) sharded tracks it whole;
- ``tp_sharding_summary`` per family, and the leaves where the port's rule
  differs from JAX's ``tp_spec_for`` over the same leaves, each with its
  reason;
- a row-parallel layer's int8 codes, with the group's amax, bit-equal to
  the whole layer's codes and to those of JAX's ``int8_matmul``;
- a TP = 2 ``generate`` behind the server's ordered channel equals the
  unsharded one at the same seed, before and after a ``/loras`` load, and
  after its unload; int8 too; a bad adapter file is reported on every rank
  and leaves the server up; an error in rank 0's dispatch, or a ``/loras``
  load that fails on the follower only, stops the server and ends the run
  with an error;
- ``chip_smoke.py`` 15a's checks catch each of its planted TP faults on
  the tiny pipeline, and pass the sound run;
- a head count that does not split raises, and so does a torchrun rank
  with no card of its own.

One spawn serves many checks through module-scoped fixtures; each spawn
has a join timeout.
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from flash_diffusion_tpu_torch.parallel import SpawnError, initialize_distributed, spawn, tp_plan, tp_sharding_summary
from flash_diffusion_tpu_torch.utils import clip_text_from_jax, dit_from_jax, mmdit_from_jax, t5_from_jax, unet_from_jax

try:  # the JAX reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from flash_diffusion_tpu import models as jm
    from flash_diffusion_tpu import quant as jquant
    from flash_diffusion_tpu.models import mmdit as jmmdit
    from flash_diffusion_tpu.models import text_encoders as jte
    from flash_diffusion_tpu.ops import gemm as jgemm
    from flash_diffusion_tpu.parallel.tp import tp_spec_for
except ImportError:
    jax = None

torch.set_num_threads(2)
JOIN = 300  # seconds: the longest a spawn may take here
TOL = 1e-4  # relative L2, TP = 2 against JAX's unsharded forward
SEQ, CTX = 12, 20  # DiT caption tokens; MMDiT context tokens (16 + 20 = 36 of 128 joint keys valid)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def jax_net(kind):
    """(JAX module, a sample input set as numpy, the init's inputs)."""
    rng = np.random.default_rng(7)
    x = lambda *s: rng.standard_normal(s).astype(np.float32)
    if kind in ("unet15", "unetxl"):
        kw = W.UNET15_KW if kind == "unet15" else W.UNETXL_KW
        cond = {"crossattn": x(2, 8, 32)}
        if kind == "unetxl":
            cond["vector"] = x(2, 24)
        return jm.UNet2DCondition(jm.UNetConfig(**kw)), {"x": x(2, 16, 16, 4), "t": np.array([999, 259], np.int32),
                                                         "cond": cond}
    if kind == "dit":
        cond = {"crossattn": x(2, SEQ, 32), "vector": np.array([[64.0, 64.0, 1.0], [64.0, 96.0, 1.5]], np.float32),
                "attention_mask": np.array([[1] * 5 + [0] * (SEQ - 5), [1] * SEQ], np.int32)}
        return jm.DiT(jm.DiTConfig(**W.DIT_KW)), {"x": x(2, 8, 8, 4), "t": np.array([999.0, 259.0], np.float32),
                                                 "cond": cond}
    if kind == "mmdit":
        return jm.MMDiT(jmmdit.MMDiTConfig(**W.MMDIT_KW)), {
            "x": x(2, 8, 8, 16), "t": np.array([912.5, 250.0], np.float32),
            "cond": {"crossattn": x(2, CTX, 32), "vector": x(2, 24)}}
    if kind == "clip":
        ids = rng.integers(0, 99, (2, 16)).astype(np.int32)
        ids[0, 9], ids[1, 15] = 99, 99
        return jte.CLIPTextModel(jte.CLIPTextConfig(**W.CLIP_KW)), {"ids": ids}
    ids = np.array([[3, 7, 1, 9, 4, 4, 0, 0, 0, 0, 0, 0], [5, 2, 8, 8, 1, 6, 3, 2, 9, 7, 1, 1]], np.int32)
    return jte.T5Encoder(jte.T5Config(**W.T5_KW)), {"ids": ids, "mask": (ids > 0).astype(np.int32)}


def jax_apply(kind, net, params, inputs):
    if kind == "clip":
        return jax.jit(net.apply)(params, jnp.asarray(inputs["ids"]))["last_hidden_state"]
    if kind == "t5":
        return jax.jit(net.apply)(params, jnp.asarray(inputs["ids"]), jnp.asarray(inputs["mask"]))
    cond = {k: jnp.asarray(v) for k, v in inputs["cond"].items()}
    return jax.jit(net.apply)(params, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]), {"cond": cond})


def jax_params(kind, net, inputs, seed):
    """``net.init``'s tree filled from a numpy seed (kernels and embeddings
    N(0, 1/fan-in), biases 0, norm scales 1), then ``perturbed``: the
    shapes from ``jax.eval_shape``, so that no init is compiled or run."""
    first = lambda a: jnp.asarray(a[:1])
    if kind == "clip":
        args = (first(inputs["ids"]),)
    elif kind == "t5":
        args = (first(inputs["ids"]), first(inputs["mask"]))
    else:
        args = (first(inputs["x"]), first(inputs["t"]), {"cond": {k: first(v) for k, v in inputs["cond"].items()}})
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("bias", "scale"):
            return np.full(leaf.shape, float(name == "scale"), np.float32)
        fan_in = max(1, int(np.prod(leaf.shape[:-1])))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *args)
    return perturbed(jax.tree_util.tree_map_with_path(fill, shapes), seed + 1)


def to_port(kind, params):
    net = W.port_model(kind)
    convert = {"unet15": unet_from_jax, "unetxl": unet_from_jax, "dit": dit_from_jax, "mmdit": mmdit_from_jax,
               "clip": clip_text_from_jax, "t5": t5_from_jax}[kind]
    cfg = net.config
    return {k: t.contiguous() for k, t in convert(params, cfg).items()}


@pytest.fixture(scope="module")
def jax_models():
    """{kind: (JAX params, inputs, JAX's output)} of the six tiny models."""
    if jax is None:
        pytest.skip("needs the JAX reference package")
    out = {}
    for i, kind in enumerate(W.KINDS):
        net, inputs = jax_net(kind)
        params = jax_params(kind, net, inputs, i)
        out[kind] = (params, inputs, np.asarray(jax_apply(kind, net, params, inputs)))
    return out


@pytest.fixture(scope="module")
def int8_inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((37, 64)) * rng.uniform(0.1, 3, (37, 1))).astype(np.float32)
    x[5] = 0.0  # an all-zero token takes the 1e-8 floor
    x[6, 40] = 9.0  # a token whose amax lies on rank 1's half
    w = rng.standard_normal((48, 64)).astype(np.float32)
    w[7, 50] = 6.0  # a channel whose amax lies on rank 1's half
    return x, w


@pytest.fixture(scope="module")
def tp_run(jax_models, int8_inputs):
    """Rank 0's and rank 1's results of ``tp_forwards``."""
    models = {kind: (to_port(kind, params), inputs) for kind, (params, inputs, _) in jax_models.items()}
    return spawn(W.tp_forwards, 2, "gloo", args=(models, *int8_inputs), timeout=JOIN)


@pytest.mark.parametrize("kind", W.KINDS)
def test_tp_forward_matches_jax(jax_models, tp_run, kind):
    """Both ranks' TP = 2 outputs within 1e-4 relative L2 of JAX's."""
    want = jax_models[kind][2]
    for out in tp_run:
        got = out[kind].numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        assert rel_l2(got, want) <= TOL, (kind, rel_l2(got, want))


def test_geglu_halves_split_apart(jax_models, tp_run):
    """Each half of GEGLU's [value | gate] split on its own matches JAX; a
    contiguous split (rank 0 every value row, rank 1 every gate row) does
    not come near."""
    want = jax_models["unet15"][2]
    assert rel_l2(tp_run[0]["unet15"].numpy(), want) <= TOL
    assert rel_l2(tp_run[0]["geglu_contiguous"].numpy(), want) > 100 * TOL


def test_row_parallel_bias_added_once_in_k10_mode(jax_models, tp_run):
    """``FLASH_TPU_FFN_DOWN_GEMM=1``: rank 0 alone hands the bias to the
    down projection's epilogue, so the sum holds it once; on both ranks it
    would hold it twice."""
    want = jax_models["unet15"][2]
    assert rel_l2(tp_run[0]["k10"].numpy(), want) <= TOL
    assert rel_l2(tp_run[0]["k10_bias_twice"].numpy(), want) > 100 * TOL


def test_fused_geglu_mode_sharded_tracks_whole(tp_run):
    """``FLASH_TPU_FFN_FUSED=1`` in bf16: a rank's [a_r | g_r] and its K / 2
    down projection, summed, against the whole model in the same mode
    (bf16 sums in another order: 2e-2)."""
    got, want = (tp_run[0][k].float().numpy() for k in ("k12", "k12_whole"))
    assert rel_l2(got, want) <= 2e-2


# the leaves where the port's split differs from JAX's tp_spec_for, with why
RULE_DIFFERENCES = {
    r"(^|\.)proj_(in|out)\.weight$": (
        {"column", "row"}, "replicated",
        "the UNet's spatial-transformer projections: the residual and the GroupNorm need every channel; the "
        "DiT's and MMDiT's output proj_out: the unpatchify needs every channel"),
    r"(adaln_single|norm1|norm1_context|norm_out)\.linear\.weight$": (
        {"column"}, "replicated", "the adaLN modulations: every channel's shift, scale and gate reaches every token"),
    r"SelfAttention\.[qkv]\.weight$": (
        {"replicated"}, "column", "JAX's patterns miss T5's q/k/v (its o is row-parallel): the port splits the heads"),
    r"relative_attention_bias\.weight$": (
        {"replicated"}, "table", "T5's relative-position table splits by heads, so the bias it makes is the rank's"),
}


def port_kind(plan, key):
    name, _, leaf = key.rpartition(".")
    s = plan.get(name)
    return s.kind if s is not None and leaf == "weight" else "replicated"


@pytest.mark.parametrize("kind", W.KINDS)
def test_sharding_summary_and_the_rule_against_jax(jax_models, kind):
    """Leaf for leaf (a JAX tree of distinct constants carried through the
    family's converter), the port's split of each JAX kernel is JAX's
    ``tp_spec_for`` one, but where ``RULE_DIFFERENCES`` says why not; the
    summary counts the planned leaves."""
    params = jax_models[kind][0]
    flat = traverse_util.flatten_dict(params, sep="/")
    paths = sorted(flat)
    ids = traverse_util.unflatten_dict({p: np.full(flat[p].shape, i + 1, np.float32) for i, p in enumerate(paths)},
                                       sep="/")
    state = to_port(kind, ids)
    plan = tp_plan(W.port_model(kind), 2)
    differ, matched = [], set()
    for key, t in state.items():
        path = paths[int(t.reshape(-1)[0]) - 1]
        if not path.endswith("kernel") and "relative_attention_bias" not in path:
            continue
        spec = tp_spec_for(path, flat[path].shape, "model", 2)
        jax_kind = {("model", None): "row", (None, "model"): "column"}.get(tuple(spec), "replicated")
        ours = port_kind(plan, key)
        if ours != jax_kind:
            rule = next((r for r in RULE_DIFFERENCES if re.search(r, key)), None)
            assert rule is not None, f"{kind} {key} ({path}): JAX {jax_kind}, port {ours}, no reason given"
            assert jax_kind in RULE_DIFFERENCES[rule][0] and ours == RULE_DIFFERENCES[rule][1], (key, jax_kind, ours)
            differ.append(key)
            matched.add(rule)
    counts = tp_sharding_summary(W.port_model(kind), 2)
    params_n = sum(1 for _ in W.port_model(kind).parameters())
    assert sum(counts.values()) == params_n and counts["column"] > 0 and counts["row"] > 0
    assert counts["row"] == sum(1 for s in plan.values() if s.kind == "row")
    if kind in ("unet15", "unetxl", "dit", "mmdit"):
        assert any("proj_" in k for k in differ)
    if kind == "t5":
        assert matched == {r for r in RULE_DIFFERENCES if "SelfAttention" in r or "relative" in r}


def test_non_dividing_heads_raise():
    """3 heads (or a GEGLU of 3 × 2 rows a half) do not split over 2 ranks."""
    from flash_diffusion_tpu_torch.models import DiT, DiTConfig

    with pytest.raises(ValueError, match="3 heads do not split over 2 ranks"):
        tp_plan(DiT(DiTConfig(**{**W.DIT_KW, "num_heads": 3})), 2)
    with pytest.raises(ValueError, match="heads do not split over 4 ranks"):
        tp_plan(W.port_model("unet15"), 4)
    assert tp_plan(W.port_model("unetxl"), 4)  # 4 heads over 4


def test_int8_row_parallel_codes_bit_equal(tp_run, int8_inputs):
    """Each rank's K / 2 activation codes with the group's per-token amax
    (and its weight codes with the per-channel amax) are the whole
    layer's, bit for bit, and the whole layer's are JAX's ``int8_matmul``
    codes (captured at its kernel)."""
    for r, out in enumerate(tp_run):
        c = out["codes"]
        part = slice(32 * r, 32 * (r + 1))
        assert torch.equal(c["xq_r"], c["xq"][:, part]) and torch.equal(c["sx_r"], c["sx"])
        assert torch.equal(c["wq_r"], c["wq"][:, part]) and torch.equal(c["sw_r"], c["sw"])
    if jax is None:
        pytest.skip("needs the JAX reference package")
    x, _ = int8_inputs
    seen = {}

    def capture(xq, sx, *_):
        seen["xq"], seen["sx"] = np.asarray(xq), np.asarray(sx)
        return jnp.zeros((xq.shape[0], 8), jnp.bfloat16)

    eligible, kernel = jgemm.int8_gemm_eligible, jgemm.int8_gemm
    jgemm.int8_gemm_eligible, jgemm.int8_gemm = (lambda *_: True), capture
    try:
        jquant.int8_matmul(jnp.asarray(x), jnp.zeros((64, 8), jnp.int8), jnp.ones((8,), jnp.float32))
    finally:
        jgemm.int8_gemm_eligible, jgemm.int8_gemm = eligible, kernel
    np.testing.assert_array_equal(tp_run[0]["codes"]["xq"].numpy(), seen["xq"])
    np.testing.assert_array_equal(tp_run[0]["codes"]["sx"].numpy().reshape(-1), seen["sx"].reshape(-1))


def test_runtime_shard_batch_and_initialize(tp_run, monkeypatch):
    """``shard_batch``: each rank's rows of arrays and lists, scalars as
    they are, a batch that does not split raises; ``initialize_distributed``
    is a no-op without a launcher and takes no implicit backend."""
    for r, out in enumerate(tp_run):
        assert out["rows"]["a"].tolist() == [2 * r, 2 * r + 1] and out["rows"]["b"] == [2 * r + 1, 2 * r + 2]
        assert out["rows"]["s"] == 7 and "does not split over 2 ranks" in out["odd_batch"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is None
    with pytest.raises(ValueError, match="pass the backend explicitly"):
        initialize_distributed(init_method="file:///nonexistent")


def test_torchrun_rank_beyond_the_cards_raises(monkeypatch):
    """Under torchrun a ``LOCAL_RANK`` with no card of its own raises
    before the group forms: ranks share a card only through ``spawn``."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("the group formed"))
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card: this host has 1"):
        initialize_distributed("gloo")


# ---------------------------------------------------------------- serving
def write_lora(path) -> str:
    """A PEFT file of a rank-2 adapter of the tiny pipeline's denoiser."""
    from flash_diffusion_tpu_torch.lora import init_lora, save_peft_safetensors

    path = str(path)
    tree = init_lora(W.tiny_pipeline().denoiser, 2, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    for ab in tree.values():
        ab["b"].normal_(0.0, 0.05, generator=g)
    save_peft_safetensors(path, tree)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``tp_serving``: the tiny pipeline whole and behind a TP = 2 server."""
    path = write_lora(tmp_path_factory.mktemp("lora") / "adapter.safetensors")
    return spawn(W.tp_serving, 2, "gloo", args=(path,), timeout=JOIN)


def test_tp_generate_matches_unsharded(served):
    """A request served at TP = 2 equals ``generate`` of the whole pipeline
    at the same seed (fp32 sums in another order: 1e-4 relative L2; another
    seed's image differs by order 1)."""
    want, got = served[0]["want"], served[0]["got"]
    assert got["base"].shape == want["base"][0].shape
    assert rel_l2(got["base"], want["base"][0]) <= TOL


def test_loras_swap_through_the_ordered_channel(served):
    """``/loras`` load, then unload, through the channel: every rank swaps
    at the same dispatch boundary, so the next request equals the whole
    pipeline with (then without) the adapter; a missing file is reported
    and leaves the adapters as they were."""
    want, got = served[0]["want"], served[0]["got"]
    assert got["loras_load"] == {"adapters": {"default": 1.0}}
    assert rel_l2(got["lora"], want["lora"][0]) <= TOL
    assert rel_l2(want["lora"][0], want["base"][0]) > 100 * TOL  # the adapter moves the image
    assert got["bad_load"]["code"] == 400 and "adapter.safetensors.missing" in got["bad_load"]["error"]
    assert got["loras_unload"] == {"adapters": {}}
    assert rel_l2(got["unloaded"], want["base"][0]) <= TOL


def test_int8_generate_sharded_tracks_whole(served):
    """int8 at TP = 2 (codes and row-parallel weight scales with the
    group's amax) against int8 whole, on both ranks, each calling
    ``generate`` in lockstep."""
    for out in served:
        got, want = out["int8"]["tp"], out["int8"]["whole"]
        assert rel_l2(got, want) <= 1e-3, rel_l2(got, want)


def test_rank_error_stops_the_tp_server():
    """A dispatch that raises on rank 0: the request gets the error, the
    server stops, and the run ends with an error within the group's
    timeout instead of serving on out of step."""
    with pytest.raises(SpawnError, match="a fault in rank 0's denoiser"):
        spawn(W.tp_fatal, 2, "gloo", timeout=JOIN, group_timeout=10)


def test_loras_out_of_step_stops_the_tp_server(tmp_path):
    """A ``/loras`` load that works on rank 0 and fails on the follower
    leaves the ranks' weights apart: rank 0's server stops at once and the
    run ends with rank 0's error, as the follower's ``OutOfStep`` ends it."""
    path = write_lora(tmp_path / "adapter.safetensors")
    with pytest.raises(SpawnError, match=r"rank 0 raised:(.|\n)*the tensor-parallel server stopped: OutOfStep"):
        spawn(W.tp_loras_out_of_step, 2, "gloo", args=(path,), timeout=JOIN, group_timeout=10)


def test_chip_smoke_tp_checks_catch_each_planted_fault():
    """``chip_smoke.py`` 15a's checks on the tiny pipeline at TP = 2: the
    sound run passes (ranks bit-equal, latents within its bound of the
    request alone) and each planted fault (the bias on both ranks, a
    skipped row all-reduce) is caught."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ranks = spawn(W.tp_faults, 2, "gloo", args=(path,), timeout=JOIN)
    caught = {f: cs.tp_fault_caught(ranks[0]["faults"][f], ranks[1]["faults"][f], ranks[0]["alone"])
              for f in cs.TP_FAULTS}
    assert not caught["none"][0] and caught["none"][2] <= TOL, caught["none"]
    assert all(caught[f][0] for f in cs.TP_FAULTS[1:]), caught
