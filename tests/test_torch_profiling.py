"""The port's profiling library (``utils/profiling.py``), its trace ranking
(``trace_top.py``) and ``utils/tensor.py``.

- ``trace_top.rank`` on a synthetic chrome trace with the names the
  profiler gives the port's kernels (demangled, with template arguments):
  the collapse of repeated layers, each row's K-tag (K2 and K5 told apart
  by their template arguments before the names collapse), the long tail,
  and the ``fdt.*`` stages' device time; and on a ``torch.profiler`` trace
  of a tiny ``generate`` on the CPU (``profile``), which has no device
  activity: its host ops and stages; and the CLI's ``--parse``.
- ``StepTimer``: one reading a window, the first call starting the clock;
  ``device_memory_stats`` without a card; ``trace_annotation``'s span.
- ``utils/tensor.py`` against the JAX package's, exactly.
"""

import json
import logging

import numpy as np
import pytest
import torch

from flash_diffusion_tpu_torch import trace_top
from flash_diffusion_tpu_torch.utils import append_dims, extract_into_tensor, pad_to_multiple
from flash_diffusion_tpu_torch.utils.profiling import (
    StepTimer,
    device_memory_stats,
    kernel_category,
    kernel_id,
    profile,
    trace_annotation,
)
from test_torch_pipeline import tiny_port_pipeline

try:  # the JAX reference; absent where only the port is installed
    import jax.numpy as jnp

    from flash_diffusion_tpu.utils import tensor as jtensor
except ImportError:
    jnp = None

K2 = "void flash_fwd_wgmma_kernel<64, false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float, int)"
K5 = "void flash_fwd_wgmma_kernel<64, true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float, int)"
K11 = ("void (anonymous namespace)::int8_gemm_kernel<false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
       "float const*, float const*)")  # as the card's profiler names it
K11_SPLIT = "void int8_gemm_kernel<true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*)"
K12 = "void gemm_sm90_kernel<160, 4, true>(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*, int)"
EW = ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>, std::array<char*, 2ul> >"
      "(int, at::native::AbsFunctor<float>, std::array<char*, 2ul>)")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_execute_kernel__5x_cudnn"


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def span(name, ts, dur):
    return {"ph": "X", "cat": "gpu_user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def synthetic_trace():
    """A denoise span over K2, K5, K11 (both instantiations), K12 and
    elementwise passes, then a decode span over a conv and a copy; the
    host's op and span, which a device ranking leaves out."""
    ev = [span("fdt.denoise", 0.0, 900.0), span("fdt.decode", 1000.0, 500.0),
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0.0, "dur": 5000.0, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "fdt.denoise", "ts": 0.0, "dur": 900.0, "pid": 1, "tid": 1},
          {"ph": "i", "name": "marker", "ts": 3.0}]
    t = 10.0
    for name, dur, n in ((K2, 100.0, 2), (K5, 60.0, 1), (K11, 50.0, 3), (K11_SPLIT, 10.0, 2), (K12, 40.0, 1),
                         (EW, 5.0, 8)):
        for _ in range(n):
            ev.append(kernel(name, t, dur))
            t += dur + 1.0
    ev += [kernel(CONV, 1010.0, 200.0), kernel("Memcpy DtoH (Device -> Pageable)", 1300.0, 30.0, "gpu_memcpy")]
    return ev


def test_rank_collapses_tags_and_times_the_stages():
    r = trace_top.rank(synthetic_trace())
    rows = {(row.name, row.kernel): row for row in r.rows}
    assert r.on == "device"
    assert abs(r.total_ms - (200 + 60 + 150 + 20 + 40 + 40 + 200 + 30) / 1e3) < 1e-9
    assert rows[("flash_fwd_wgmma_kernel", "K2")].count == 2 and rows[("flash_fwd_wgmma_kernel", "K5")].count == 1
    k11 = rows[("int8_gemm_kernel", "K11")]  # both instantiations add up
    assert (k11.count, round(k11.ms, 6)) == (5, 0.17)
    assert rows[("gemm_sm90_kernel", "K12")].count == 1
    assert rows[("at::native::vectorized_elementwise_kernel", None)].count == 8
    assert (CONV, None) in rows and ("Memcpy DtoH", None) in rows
    assert [row.ms for row in r.rows] == sorted((row.ms for row in r.rows), reverse=True)
    assert abs(sum(row.share for row in r.rows) - 1.0) < 1e-9
    assert r.stages["fdt.denoise"][:2] == (pytest.approx(0.51), 17)  # every kernel from 10 to the decode's start
    assert r.stages["fdt.decode"] == (pytest.approx(0.23), 2, pytest.approx(0.5))


def test_parse_prints_the_top_and_the_long_tail(tmp_path, capsys, monkeypatch):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": synthetic_trace()}))
    ranking = trace_top.parse_trace(str(path), top=3)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("TOTAL device time 0.740 ms (19 launches)")
    assert "K2" in out[1] and "flash_fwd_wgmma_kernel" in out[1]
    assert "(long tail: 4 kernels)" in out[4]
    assert any("stage fdt.decode" in line for line in out)
    assert [row.kernel for row in ranking.rows[:3]] == ["K2", None, "K11"]
    monkeypatch.setattr("sys.argv", ["trace_top", "--parse", str(path), "--top", "2"])
    trace_top.main()  # the CLI reads the same file
    assert "(long tail: 5 kernels)" in capsys.readouterr().out


def test_kernel_ids_and_categories():
    """One mapping from the port's kernel names to K1–K12, shared by the
    ``profiling.py`` CLI and ``trace_top``."""
    names = {
        "void flash_fwd_oneshot_kernel<64, false>(Params)": "K1", K2: "K2",
        "void flash_fwd_mma_kernel<512>(float)": "K2", "void layer_norm_rows_kernel<8, 2>(int)": "K3",
        "void flash_fwd_oneshot_kernel<64, true>(Params)": "K4", K5: "K5",
        "void flash_bwd_dkv_kernel<64>(int)": "K6", "void flash_bwd_dq_kernel<64>(int)": "K7",
        "void flash_bwd_oneshot_kernel<160>(int)": "K8", "void gn_stats_nhwc_kernel<true>(int)": "K9",
        "void gn_resident_nhwc_kernel<4>(int)": "K9 fused", "void gn_apply_nchw_kernel(int)": "GN apply",
        "void gemm_sm90_kernel<160, 1, false>(int)": "K10", K11: "K11", K12: "K12", EW: None, CONV: None,
    }
    assert {n: kernel_id(n) for n in names} == names
    assert kernel_category(K11) == "int8 gemm kernel" and kernel_category(CONV) == "convolution"
    assert kernel_category(EW) == "elementwise"


def test_profile_of_a_tiny_generate_on_the_cpu(tmp_path, capsys):
    """``profile`` around a tiny ``generate`` writes a chrome trace; on the
    CPU it has no device activity, so ``trace_top`` ranks the host ops by
    their own time and finds the three stage spans."""
    pipe = tiny_port_pipeline()
    pipe.generate(["a"], seed=0)
    with profile(str(tmp_path)) as path:
        pipe.generate(["a"], seed=0)
    assert path == str(tmp_path / "trace.json")
    ranking = trace_top.parse_trace(path, top=10)
    assert ranking.on == "host" and ranking.rows and ranking.total_ms > 0
    assert {"fdt.encode", "fdt.denoise", "fdt.decode"} <= set(ranking.stages)
    names = {row.name for row in ranking.rows}
    assert any(n.startswith("aten::") for n in names)
    assert "TOTAL host time" in capsys.readouterr().out
    with profile(str(tmp_path / "again")) as path2, trace_annotation("fdt.mine"):
        torch.ones(3).sum()
    assert "fdt.mine" in trace_top.rank(json.load(open(path2))["traceEvents"]).stages


class _Trainer:
    device = torch.device("cpu")


def test_step_timer_windows(caplog, monkeypatch):
    """The first call starts the clock; then one reading every ``window``
    steps, the mean over the window, logged as s/step and steps/s."""
    clock = iter([0.0, 3.0, 3.0, 5.0, 5.0])  # start; window 1 read, restart; window 2 read, restart
    monkeypatch.setattr("flash_diffusion_tpu_torch.utils.profiling.time.perf_counter", lambda: next(clock))
    timer = StepTimer(window=2, name="unit")
    with caplog.at_level(logging.INFO, logger="flash_diffusion_tpu_torch.utils.profiling"):
        for step in range(5):
            timer(_Trainer(), {}, step)
    assert timer.history == [(2, 1.5), (4, 1.0)]
    assert [r.getMessage() for r in caplog.records] == ["unit step 2: 1.500s/step (0.67 steps/s)",
                                                          "unit step 4: 1.000s/step (1.00 steps/s)"]


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        stats = device_memory_stats()
        assert set(stats["cuda:0"]) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    else:
        assert device_memory_stats() == {}


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs the JAX reference package")


def test_tensor_utils_match_jax(jax_ref):
    rng = np.random.default_rng(0)
    table = rng.standard_normal(10).astype(np.float32)
    idx = np.array([3, 0, 9], np.int32)
    got = extract_into_tensor(torch.from_numpy(table), torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtensor.extract_into_tensor(
        jnp.asarray(table), jnp.asarray(idx), 4)))
    assert got.shape == (3, 1, 1, 1)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    assert append_dims(torch.from_numpy(x[0, 0]), 4).shape == jtensor.append_dims(jnp.asarray(x[0, 0]), 4).shape
    with pytest.raises(ValueError):
        append_dims(torch.from_numpy(x), 3)
    for multiple, axes, mode in ((4, (-2, -1), "constant"), (4, (1,), "constant"), (8, (0, -1), "constant"),
                                 (5, (-2, -1), "constant"), (4, (-2, -1), "reflect")):
        got, shape = pad_to_multiple(torch.from_numpy(x), multiple, axes, mode)
        want, jshape = jtensor.pad_to_multiple(jnp.asarray(x), multiple, axes, mode)
        assert tuple(shape) == tuple(jshape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
