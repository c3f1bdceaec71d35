#!/usr/bin/env python3
"""Device times of the redesigned kernels in two trees on one card, in turns.

    python3 kernel_times.py --base DIR [--order base,this,this,base] [--kernels k1,k2,k3,k4,k5,k8,k9,k10,k11,k12] [--sweep]

For each tree of ``--order`` in turn (``this``: the checkout; ``base``:
another checkout of the repo, such as a parent commit unpacked with ``git
archive``), one process imports that tree's port and its own
``chip_smoke.py`` and runs its phase-2 checks with timing (CUDA events
around 10 queued calls, median of 5, beside the plain version, the
library call and the bound), cut to the main-path shapes of the kernels
asked for:

- ``k1``: ``check_attention`` at the ``ATTENTION_SHAPES`` that take K1
  (the one-shot forward);
- ``k2``: ``check_attention`` at every ``ATTENTION_SHAPES*`` shape that
  takes K2 (the streaming forward: SD1.5, SDXL, Pixart, the VAE);
- ``k4``: ``check_packed`` at ``PACKED_SHAPES`` (the packed one-shot
  forward: SDXL's cross-attention);
- ``k5``: ``check_packed`` at ``PACKED_STREAM_SHAPES`` (the packed
  streaming forward: SDXL's self-attention under
  ``FLASH_TPU_ATTN_PACKED=1``);
- ``k8``: ``check_attention_bwd`` at the ``BWD_SHAPES`` that take K8;
- ``k10``: ``check_ffn_gemm`` at ``FFN_SHAPES`` and ``FFN_DW_SHAPES``
  (K12 at ``FFN_SHAPES`` comes along, the check's other kernel);
- ``k11``: ``check_int8_gemm`` at ``INT8_SHAPES`` (the int8 GEMM: every
  W8A8 product of SDXL's int8 serving);
- ``k12``: ``check_ffn_gemm`` at ``FFN_SHAPES`` (the GEGLU down
  projection under ``FLASH_TPU_FFN_FUSED=1``; K10 comes along);
- ``k3``: ``check_layer_norm`` at every ``LAYER_NORM_SHAPES*`` shape (the
  LayerNorm: SD1.5, SDXL, CLIP in fp32, Pixart);
- ``k9``: ``check_group_norm`` at ``GN_SHAPES``; the table takes the whole
  ``group_norm`` with SiLU in channels-last (K9's statistics, the fold and
  the apply: one launch or two), the paths' layout.

Each process builds that tree's kernels. With ``--sweep``, the checkout's
process also times K10 at every tile width it is built for (112, 128, 160,
224, 256) at those shapes, the sweep behind ``ops/gemm.py gemm_plan``; K4
at q tiles of 64 and 128 rows at ``PACKED_SHAPES``, the sweep behind
``ops/attention.py packed_oneshot_tile``; K11 at each built plan
(persistent, and splits of K 2, 4, 8 where they divide its steps) at
``INT8_SHAPES``, the sweep behind ``ops/gemm.py int8_gemm_plan``, and the
host's time of one K11 launch (the wrapper, and the C call alone, which
encodes the two tensor maps); K12 at its built (width, cluster) at
``FFN_SHAPES``, the sweep behind ``ops/gemm.py geglu_gemm_plan``; the
whole GroupNorm with SiLU under the streaming plan and, where a slice fits
a cluster, the resident one, at ``GN_SHAPES`` in both layouts, the sweep
behind ``ops/norms.py gn_resident_plan`` (each for the kernels asked for). Prints each tree's lines and, last, a table of
kernel ms per shape and tree. Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def host_us(fn, calls=500):
    """Host time of one call, in µs: ``calls`` calls queued behind a GPU
    sleep long enough that none waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(calls * 2e5))  # ~100 µs of GPU cycles a call
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def sweep(cs, attention, gemm, kernels, which):
    """K10 at each built tile width, K4 at each q tile, K11 at each built
    plan (and the host's time of a launch), K12 at each built (width,
    cluster) and the whole GroupNorm under each plan, at their main-path
    shapes (this tree)."""
    import torch

    from flash_diffusion_tpu_torch.ops import norms

    lib = kernels.library()
    for shape in cs.GN_SHAPES if "k9" in which else []:
        for nhwc in (False, True):
            x = torch.randn(shape, device="cuda").to(torch.bfloat16)
            if nhwc:
                x = x.to(memory_format=torch.channels_last)
            b, c = shape[:2]
            w = torch.ones(c, device="cuda", dtype=torch.bfloat16)
            n = shape[2] * shape[3]
            resident = norms.gn_resident_plan(n, c, 32, nhwc, 2)
            mean, inv = torch.empty(b, 32, device="cuda"), torch.empty(b, 32, device="cuda")
            scale, shift = (torch.empty(b, c, device="cuda", dtype=torch.bfloat16) for _ in range(2))
            sums = torch.empty(2, b, c, device="cuda")

            def stream():
                norms._gn_stats_launch(x, nhwc, sums, (w, w, scale, shift, mean, inv), 32, 1e-5)
                return norms.group_norm_apply(x, scale, shift, "silu")

            line = f"sweep group_norm {shape} {'NHWC' if nhwc else 'NCHW'}: streaming {cs.median_ms(stream):.4f} ms"
            if resident is not None:
                y = torch.empty_like(x)
                run = lambda: kernels.check(lib.fdt_group_norm_resident(
                    x.data_ptr(), w.data_ptr(), w.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(), b, c, n, 32,
                    resident.cluster, resident.channels, resident.rows, 1, 1, int(nhwc), 1, 1e-5,
                    torch.cuda.current_stream().cuda_stream), "resident sweep")
                line += f", resident {cs.median_ms(run):.4f} ms ({resident})"
            print(line + f" <- plan {norms.group_norm_plan(shape, 32, nhwc, torch.bfloat16)[0]}")
    g = torch.Generator(device="cuda").manual_seed(9)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in cs.INT8_SHAPES if "k11" in which else []:
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(m, device="cuda") * 1e-3, torch.rand(n, device="cuda") * 1e-3
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        want = gemm.int8_gemm_plan(m, k, n, sms)
        steps = -(-k // 128)
        for split in [1] + [s for s in (2, 4, 8) if steps % s == 0]:
            run = lambda: kernels.check(lib.fdt_int8_gemm(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                                                          None, y.data_ptr(), m, n, k, 0, 0, split, stream()),
                                        "int8 sweep")
            print(f"sweep int8_gemm M={m:5d} K={k:4d} N={n:5d} split={split}: {cs.median_ms(run):.4f} ms"
                  f"{' <- plan' if want.split == split else ''}")
        if (m, k, n) == cs.INT8_SHAPES[0]:
            plan_call = lambda: lib.fdt_int8_gemm(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), None,
                                                  y.data_ptr(), m, n, k, 0, 0, 0, stream())
            print(f"host int8_gemm M={m} K={k} N={n}: wrapper {host_us(lambda: gemm.int8_gemm(xq, sx, wq, sw)):.2f} "
                  f"us a launch, the C call alone (plan, three tensor-map encodings, launch) {host_us(plan_call):.2f} us")
    for m, k, n in cs.FFN_SHAPES if "k12" in which else []:
        x = torch.randn(m, 2 * k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = torch.zeros(n, device="cuda", dtype=torch.bfloat16)
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        want = gemm.geglu_gemm_plan(k, n)
        variants = {(want.bn, want.cluster), (160, 1), (128, 1)} | {(160, c) for c in (2, 4, 8) if n // 160 % c == 0}
        for bn, cluster in sorted(variants):
            run = lambda: kernels.check(lib.fdt_geglu_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                           m, n, k, bn, cluster, stream()), "geglu sweep")
            held = (ctypes.c_int * 1)()
            kernels.check(lib.fdt_geglu_gemm_occupancy(bn, cluster, held), "geglu occupancy")
            print(f"sweep geglu_gemm M={m:5d} K={k:5d} N={n:4d} bn={bn} cluster={cluster}: {cs.median_ms(run):.4f} ms "
                  f"({held[0]} clusters held at once){' <- plan' if (want.bn, want.cluster) == (bn, cluster) else ''}")
    for b, sq, kv, h, d in cs.PACKED_SHAPES if "k4" in which else []:
        q, k, v = (torch.randn(b, s, h * d, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, kv, kv))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        for bq in (64, 128):
            run = lambda: kernels.check(lib.fdt_flash_fwd_oneshot_packed(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, kv, h, d, d ** -0.5, bq, stream),
                "K4 sweep")
            print(f"sweep flash_fwd_oneshot_packed b={b} sq={sq} kv={kv} h={h} d={d} bq={bq}: "
                  f"{cs.median_ms(run):.4f} ms{' <- plan' if attention.packed_oneshot_tile(kv, d) == bq else ''}")
    for m, k, n in cs.FFN_SHAPES + cs.FFN_DW_SHAPES if "k10" in which else []:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = torch.zeros(n, device="cuda", dtype=torch.bfloat16)
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        for bn in (112, 128, 160, 224, 256):
            run = lambda: kernels.check(lib.fdt_gemm_sm90(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                          m, n, k, bn, stream), "gemm sweep")
            ms = cs.median_ms(run)
            tiles = -(-m // 128) * -(-n // bn)
            print(f"sweep gemm M={m:5d} K={k:5d} N={n:4d} bn={bn}: {ms:.4f} ms ({tiles} tiles)"
                  f"{' <- plan' if gemm.gemm_plan(k, n).bn == bn else ''}")


def child(root: str, which: str, do_sweep: bool) -> None:
    sys.path.insert(0, root)  # that tree's port and chip_smoke before the checkout's
    import chip_smoke as cs
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels, norms

    kernels.library()
    print(f"card: {cs.card_line()}")
    fwd = lambda kind: [s for s in cs.ATTENTION_SHAPES + cs.ATTENTION_SHAPES_XL + cs.ATTENTION_SHAPES_PIXART
                        if attention.attention_plan(s[2], s[3])[0] == kind]
    shapes = {"k1": fwd("flash_fwd_oneshot") if "k1" in which else [],
              "k2": fwd("flash_fwd_stream") if "k2" in which else []}
    cs.ATTENTION_SHAPES = shapes["k1"] + shapes["k2"]
    cs.ATTENTION_SHAPES_XL, cs.ATTENTION_SHAPES_PIXART, cs.ATTENTION_RAGGED, cs.ATTENTION_V_SHIFTED = [], [], [], []
    names = ("flash_fwd_oneshot", "flash_fwd_stream", "flash_fwd_oneshot_packed", "flash_fwd_packed", "flash_bwd_dkv",
             "flash_bwd_dq", "flash_bwd_oneshot", "gemm", "geglu_gemm", "int8_gemm", "layer_norm", "group_norm_stats",
             "group_norm_apply", "group_norm_fused")
    results = {n: cs.new_row("cuda", "", "") for n in names}
    if cs.ATTENTION_SHAPES:
        cs.check_attention(attention, results)
    if "k4" in which:
        cs.check_packed(attention, results, "flash_fwd_oneshot_packed", cs.PACKED_SHAPES, [], 2)
    if "k5" in which:
        cs.check_packed(attention, results, "flash_fwd_packed", cs.PACKED_STREAM_SHAPES, [], 10)
    if "k8" in which:
        cs.BWD_SHAPES = [s for s in cs.BWD_SHAPES if attention.attention_bwd_plan(s[2], s[3])[0] == "flash_bwd_oneshot"]
        cs.BWD_RAGGED = []
        cs.check_attention_bwd(attention, kernels, results)
    if "k10" in which or "k12" in which:
        cs.FFN_RAGGED = []
        if "k10" not in which:
            cs.FFN_DW_SHAPES = []
        cs.check_ffn_gemm(gemm, results)
    if "k11" in which:
        cs.INT8_EXTRA = []
        cs.check_int8_gemm(gemm, results)
    if "k3" in which:
        cs.LAYER_NORM_RAGGED, cs.LAYER_NORM_SMALL_VAR = [], []
        cs.check_layer_norm(norms, results)
    if "k9" in which:
        cs.GN_RAGGED = []
        cs.check_group_norm(norms, results)
    if do_sweep:
        sweep(cs, attention, gemm, kernels, which)


def kernel_ms(lines):
    """{(kind, shape text): kernel ms} from the checks' printed lines."""
    out = {}
    for line in lines:
        whole = re.search(r"(?:whole group_norm\+SiLU |kernel )(\d+\.\d+) ms", line)
        if line.startswith("group_norm (") and " NHWC" in line and whole:  # the whole op, channels-last
            shape = re.search(r"group_norm (\([\d, ]+\))\s+(\w+)", line)
            out[("group_norm+silu NHWC", f"{shape.group(1)} {shape.group(2)}")] = float(whole.group(1))
            continue
        if line.startswith("layer_norm rows=") and "kernel " in line:
            shape = re.search(r"rows=\s*(\d+) C=\s*(\d+) (?:torch\.)?(\w+)", line)
            out[("layer_norm", f"rows={shape.group(1)} C={shape.group(2)} {shape.group(3)}")] = float(
                line.split("kernel ")[1].split(" ms")[0])
            continue
        if "kernel " not in line or " ms" not in line:
            continue
        words = line.split()
        if line.startswith("attention") and " b=" in line:  # the packed kernels
            kind, shape = words[1], line[line.index(" b=") + 1:line.index(":")]
        elif line.startswith("attention"):
            kind = words[2] if words[1] == "backward" else words[1]
            shape = line[line.index("bh="):line.index(" kv_valid")]
        elif words[0] in ("gemm", "geglu_gemm", "int8_gemm"):
            kind = words[0] + (" dW" if words[1] == "dW" else "")
            shape = line[line.index("M="):line.index(":")]
        else:
            continue
        out[(kind, " ".join(shape.split()))] = float(line.split("kernel ")[1].split(" ms")[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="root of the other tree")
    ap.add_argument("--order", default="base,this,this,base")
    ap.add_argument("--kernels", default="k1,k2,k3,k4,k5,k8,k9,k10,k11,k12")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep K10's tile width, K4's q tile, K11's, K12's and the GroupNorm's plans in this tree")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if args.child:
        return child(args.child, which, args.sweep)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA GPU")
    roots = {"this": str(ROOT), "base": str(Path(args.base).resolve()) if args.base else None}
    table, failed, swept = {}, False, False
    for i, tree in enumerate(args.order.split(",")):
        cmd = [sys.executable, __file__, "--child", roots[tree], "--kernels", args.kernels]
        if args.sweep and tree == "this" and not swept:
            cmd.append("--sweep")
            swept = True
        run = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[tree])
        print(f"== {tree} ({roots[tree]}), run {i}, rc {run.returncode}")
        print(run.stdout)
        if run.returncode:
            print(run.stderr[-3000:])
            failed = True
        for key, ms in kernel_ms(run.stdout.splitlines()).items():
            table.setdefault(key, {}).setdefault(tree, []).append(ms)
    for (kind, shape), by in table.items():
        print(f"{kind:17s} {shape:38s} " + "  ".join(f"{w} {' / '.join(f'{x:.4f}' for x in v)}" for w, v in by.items()))
    print(json.dumps({f"{k} {s}": by for (k, s), by in table.items()}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
