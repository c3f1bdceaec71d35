"""Profile one warm ``generate``, or one warm training step, on the card:
time by stage and by kernel.

    python -m flash_diffusion_tpu_torch.profiling [--model sd15|sdxl|pixart] [--batch 4] [--int8] [--trace trace.json]
    python -m flash_diffusion_tpu_torch.profiling --train [--batch 4]

Builds the pipeline as ``sample.build_pipeline(model)`` does (random bf16
weights; SD1.5 at 512², SDXL and Pixart-α at 1024²; with ``--int8`` switched to the W8A8
int8 mode, ``FlashPipeline.quantize("int8")``, the counterpart of the JAX
``bench.py --int8``), runs ``generate`` once to warm up, then once under
``torch.profiler``; with ``--train``, the SD1.5 trainer as
``train.build_trainer("sd15")`` builds it (``flash_sd.yaml``, every step in
stage 1) and one ``fit`` step on a synthetic 512² batch instead. Prints the
wall time, the device's busy share (summed kernel time over wall time; the
port runs on one stream), each stage's host time and device busy time (the
``record_function`` spans: ``fdt.encode``, ``fdt.denoise``, ``fdt.decode``
of ``FlashPipeline.generate``; ``fdt.train.*`` of the training step), and
the kernels with the most device time, and the device time and share of
the streaming attention forward (K2, both routes), the packed streaming
forward (K5), the down-projection GEMM (K10), the one-shot attention
forward (K1), the packed one-shot forward (K4), the one-shot backward
(K8, with the kernel that sums its partials), the streaming backward
(K6 + K7), the LayerNorm (K3) and the GroupNorm kernels (the resident one,
the statistics with the fold, the apply). Each stage's line counts the
kernels that start in its window (copies and fills excluded). The JAX
package's kernel switches (``FLASH_TPU_ATTN_PACKED``,
``FLASH_TPU_FFN_FUSED``, ``FLASH_TPU_FFN_DOWN_GEMM``) are read from the
environment, as everywhere in the port, and printed beside the result.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .sample import MODELS, build_pipeline

_PROMPTS = ["a photograph of an astronaut riding a horse"]


def _category(name: str) -> str:
    low = name.lower()
    for key, cat in (
        ("flash_fwd", "attention kernels"), ("flash_bwd", "attention kernels"),
        ("layer_norm_", "layer_norm kernel"), ("int8_gemm_kernel", "int8 gemm kernel"),
        ("gemm_sm90_kernel", "ffn gemm kernels"),
        ("gn_stats", "group_norm kernels"), ("gn_apply", "group_norm kernels"), ("gn_resident", "group_norm kernels"),
        ("fprop", "convolution"), ("conv", "convolution"), ("gemm", "gemm (linear)"),
        ("nvjet", "gemm (linear)"), ("cutlass", "gemm (linear)"),
        ("reduce", "reduction"), ("elementwise", "elementwise"), ("vectorized", "elementwise"),
        ("copy", "copy / layout"), ("cat", "copy / layout"),
    ):
        if key in low:
            return cat
    return "other"


def _packed(name: str) -> bool:
    """Whether a kernel is a packed [B, S, H·D] attention forward: an
    instantiation with kPacked = true (K4 of K1's kernel, K5 of K2's), or a
    kernel of its own (``flash_fwd_oneshot_packed_kernel``,
    ``flash_fwd_packed_kernel``), so that a tree of either kind profiles
    alike."""
    return ", true>" in name or "_packed_kernel" in name


def _geglu(name: str) -> bool:
    """Whether a kernel is K12: K10's kernel instantiated with kGeglu =
    true (``gemm_sm90_kernel<BN, kCluster, true>``)."""
    return "gemm_sm90_kernel" in name and ", true>" in name


# (label, the kernels it sums by name)
_ROUTES = (
    ("streaming forward (K2)", lambda n: ("flash_fwd_wgmma_kernel" in n or "flash_fwd_mma_kernel" in n)
     and not _packed(n)),
    ("packed streaming forward (K5)", lambda n: _packed(n) and ("flash_fwd_wgmma_kernel" in n
                                                                  or "flash_fwd_packed_kernel" in n)),
    ("down-projection GEMM (K10)", lambda n: "gemm_sm90_kernel" in n and not _geglu(n)),
    ("GEGLU down projection (K12)", _geglu),
    ("int8 GEMM (K11)", lambda n: "int8_gemm_kernel" in n),
    ("one-shot forward (K1)", lambda n: "flash_fwd_oneshot_kernel" in n and not _packed(n)),
    ("packed one-shot forward (K4)", lambda n: _packed(n) and "flash_fwd_oneshot" in n),
    ("one-shot backward (K8 + its reduce)", lambda n: "flash_bwd_oneshot" in n),
    ("attention backward pair (K6 + K7)", lambda n: "flash_bwd_dkv" in n or "flash_bwd_dq" in n),
    ("LayerNorm (K3)", lambda n: "layer_norm_" in n and "kernel" in n),
    ("GroupNorm resident (K9 + fold + apply, one launch)", lambda n: "gn_resident" in n),
    ("GroupNorm statistics (K9, + fold)", lambda n: "gn_stats" in n),
    ("GroupNorm apply", lambda n: "gn_apply" in n),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--int8", action="store_true", help="serve in the W8A8 int8 mode")
    ap.add_argument("--train", action="store_true", help="profile a training step of sd15 instead")
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    if args.train:
        from .train import DEFAULT_CONFIG, build_trainer, load_config, synthetic_batches

        cfg = {**load_config(DEFAULT_CONFIG), "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
        trainer = build_trainer("sd15", device="cuda", config=cfg)
        data = synthetic_batches(args.batch, 512)
        run = lambda: trainer.fit(data, max_steps=trainer.step + 1)
        what = f"sd15 training step, batch {args.batch}, 512²"
    else:
        pipe = build_pipeline(args.model, device="cuda")
        if args.int8:
            pipe.quantize("int8")
        prompts = (_PROMPTS * args.batch)[: args.batch]
        run = lambda: pipe.generate(prompts)
        what = f"{args.model}{' int8' if args.int8 else ''}, batch {args.batch}, 4 steps"
        on = [k for k in ("FLASH_TPU_ATTN_PACKED", "FLASH_TPU_FFN_FUSED", "FLASH_TPU_FFN_DOWN_GEMM")
              if os.environ.get(k, "0") == "1"]
        what += f", switches {' '.join(f'{k}=1' for k in on) or 'none'}"
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.train:
        what += f" (start timestep {out['start_timestep']})"

    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # Stage device time: the kernels that start inside the stage's window,
    # from its span's device-side start to the next span's (the last one's
    # to its own end). Summing the kernels the profiler links to the span
    # would miss the port's own kernels, which launch through ctypes, not
    # through a PyTorch op, and those launched from another thread (the
    # backward's, from autograd's).
    timeline = [e for e in prof.events() if on_device(e)]
    device_spans = {e.name: e.time_range for e in timeline if e.name.startswith("fdt.")}
    launches = [e.time_range for e in timeline if not e.name.startswith("fdt.")]
    kernel_starts = [e.time_range.start for e in timeline
                     if not e.name.startswith(("fdt.", "Memcpy", "Memset"))]
    order = sorted(device_spans, key=lambda name: device_spans[name].start)
    windows = {name: (device_spans[name].start, device_spans[nxt].start if nxt else device_spans[name].end)
               for name, nxt in zip(order, order[1:] + [None])}
    events = prof.key_averages()
    kernels = [
        e for e in events
        if e.self_device_time_total > 0 and on_device(e) and not e.key.startswith("fdt.")
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{torch.cuda.get_device_name(0)}: {what}, "
          f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in events:
        if e.key.startswith("fdt.") and not on_device(e):
            lo, hi = windows[e.key]
            stage_ms = sum(k.elapsed_us() for k in launches if lo <= k.start < hi) / 1e3
            count = sum(1 for t in kernel_starts if lo <= t < hi)
            print(f"  stage {e.key:21s} host {e.cpu_time_total / 1e3:9.2f} ms, "
                  f"device busy {stage_ms:9.2f} ms of a {(hi - lo) / 1e3:9.2f} ms span, {count} kernels")
    cats = defaultdict(float)
    for e in kernels:
        cats[_category(e.key)] += e.self_device_time_total / 1e3
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:20s} {ms:9.2f} ms ({100 * ms / busy_ms:5.1f}% of device time)")
    for label, takes in _ROUTES:
        found = [e for e in kernels if takes(e.key)]
        if found:
            ms = sum(e.self_device_time_total for e in found) / 1e3
            print(f"  {label} {ms:9.2f} ms ({100 * ms / busy_ms:5.1f}% of device time), "
                  f"{sum(e.count for e in found)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


if __name__ == "__main__":
    main()
