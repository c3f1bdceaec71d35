"""Profile one warm ``generate`` on the card: time by stage and by kernel.

    python -m flash_diffusion_tpu_torch.profiling [--model sd15|sdxl] [--batch 4] [--trace trace.json]

Builds the pipeline as ``sample.build_pipeline(model)`` does (random bf16
weights; SD1.5 at 512², SDXL at 1024²), runs ``generate`` once to warm up,
then once under
``torch.profiler``. Prints the wall time, the device's busy share (summed
kernel time over wall time; the port runs on one stream), each stage's host
time and device busy time (``fdt.encode``, ``fdt.denoise``, ``fdt.decode``:
the ``record_function`` spans of ``FlashPipeline.generate``), and the
kernels with the most device time.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .sample import MODELS, build_pipeline

_PROMPTS = ["a photograph of an astronaut riding a horse"]


def _category(name: str) -> str:
    low = name.lower()
    for key, cat in (
        ("flash_fwd", "attention kernels"), ("layer_norm_kernel", "layer_norm kernel"),
        ("fprop", "convolution"), ("conv", "convolution"), ("gemm", "gemm (linear)"),
        ("nvjet", "gemm (linear)"), ("cutlass", "gemm (linear)"),
        ("reduce", "reduction"), ("elementwise", "elementwise"), ("vectorized", "elementwise"),
        ("copy", "copy / layout"), ("cat", "copy / layout"),
    ):
        if key in low:
            return cat
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=MODELS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    pipe = build_pipeline(args.model, device="cuda")
    prompts = (_PROMPTS * args.batch)[: args.batch]
    pipe.generate(prompts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(prompts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # Stage device time: the kernels that start inside the stage span's
    # device-side copy. Summing the kernels the profiler links to the span
    # would miss the port's own kernels, which launch through ctypes, not
    # through a PyTorch op.
    timeline = [e for e in prof.events() if on_device(e)]
    device_spans = {e.name: e.time_range for e in timeline if e.name.startswith("fdt.")}
    launches = [e.time_range for e in timeline if not e.name.startswith("fdt.")]
    events = prof.key_averages()
    kernels = [
        e for e in events
        if e.self_device_time_total > 0 and on_device(e) and not e.key.startswith("fdt.")
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{torch.cuda.get_device_name(0)}: {args.model}, batch {args.batch}, 4 steps, "
          f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in events:
        if e.key.startswith("fdt.") and not on_device(e):
            span = device_spans[e.key]
            stage_ms = sum(k.elapsed_us() for k in launches if span.start <= k.start < span.end) / 1e3
            print(f"  stage {e.key:12s} host {e.cpu_time_total / 1e3:9.2f} ms, "
                  f"device busy {stage_ms:9.2f} ms of a {span.elapsed_us() / 1e3:9.2f} ms span")
    cats = defaultdict(float)
    for e in kernels:
        cats[_category(e.key)] += e.self_device_time_total / 1e3
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:20s} {ms:9.2f} ms ({100 * ms / busy_ms:5.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


if __name__ == "__main__":
    main()
