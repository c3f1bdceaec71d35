"""Profile one warm ``generate``, or one warm training step, on the card:
time by stage and by kernel.

    python -m flash_diffusion_tpu_torch.profiling [--model sd15|sdxl|pixart|sd3] [--batch 4] [--int8] [--t5]
        [--trace trace.json]
    python -m flash_diffusion_tpu_torch.profiling --train [--model sd15|sdxl|pixart|sd3|sd15-canny] [--batch n]

Builds the pipeline as ``sample.build_pipeline(model)`` does (random bf16
weights; SD1.5 at 512², SDXL, Pixart-α and SD3 at 1024²; ``--t5``: SD3
with T5-XXL; with ``--int8`` switched to the W8A8
int8 mode, ``FlashPipeline.quantize("int8")``, the counterpart of the JAX
``bench.py --int8``), runs ``generate`` once to warm up, then once under
``torch.profiler``; with ``--train``, the trainer as
``train.build_trainer(model)`` builds it (the model's yaml: SD1.5
``flash_sd.yaml`` at 512², batch 4; SDXL ``flash_sdxl.yaml`` at 1024², batch
2; Pixart ``flash_pixart.yaml`` at 512², batch 4; SD3 ``flash_sd3.yaml`` at
1024², batch 2, with T5-XXL; SD1.5 with the Canny T2I-Adapter
``flash_canny_adapter.yaml`` at 512², batch 4, its synthetic batches with
their edge maps; every step in stage 1)
and one ``fit`` step on a synthetic batch of the yaml's size (``--batch``
overrides its batch) instead. Prints the
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
from .train import MODELS as TRAIN_MODELS
from .utils.profiling import kernel_category, kernel_id

_PROMPTS = ["a photograph of an astronaut riding a horse"]


# (label, the kernels it sums by their ``utils.profiling.kernel_id`` tag)
_ROUTES = (
    ("streaming forward (K2)", ("K2",)),
    ("packed streaming forward (K5)", ("K5",)),
    ("down-projection GEMM (K10)", ("K10",)),
    ("GEGLU down projection (K12)", ("K12",)),
    ("int8 GEMM (K11)", ("K11",)),
    ("one-shot forward (K1)", ("K1",)),
    ("packed one-shot forward (K4)", ("K4",)),
    ("one-shot backward (K8 + its reduce)", ("K8",)),
    ("attention backward pair (K6 + K7)", ("K6", "K7")),
    ("LayerNorm (K3)", ("K3",)),
    ("GroupNorm resident (K9 + fold + apply, one launch)", ("K9 fused",)),
    ("GroupNorm statistics (K9, + fold)", ("K9",)),
    ("GroupNorm apply", ("GN apply",)),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="sd15", choices=list(dict.fromkeys(MODELS + TRAIN_MODELS)))
    ap.add_argument("--batch", type=int, default=None, help="default 4; with --train the yaml's BATCH_SIZE")
    ap.add_argument("--int8", action="store_true", help="serve in the W8A8 int8 mode")
    ap.add_argument("--t5", action="store_true", help="sd3: add T5-XXL to the two CLIP towers")
    ap.add_argument("--train", action="store_true", help="profile a training step of --model instead")
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    if args.model not in (TRAIN_MODELS if args.train else MODELS):
        raise SystemExit(f"profile: {args.model!r} is a training configuration: add --train")
    if args.train:
        from . import train

        # the towers resident: a step alone, without an offload burst of 4
        # batches' encode and the towers' move inside the window
        cfg = {**train.load_config(train.CONFIGS[args.model]), "NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000],
               "TEXT_ENCODER_OFFLOAD": 0}
        batch, size = args.batch or cfg["BATCH_SIZE"], cfg["IMAGE_SIZE"]
        trainer = train.build_trainer(args.model, device="cuda", config=cfg)
        data = train.synthetic_batches(batch, size, model=args.model)
        run = lambda: trainer.fit(data, max_steps=trainer.step + 1)
        what = f"{args.model} training step, batch {batch}, {size}²"
    else:
        batch = args.batch or 4
        pipe = build_pipeline(args.model, device="cuda", t5=args.t5)
        if args.int8:
            pipe.quantize("int8")
        prompts = (_PROMPTS * batch)[:batch]
        run = lambda: pipe.generate(prompts)
        what = f"{args.model}{' + T5' if args.t5 else ''}{' int8' if args.int8 else ''}, batch {batch}, 4 steps"
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
        start = trainer.model.stage_schedules[1].timesteps.index(out["start_timestep"])
        what += f" (start timestep {out['start_timestep']}: {cfg['K'][1] - start} teacher forwards)"

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
        cats[kernel_category(e.key)] += e.self_device_time_total / 1e3
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:20s} {ms:9.2f} ms ({100 * ms / busy_ms:5.1f}% of device time)")
    for label, tags in _ROUTES:
        found = [e for e in kernels if kernel_id(e.key) in tags]
        if found:
            ms = sum(e.self_device_time_total for e in found) / 1e3
            print(f"  {label} {ms:9.2f} ms ({100 * ms / busy_ms:5.1f}% of device time), "
                  f"{sum(e.count for e in found)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


if __name__ == "__main__":
    main()
