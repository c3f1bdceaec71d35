#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths, 4-step text-to-image sampling of SD1.5 at
512² and of SDXL at 1024², at full width and depth with random bf16 weights
made from a seed, and fails unless every phase passes:

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernels from ``flash_diffusion_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed);
2. kernels vs plain: each hand-written kernel against its plain PyTorch
   version at every shape either path gives it (bf16 kernel vs the plain
   version in fp32 on the same inputs), with ragged cases; max abs error
   against the stated tolerance, and kernel vs plain device time (CUDA
   events around 10 queued calls, median of 5 runs);
3. SD1.5 path: ``build_pipeline("sd15", device="cuda")`` then ``generate``
   of 4 prompts × 4 steps, guidance 0, 512²: the output must be
   [4, 512, 512, 3] and finite, and the launch counts of K1–K3, reset just
   before, must have grown; then warm wall time per batch and images/s;
4. SD1.5 reference: the same modules at 128² on one prompt, on the card in
   bf16 against a copy on the CPU in fp32 (the plain paths), with the same
   latents and step noise: CLIP must agree to 1e-4 and the images to a
   relative L2 error of 0.1;
3b. SDXL path, after the SD1.5 pipeline is freed: ``build_pipeline("sdxl",
   device="cuda")`` then ``generate`` of 4 prompts × 4 steps, guidance 0,
   1024²: [4, 1024, 1024, 3] and finite, and the launch counts of K2, K3 and
   K4, reset just before, must have grown; warm s/batch, images/s and peak
   memory;
4b. SDXL reference at 128² on one prompt, as phase 4: both CLIP outputs
   (crossattn and vector) to a relative L2 of 1e-4, the images to 0.1. The
   fp32 CPU copy is built from the modules' state dicts, parameter by
   parameter.

The second-to-last line of output is the card's name and power limit; the
line before it lists the kernels as JSON (``launches``: the count over both
paths' runs, ``launches_by_path`` each; ``ms``/``plain_ms``: sums over the
paths' shapes); the last line is ``{"ok": true, "device": {...}}``. Without
CUDA, or without the port beside this file, it exits non-zero and prints no
result.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import torch

# (bh, sq, skv, d, kv_valid) of every kernel attention call at batch 4,
# guidance 0, 512² (8 heads: BH = 32), plus ragged cases
ATTENTION_SHAPES = [
    (32, 4096, 4096, 40, None),  # UNet level-0 self-attention
    (32, 1024, 1024, 80, None),  # level-1 self-attention
    (32, 256, 256, 160, None),  # level-2 self-attention
    (32, 64, 64, 160, None),  # mid-block self-attention
    (32, 4096, 77, 40, None),  # cross-attention over the 77 text tokens
    (32, 1024, 77, 80, None),
    (32, 256, 77, 160, None),
    (32, 64, 77, 160, None),
    (4, 4096, 4096, 512, None),  # VAE mid-block, single head, D = C
]
ATTENTION_RAGGED = [
    (32, 1000, 1024, 80, 900), (32, 4000, 77, 40, 70), (4, 700, 4096, 512, 3000),
    (32, 4000, 4096, 40, 4001), (32, 300, 2000, 160, 1999),
]
# SDXL at batch 4, 1024²: the self-attention (10 heads at level 1, 20 at
# level 2 and mid; D = 64) and the VAE mid-block over 128² latents' 16384
# tokens
ATTENTION_SHAPES_XL = [
    (40, 4096, 4096, 64, None),
    (80, 1024, 1024, 64, None),
    (4, 16384, 16384, 512, None),
]
# (b, sq, kv, h, d) of the packed kernel: SDXL's cross-attention at level 1
# and at level 2 / mid (batch 4, 77 text tokens), plus ragged cases (Sq off
# the tile, KV 200 and 256, D = 128, batch 1, batch 8 as under CFG)
PACKED_SHAPES = [(4, 4096, 77, 10, 64), (4, 1024, 77, 20, 64)]
PACKED_RAGGED = [
    (4, 4000, 77, 10, 64), (4, 1024, 200, 20, 64), (2, 1000, 256, 10, 64),
    (2, 1024, 77, 8, 128), (1, 4000, 256, 8, 128), (1, 4096, 77, 10, 64),
    (8, 1024, 77, 20, 64),
]
# (rows, C, dtype): UNet norm1/2/3 at each level, CLIP-L (fp32), plus ragged
LAYER_NORM_SHAPES = [
    (4 * 4096, 320, torch.bfloat16),
    (4 * 1024, 640, torch.bfloat16),
    (4 * 256, 1280, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16),
    (4 * 77, 768, torch.float32),
]
LAYER_NORM_RAGGED = [(4 * 1024 + 3, 640, torch.bfloat16), (1001, 320, torch.bfloat16)]
# SDXL: UNet norm1/2/3 at levels 1 and 2 (bf16); CLIP-G and CLIP-L (fp32)
LAYER_NORM_SHAPES_XL = [
    (4 * 4096, 640, torch.bfloat16),
    (4 * 1024, 1280, torch.bfloat16),
    (4 * 77, 1280, torch.float32),
    (4 * 77, 768, torch.float32),
]
# tolerances, kernel (bf16) vs plain (fp32): attention out is rounded to
# bf16 and p is rounded to bf16 before p·v (|out| < 4: 2e-2); lse is fp32
# from exact bf16 products (5e-3); LayerNorm in bf16 differs by the output's
# one rounding (|y| < 8: 1/32), in fp32 by summation order (1e-4)
ATTN_OUT_TOL, ATTN_LSE_TOL = 2e-2, 5e-3
LN_TOL = {torch.bfloat16: 1 / 32, torch.float32: 1e-4}
PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a raccoon reading a book in a library",
    "a bowl of ramen, studio lighting",
    "a lighthouse on a cliff at dusk",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, queued behind a GPU sleep so that host launch overhead does not
    show; the median over ``reps`` such runs, divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of GPU cycles while the host queues the calls
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check_attention(attention, results):
    g = torch.Generator(device="cuda").manual_seed(0)
    for bh, sq, skv, d, kv_valid in ATTENTION_SHAPES + ATTENTION_SHAPES_XL + ATTENTION_RAGGED:
        q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, skv, skv))
        scale = d ** -0.5
        kind = attention.attention_plan(kv_valid or skv, d)[0]
        out, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.attention_bhsd_reference(
            q.float(), k.float(), v.float(), scale, kv_valid)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref_out, ref_lse
        ms = median_ms(lambda: attention.flash_attention_bhsd(q, k, v, scale, kv_valid))
        plain = median_ms(lambda: attention.attention_bhsd_reference(q, k, v, scale, kv_valid))
        print(f"attention {kind:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} "
              f"kv_valid={kv_valid}: max|out err| {err:.3e} (tol {ATTN_OUT_TOL}) "
              f"max|lse err| {lse_err:.3e} (tol {ATTN_LSE_TOL}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if not (err <= ATTN_OUT_TOL and lse_err <= ATTN_LSE_TOL):
            raise AssertionError(f"attention kernel disagrees with its plain version at {(bh, sq, skv, d, kv_valid)}")
        r = results[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (bh, sq, skv, d, kv_valid) in ATTENTION_SHAPES + ATTENTION_SHAPES_XL:
            r["ms"] += ms
            r["plain_ms"] += plain


def check_packed(attention, results):
    g = torch.Generator(device="cuda").manual_seed(2)
    for b, sq, kv, h, d in PACKED_SHAPES + PACKED_RAGGED:
        q, k, v = (torch.randn(b, s, h * d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, kv, kv))
        scale = d ** -0.5
        out = attention.flash_attention_packed(q, k, v, h, scale)
        torch.cuda.synchronize()
        ref = attention.attention_packed_reference(q.float(), k.float(), v.float(), h, scale)
        err = (out.float() - ref).abs().max().item()
        del ref
        ms = median_ms(lambda: attention.flash_attention_packed(q, k, v, h, scale))
        plain = median_ms(lambda: attention.attention_packed_reference(q, k, v, h, scale))
        print(f"attention flash_fwd_oneshot_packed b={b} sq={sq:4d} kv={kv:3d} h={h:2d} d={d:3d}: "
              f"max|out err| {err:.3e} (tol {ATTN_OUT_TOL}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if not err <= ATTN_OUT_TOL:
            raise AssertionError(f"packed attention kernel disagrees with its plain version at {(b, sq, kv, h, d)}")
        r = results["flash_fwd_oneshot_packed"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, sq, kv, h, d) in PACKED_SHAPES:
            r["ms"] += ms
            r["plain_ms"] += plain


def check_layer_norm(norms, results):
    g = torch.Generator(device="cuda").manual_seed(1)
    for rows, c, dtype in LAYER_NORM_SHAPES + LAYER_NORM_SHAPES_XL + LAYER_NORM_RAGGED:
        x = (torch.randn(rows, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
        w = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        y = norms.layer_norm(x, w, b)
        torch.cuda.synchronize()
        err = (y.float() - norms.layer_norm_reference(x.float(), w.float(), b.float())).abs().max().item()
        ms = median_ms(lambda: norms.layer_norm(x, w, b))
        plain = median_ms(lambda: norms.layer_norm_reference(x, w, b))
        print(f"layer_norm rows={rows:5d} C={c:4d} {str(dtype):14s}: max|err| {err:.3e} "
              f"(tol {LN_TOL[dtype]:.3e}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if not err <= LN_TOL[dtype]:
            raise AssertionError(f"LayerNorm kernel disagrees with its plain version at {(rows, c, dtype)}")
        r = results["layer_norm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (rows, c, dtype) in LAYER_NORM_SHAPES + LAYER_NORM_SHAPES_XL:
            r["ms"] += ms
            r["plain_ms"] += plain


def reset(counters):
    for d in counters:
        for k in d:
            d[k] = 0


def cpu_fp32_copy(module: torch.nn.Module, meta_module: torch.nn.Module) -> torch.nn.Module:
    """``meta_module`` (the same architecture, built on the meta device) on
    the CPU in fp32 with ``module``'s weights, copied tensor by tensor so
    that the host holds one fp32 copy and the card no second one."""
    meta_module.to_empty(device="cpu")
    target = meta_module.state_dict()
    for k, v in module.state_dict().items():
        target[k].copy_(v)
    return meta_module.float().eval()


def check_reference(pipe, model: str):
    """The pipeline's own modules at 128² on one prompt: bf16 on the card
    through the kernels vs an fp32 copy on the CPU through the plain paths."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.models.embedders import ConditionerWrapper
    from flash_diffusion_tpu_torch.sample import build_modules

    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("host memory (GiB) before the fp32 copy: " + " | ".join(free.splitlines()[:2]))
    with torch.device("meta"):
        unet, vae, conditioners, _, _ = build_modules(model)
    ref = FlashPipeline(
        cpu_fp32_copy(pipe.denoiser, unet),
        cpu_fp32_copy(pipe.conditioner, ConditionerWrapper(conditioners)),
        cpu_fp32_copy(pipe.vae, vae), pipe.tokenizer_fn, pipe.latent_shape,
    )
    ref.size_cond_fn = pipe.size_cond_fn
    g = torch.Generator().manual_seed(7)
    latents = torch.randn(1, 16, 16, 4, generator=g)
    noise = [torch.randn(1, 16, 16, 4, generator=g) for _ in range(4)]
    batch = dict(pipe.tokenizer_fn(PROMPTS[:1]))
    if pipe.size_cond_fn is not None:
        batch.update(pipe.size_cond_fn(1, 128, 128))
    with torch.inference_mode():
        c_dev, c_ref = pipe._embed(batch)["cond"], ref._embed(batch)["cond"]
    clip_errs = {k: ((c_dev[k].cpu() - v).norm() / v.norm()).item() for k, v in c_ref.items()}
    got = pipe.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128).cpu()
    want = ref.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128)
    img_err = ((got - want).norm() / want.norm()).item()
    errs = ", ".join(f"{k} {e:.3e}" for k, e in clip_errs.items())
    print(f"{model} reference at 128², 1 prompt: CLIP (fp32 on the card) rel L2 err {errs} (tol 1e-4); "
          f"images (bf16 on the card vs fp32 on the CPU) rel L2 err {img_err:.3e} (tol 0.1), "
          f"max|err| {(got - want).abs().max().item():.3e}")
    if not (max(clip_errs.values()) <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError(f"the card's {model} slice disagrees with the fp32 reference on a small input")


def run_path(pipe, model, hw, counters, card, required):
    """One main path through ``generate``: counts reset just before and read
    just after, the launched kernels checked, then warm s/batch."""
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=0)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: n for d in counters for k, n in d.items()}
    print(f"{model} generate (cold): {cold:.3f} s; launches {launches}")
    if tuple(images.shape) != (4, hw, hw, 3) or not torch.isfinite(images).all():
        raise AssertionError(f"bad {model} images: shape {tuple(images.shape)}, "
                             f"finite {torch.isfinite(images).all().item()}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {model} path never launched {missing}")
    warm = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=seed)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    per_batch = statistics.median(warm)
    print(f"{model} {hw}² 4-NFE batch 4 on {card}: warm {per_batch:.4f} s/batch (median of {warm}), "
          f"{4 / per_batch:.3f} images/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"image range [{images.min().item():.3f}, {images.max().item():.3f}]")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from flash_diffusion_tpu_torch.ops import attention, kernels, norms
    from flash_diffusion_tpu_torch.sample import build_pipeline

    # phase 1: device and build
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc {kernels.BUILD_INFO['seconds']:.2f} s "
          f"-> {kernels.BUILD_INFO['path']}")
    entry = ""
    for line in kernels.BUILD_INFO["log"].splitlines():  # ptxas -v: one report per kernel
        if "Compiling entry function" in line:
            name = re.search(r"(?<=\d)(flash_fwd_\w+?_kernel|layer_norm_kernel)(I\w+?E)?E", line)
            entry = name.group(1) + (name.group(2) or "") if name else line.split("'")[1]
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    for _, _, kv, d, _ in ATTENTION_SHAPES + ATTENTION_SHAPES_XL:  # the one-shot plan mirrors the kernel's layout
        kind, bq = attention.attention_plan(kv, d)
        kvp, dp = -(-kv // 16) * 16, -(-d // 16) * 16
        if kind == "flash_fwd_oneshot" and lib.fdt_attn_smem_bytes(bq, kvp, dp) != attention.smem_bytes(bq, kvp, dp):
            raise AssertionError(f"shared-memory plan and kernel layout disagree at kv={kv} d={d}")
    for _, _, kv, _, d in PACKED_SHAPES + PACKED_RAGGED:
        kvp = -(-kv // 16) * 16
        if lib.fdt_packed_smem_bytes(d, kvp) != attention.packed_smem_bytes(d, kvp):
            raise AssertionError(f"packed shared-memory plan and kernel layout disagree at kv={kv} d={d}")

    # phase 2: kernels vs plain at the main paths' shapes
    results = {
        "flash_fwd_oneshot": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/attention.cu",
                                  replaces="flash_diffusion_tpu/ops/attention.py:171"),
        "flash_fwd_stream": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/flash_fwd_mma.cu",
                                 replaces="flash_diffusion_tpu/ops/attention.py:85"),
        "layer_norm": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/layer_norm.cu",
                           replaces="flash_diffusion_tpu/ops/norms.py:317"),
        "flash_fwd_oneshot_packed": dict(
            route="cuda", source="flash_diffusion_tpu_torch/csrc/attention_packed.cu",
            replaces="flash_diffusion_tpu/ops/attention.py:292"),
    }
    for r in results.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    check_attention(attention, results)
    check_packed(attention, results)
    check_layer_norm(norms, results)
    torch.cuda.empty_cache()

    # phases 3 and 4: the SD1.5 path through the user's entry point, then
    # its agreement with the fp32 plain reference on a small input
    counters = (attention.LAUNCHES, norms.LAUNCHES)
    pipe = build_pipeline("sd15", device="cuda", seed=0)
    by_path = {"sd15": run_path(pipe, "sd15", 512, counters, card,
                                ("flash_fwd_oneshot", "flash_fwd_stream", "layer_norm"))}
    check_reference(pipe, "sd15")
    del pipe
    torch.cuda.empty_cache()

    # phases 3b and 4b: the SDXL path, then its reference
    pipe = build_pipeline("sdxl", device="cuda", seed=0)
    by_path["sdxl"] = run_path(pipe, "sdxl", 1024, counters, card,
                               ("flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed"))
    check_reference(pipe, "sdxl")

    for name, r in results.items():
        r["launches"] = sum(n[name] for n in by_path.values())
        r["launches_by_path"] = {path: n[name] for path, n in by_path.items()}
    print(json.dumps({"kernels": [{"name": n, **r} for n, r in results.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
