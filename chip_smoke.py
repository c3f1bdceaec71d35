#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, SD1.5 4-step text-to-image sampling at 512², at
full width with random bf16 weights made from a seed, and fails unless every
phase passes:

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernels from ``flash_diffusion_tpu_torch/csrc`` (timed);
2. kernels vs plain: each hand-written kernel against its plain PyTorch
   version at every shape the main path gives it (bf16 kernel vs the plain
   version in fp32 on the same inputs), with ragged cases; max abs error
   against the stated tolerance, and kernel vs plain device time (CUDA
   events around 10 queued calls, median of 5 runs);
3. main path: ``build_pipeline("sd15", device="cuda")`` then ``generate`` of
   4 prompts × 4 steps, guidance 0, 512²: the output must be [4, 512, 512, 3]
   and finite, and every kernel's launch count, reset just before, must have
   grown; then warm wall time per batch and images/s;
4. reference: the same modules at 128² on one prompt, on the card in bf16
   against a copy on the CPU in fp32 (the plain paths), with the same
   latents and step noise: CLIP must agree to 1e-4 and the images to a
   relative L2 error of 0.1.

The second-to-last line of output is the card's name and power limit; the
line before it lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port beside
this file, it exits non-zero and prints no result.
"""

import copy
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
# (rows, C, dtype): UNet norm1/2/3 at each level, CLIP-L (fp32), plus ragged
LAYER_NORM_SHAPES = [
    (4 * 4096, 320, torch.bfloat16),
    (4 * 1024, 640, torch.bfloat16),
    (4 * 256, 1280, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16),
    (4 * 77, 768, torch.float32),
]
LAYER_NORM_RAGGED = [(4 * 1024 + 3, 640, torch.bfloat16), (1001, 320, torch.bfloat16)]
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
    for bh, sq, skv, d, kv_valid in ATTENTION_SHAPES + ATTENTION_RAGGED:
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
        print(f"attention {kind:17s} bh={bh:2d} sq={sq:4d} kv={skv:4d} d={d:3d} "
              f"kv_valid={kv_valid}: max|out err| {err:.3e} (tol {ATTN_OUT_TOL}) "
              f"max|lse err| {lse_err:.3e} (tol {ATTN_LSE_TOL}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if not (err <= ATTN_OUT_TOL and lse_err <= ATTN_LSE_TOL):
            raise AssertionError(f"attention kernel disagrees with its plain version at {(bh, sq, skv, d, kv_valid)}")
        r = results[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (bh, sq, skv, d, kv_valid) in ATTENTION_SHAPES:
            r["ms"] += ms
            r["plain_ms"] += plain


def check_layer_norm(norms, results):
    g = torch.Generator(device="cuda").manual_seed(1)
    for rows, c, dtype in LAYER_NORM_SHAPES + LAYER_NORM_RAGGED:
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
        if (rows, c, dtype) in LAYER_NORM_SHAPES:
            r["ms"] += ms
            r["plain_ms"] += plain


def reset(counters):
    for d in counters:
        for k in d:
            d[k] = 0


def check_reference(pipe, FlashPipeline):
    """The pipeline's own modules at 128² on one prompt: bf16 on the card
    through the kernels vs an fp32 copy on the CPU through the plain paths."""
    cpu = dict(
        denoiser=copy.deepcopy(pipe.denoiser).float().cpu(),
        conditioner=copy.deepcopy(pipe.conditioner).float().cpu(),
        vae=copy.deepcopy(pipe.vae).float().cpu(),
    )
    ref = FlashPipeline(
        cpu["denoiser"], cpu["conditioner"], cpu["vae"], pipe.tokenizer_fn, pipe.latent_shape
    )
    g = torch.Generator().manual_seed(7)
    latents = torch.randn(1, 16, 16, 4, generator=g)
    noise = [torch.randn(1, 16, 16, 4, generator=g) for _ in range(4)]
    batch = pipe.tokenizer_fn(PROMPTS[:1])
    with torch.inference_mode():
        c_dev = pipe._embed(batch)["cond"]["crossattn"].cpu()
        c_ref = ref._embed(batch)["cond"]["crossattn"]
    clip_err = ((c_dev - c_ref).norm() / c_ref.norm()).item()
    got = pipe.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128).cpu()
    want = ref.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128)
    img_err = ((got - want).norm() / want.norm()).item()
    print(f"reference at 128², 1 prompt: CLIP (fp32 on the card) rel L2 err {clip_err:.3e} (tol 1e-4); "
          f"images (bf16 on the card vs fp32 on the CPU) rel L2 err {img_err:.3e} (tol 0.1), "
          f"max|err| {(got - want).abs().max().item():.3e}")
    if not (clip_err <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError("the card's slice disagrees with the fp32 reference on a small input")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from flash_diffusion_tpu_torch import FlashPipeline
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
    for _, _, kv, d, _ in ATTENTION_SHAPES:  # the one-shot plan mirrors the kernel's layout
        kind, bq = attention.attention_plan(kv, d)
        kvp, dp = -(-kv // 16) * 16, -(-d // 16) * 16
        if kind == "flash_fwd_oneshot" and lib.fdt_attn_smem_bytes(bq, kvp, dp) != attention.smem_bytes(bq, kvp, dp):
            raise AssertionError(f"shared-memory plan and kernel layout disagree at kv={kv} d={d}")

    # phase 2: kernels vs plain at the main path's shapes
    results = {
        "flash_fwd_oneshot": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/attention.cu",
                                  replaces="flash_diffusion_tpu/ops/attention.py:171"),
        "flash_fwd_stream": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/flash_fwd_mma.cu",
                                 replaces="flash_diffusion_tpu/ops/attention.py:85"),
        "layer_norm": dict(route="cuda", source="flash_diffusion_tpu_torch/csrc/layer_norm.cu",
                           replaces="flash_diffusion_tpu/ops/norms.py:317"),
    }
    for r in results.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    check_attention(attention, results)
    check_layer_norm(norms, results)
    torch.cuda.empty_cache()

    # phase 3: the main path, through the user's entry point
    pipe = build_pipeline("sd15", device="cuda", seed=0)
    counters = (attention.LAUNCHES, norms.LAUNCHES)
    reset(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=0)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {**attention.LAUNCHES, **norms.LAUNCHES}
    print(f"generate (cold): {cold:.3f} s; launches {launches}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(images.shape) != (4, 512, 512, 3) or not torch.isfinite(images).all():
        raise AssertionError(f"bad images: shape {tuple(images.shape)}, finite {torch.isfinite(images).all().item()}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    warm = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, num_inference_steps=4, guidance_scale=0.0, seed=seed)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    per_batch = statistics.median(warm)
    print(f"sd15 512² 4-NFE batch 4 on {card}: warm {per_batch:.4f} s/batch (median of {warm}), "
          f"{4 / per_batch:.3f} images/s; image range [{images.min().item():.3f}, {images.max().item():.3f}]")

    # phase 4: agreement with the fp32 plain reference on a small input
    check_reference(pipe, FlashPipeline)

    for name, r in results.items():
        r["launches"] = launches[name]
    print(json.dumps({"kernels": [{"name": n, **r} for n, r in results.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
