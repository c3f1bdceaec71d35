#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four main paths at full width and depth with random
weights made from a seed: 4-step text-to-image sampling of SD1.5 at 512² and
of SDXL at 1024², the Flash distillation step of SD1.5 at 512², and SDXL
1024² served over HTTP in int8 W8A8 with a merged LoRA. It fails unless
every phase passes:

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernels from ``flash_diffusion_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed);
2. kernels vs plain: each hand-written kernel against its plain PyTorch
   version at every shape the paths give it (bf16 kernel vs the plain
   version in fp32 on the same inputs), with ragged cases; max abs error
   against the stated tolerance; at the paths' shapes also the kernel's,
   the plain version's and the PyTorch library call's device time (CUDA
   events around 10 queued calls, median of 5 runs) and the bound: the
   larger of the bytes the function moves over 3.35 TB/s and its operations
   (as the JAX ``pl.CostEstimate`` counts them) over 989 TFLOP/s in bf16
   (67 TFLOP/s fp32 for LayerNorm). The library calls are yardsticks only:
   ``F.scaled_dot_product_attention`` (forward for K1, K2, K4; its backward,
   ``torch.autograd.grad`` with ``retain_graph``, for K6–K8) and
   ``F.layer_norm`` for K3, ``torch._int_mm`` and the same dequant for the
   int8 GEMM (K11, whose bound counts int8 operations at 1979 TOP/s and whose
   int32 sums are checked equal to the plain version's, its bf16 output to
   one ulp). The backward kernels (K6+K7 or K8, routed by
   ``attention_bwd_plan``) are held in fp32 against
   ``attention_bwd_reference`` for dq, dk and dv, each to the forward's out
   tolerance times max(1, max|grad|); K6 and K7 are also timed alone;
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
   parameter;
5. training, after the serving pipelines are freed: ``build_trainer("sd15",
   device="cuda")`` with ``flash_sd.yaml`` (K = 32, LPIPS distill, DMD,
   hinge GAN, rank-128 LoRA, ``remat`` on) and ``NUM_ITERATIONS_PER_K`` set
   so that every step falls in stage 1 (distill 1.0, DMD 0.3, adversarial
   0.1), then ``fit`` on synthetic batches of 4 at 512²: 1 warm and 3 timed
   steps. Every loss finite; every LoRA B factor and the discriminator
   changed; teacher, VAE and CLIP bit-identical; the launch counts of K1,
   K2, K3, K6, K7 and K8, reset just before, grown (the forward kernels'
   counts include the recompute of ``remat`` and of the checkpointed LPIPS
   decode in the backward). Warm s/step (median), images/s and peak memory
   (the stage breakdown is ``flash_diffusion_tpu_torch.profiling --train``);
5b. training reference at 256² (K = [4], ``LPIPS_CROP`` 16, no
   discriminator stage, batch 2, non-zero LoRA B; 256² is the least size
   whose 4×4 mid features the discriminator's 4×4 head takes; at 128²
   they are 2×2): one ``losses`` and
   backward on the card in bf16 against an fp32 CPU copy built from the
   state dicts, on the same staged batch and the same draws: the distill,
   DMD and D losses each to a relative error of 0.05, the discriminator's
   outputs to a relative L2 of 0.05, the LoRA and discriminator gradients to
   a relative L2 of 0.1, the VAE encode to 0.1. Printed beside, ungated: the
   LoRA gradients' error of each scaled G term alone, and of the student's
   own backward (the gradient of a fixed random projection of its output);
6. int8 serving, after the training pipelines are freed: ``build_pipeline(
   "sdxl", device="cuda")``, a random rank-64 LoRA over the default targets
   written as a PEFT file and loaded through ``pipe.lora_loader``, then
   ``quantize("int8")`` (722 layers) and ``InferenceServer`` on an
   ephemeral localhost port (``max_batch`` 4, ``batch_sizes`` (1, 4),
   prewarm) in a thread. 8 concurrent clients each send 8 ``POST
   /generate`` at 1024² (``format: json``), one after the other (a closed
   loop: 64 requests, 16 dispatches of 4): each response must decode to a
   1024×1024 RGB PNG; ``/healthz``, ``/loras`` and ``/metrics``
   (``batch_occupancy`` 1.0) are checked, and the int8 GEMM kernel's
   launches, reset just before, must be 2888 per batch-4 dispatch (722
   products × 4 steps), with K2, K3 and K4 launched too. Then warm s/batch
   (median of 3 ``generate`` calls), images/s, the 64 requests' latency
   p50/p95 (the server's, and the clients' with PNG and HTTP) and peak
   memory;
6b. the same int8 pipeline at 128² on one prompt against its fp32 CPU copy
   with the same int8 weights (the plain paths), as phases 4/4b; and one
   request's image alone against the same request in a batch of 4
   (per-request seeds), to a relative L2 of 0.1: bf16 rounding differs with
   the batch shape, and the int8 codes that flip under it pass the change
   on (a wrong noise chain gives ~1.4).

The second-to-last line of output is the card's name and power limit; the
line before it lists the kernels as JSON (``launches``: the count over the
paths' runs, ``launches_by_path`` each; ``ms``, ``plain_ms``,
``library_ms``, ``bound_ms``: sums over the paths' shapes, ``bound_by`` the
bound of the largest share; for K6 and K7 ``plain_ms`` and ``library_ms``
are those of the whole backward, dq, dk and dv); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port beside
this file, it exits non-zero and prints no result.
"""

import base64
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import torch
import torch.nn.functional as F

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
# (bh, sq, kv, d, kv_valid) of the attention backward of one training step
# at batch 4, 512² (8 heads): the student's (BH 32) and the GAN branch's
# teacher down path and mid block at 2B (BH 64), self-attention per level
# and cross-attention over the 77 text tokens; and the VAE decoder's
# single-head mid-attention under the LPIPS loss. Ragged: Sq off the tile,
# KV 200, kv_valid < KV, batch 1 (BH 8; VAE BH 1)
BWD_LEVELS = [
    (4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
    (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160),
]
BWD_SHAPES = [(bh, sq, kv, d, None) for bh in (32, 64) for sq, kv, d in BWD_LEVELS]
BWD_SHAPES.append((4, 4096, 4096, 512, None))
BWD_RAGGED = [
    (32, 4000, 77, 40, None), (64, 1000, 200, 80, 150), (8, 4096, 4096, 40, 3001),
    (8, 4000, 77, 40, 70), (1, 700, 4096, 512, 3000), (64, 300, 2000, 160, 1999),
]
# the training phase: every step in stage 1 of flash_sd.yaml's four
TRAIN_OVERRIDES = {"NUM_ITERATIONS_PER_K": [0, 5000, 5000, 5000]}
# the training reference at 256²: one stage, at stage 1's loss scales
TRAIN_REF_OVERRIDES = {
    "IMAGE_SIZE": 256, "K": [4], "NUM_ITERATIONS_PER_K": [10], "MODE_PROBS": [[0.25] * 4],
    "LPIPS_CROP": 16, "DISTILL_LOSS_SCALE": 1.0, "DMD_LOSS_SCALE": 0.3, "ADVERSARIAL_LOSS_SCALE": 0.1,
}
TRAIN_REF_LORA_B_STD = 1e-3  # B ≠ 0, so that A has a gradient too
# [M, K, N] of every int8 product of SDXL 1024² at batch 4, guidance 0:
# at the 64² level q/k/v/out, attn2 q/out and proj_in/proj_out, the
# cross-attention k/v over the 77 text tokens, ff.net.0.proj, ff.net.2;
# then the same at the 32² level and the mid block
INT8_SHAPES = [
    (16384, 640, 640), (308, 2048, 640), (16384, 640, 5120), (16384, 2560, 640),
    (4096, 1280, 1280), (308, 2048, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
]
# (M, K, N, bias + gelu): batch 1's k/v (M = 77), ragged M and N, the
# epilogue with bias and tanh-gelu, K not a multiple of the 64-byte step
INT8_EXTRA = [(77, 2048, 640, False), (4001, 1280, 1000, False), (4096, 1280, 10240, True),
              (300, 96, 130, True)]
# phase 6: the LoRA (B ~ N(0, 0.01) changes the attention and feed-forward
# weights by ~14%), the batcher's linger window (long enough for the 4
# clients a dispatch answers to send their next requests), and the load: 8
# clients in a closed loop, 8 requests each, so that p95 is a percentile of
# 64 latencies (the 61st) and not the slowest of a few
SERVE_LORA_RANK, SERVE_LORA_B_STD, SERVE_LINGER_MS = 64, 0.01, 1000.0
SERVE_CLIENTS, SERVE_REQUESTS_PER_CLIENT = 8, 8
SERVE_INT8_LAYERS = 722  # 70 transformer blocks × 10 + 11 spatial transformers × 2
# H100 SXM peaks (NVIDIA's data sheet; dense, at 700 W)
HBM_BYTES_PER_S, BF16_OPS_PER_S, FP32_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 67e12, 1979e12
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


def library_ms(make):
    """Device time of a PyTorch library call (a yardstick, never on the
    port's path): ``make()`` sets it up and returns the call. None, with the
    reason printed, where the library cannot run it at this shape."""
    try:
        return median_ms(make())
    except RuntimeError as e:
        print(f"  library call unavailable here: {str(e).splitlines()[0][:160]}")
        torch.cuda.empty_cache()
        return None


def bound(ops: float, nbytes: float, ops_per_s: float = BF16_OPS_PER_S):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def new_row(route, source, replaces):
    return dict(route=route, source=source, replaces=replaces, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                library_ms=0.0, bound_ms=0.0, bound_by={"bytes": 0.0, "operations": 0.0})


def add_times(r, ms, plain, library, bnd):
    """Adds one main-path shape's times to a kernel's row."""
    r["ms"] += ms
    r["plain_ms"] += plain
    r["library_ms"] = None if library is None or r["library_ms"] is None else r["library_ms"] + library
    r["bound_ms"] += bnd[0]
    r["bound_by"][bnd[1]] += bnd[0]


def fmt_ms(x):
    return "n/a" if x is None else f"{x:.4f}"


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
        main = (bh, sq, skv, d, kv_valid) in ATTENTION_SHAPES + ATTENTION_SHAPES_XL
        times = f"kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if main:  # q, k, v, out in bf16 and the fp32 lse; q·kᵀ and p·v
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
            bnd = bound(4 * bh * sq * skv * d, 2 * bh * (2 * sq + 2 * skv) * d + 4 * bh * sq)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"attention {kind:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} "
              f"kv_valid={kv_valid}: max|out err| {err:.3e} (tol {ATTN_OUT_TOL}) "
              f"max|lse err| {lse_err:.3e} (tol {ATTN_LSE_TOL}); {times}")
        if not (err <= ATTN_OUT_TOL and lse_err <= ATTN_LSE_TOL):
            raise AssertionError(f"attention kernel disagrees with its plain version at {(bh, sq, skv, d, kv_valid)}")
        r = results[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            add_times(r, ms, plain, library, bnd)


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
        main = (b, sq, kv, h, d) in PACKED_SHAPES
        times = f"kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if main:  # q, k, v, out in bf16 (no lse)
            heads = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), scale=scale))
            bnd = bound(4 * b * h * sq * kv * d, 2 * b * (2 * sq + 2 * kv) * h * d)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"attention flash_fwd_oneshot_packed b={b} sq={sq:4d} kv={kv:3d} h={h:2d} d={d:3d}: "
              f"max|out err| {err:.3e} (tol {ATTN_OUT_TOL}); {times}")
        if not err <= ATTN_OUT_TOL:
            raise AssertionError(f"packed attention kernel disagrees with its plain version at {(b, sq, kv, h, d)}")
        r = results["flash_fwd_oneshot_packed"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            add_times(r, ms, plain, library, bnd)


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
        main = (rows, c, dtype) in LAYER_NORM_SHAPES + LAYER_NORM_SHAPES_XL
        times = f"kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if main:  # x and y, weight and bias; Σx, Σx², centre, scale, affine: 7 fp32 ops an element
            library = library_ms(lambda: lambda: F.layer_norm(x, (c,), w, b, 1e-5))
            bnd = bound(7 * rows * c, (2 * rows * c + 2 * c) * x.element_size(), FP32_OPS_PER_S)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"layer_norm rows={rows:5d} C={c:4d} {str(dtype):14s}: max|err| {err:.3e} "
              f"(tol {LN_TOL[dtype]:.3e}); {times}")
        if not err <= LN_TOL[dtype]:
            raise AssertionError(f"LayerNorm kernel disagrees with its plain version at {(rows, c, dtype)}")
        r = results["layer_norm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            add_times(r, ms, plain, library, bnd)


def within_bf16_ulp(got, want, floor=0.0) -> bool:
    """|got − want| ≤ one bf16 ulp of ``want`` (or ``floor``, where larger)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w), torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((got.float() - w).abs() <= torch.clamp(ulp, min=floor)).all())


def check_int8_gemm(gemm, results):
    """K11 at every int8 shape of the SDXL path and the extra cases: its
    int32 sums (the raw-sums epilogue) equal the plain version's; its bf16
    output within one ulp of the plain version's (the epilogue runs in the
    same fp32 order, so exactly equal without gelu; with tanh-gelu, 1e-6
    absolute where 1 + tanh(u) cancels in the negative tail). At the path's
    shapes also kernel, plain, library and bound times. Bound: 2·M·K·N int8
    operations at 1979 TOP/s, or xq, wq, the two scales read and the bf16
    output written once at 3.35 TB/s."""
    g = torch.Generator(device="cuda").manual_seed(4)
    for m, k, n, epilogue in [(*s, False) for s in INT8_SHAPES] + INT8_EXTRA:
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=g, device="cuda") * 1e-3 + 1e-5
        sw = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
        bias, act = (torch.randn(n, generator=g, device="cuda"), "gelu") if epilogue else (None, None)
        sums = gemm.int8_gemm(xq, None, wq, None, out_dtype=torch.int32)
        y = gemm.int8_gemm(xq, sx, wq, sw, bias, act)
        torch.cuda.synchronize()
        ref = gemm.int8_gemm_reference(xq, sx, wq, sw, bias, act)
        sums_equal = torch.equal(sums, gemm.int8_sums_reference(xq, wq))
        close = within_bf16_ulp(y, ref, 1e-6 if act else 0.0)
        err = (y.float() - ref.float()).abs().max().item()
        ms = median_ms(lambda: gemm.int8_gemm(xq, sx, wq, sw, bias, act))
        main = (m, k, n) in INT8_SHAPES and not epilogue
        times = f"kernel {ms:.4f} ms"
        if main:
            plain = median_ms(lambda: gemm.int8_gemm_reference(xq, sx, wq, sw))
            library = library_ms(lambda: lambda: (torch._int_mm(xq, wq.t()).float() * sx[:, None] * sw).to(
                torch.bfloat16))
            bnd = bound(2 * m * k * n, m * k + k * n + 4 * (m + n) + 2 * m * n, INT8_OPS_PER_S)
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"int8_gemm M={m:5d} K={k:4d} N={n:5d}{' bias+gelu' if epilogue else ''}: int32 sums equal "
              f"{sums_equal}; bf16 max|err| {err:.3e} (within one ulp{' or 1e-6' if act else ''}: {close}); "
              f"{times}")
        if not (sums_equal and close):
            raise AssertionError(f"int8 GEMM kernel disagrees with its plain version at {(m, k, n, epilogue)}")
        r = results["int8_gemm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            add_times(r, ms, plain, library, bnd)
        del xq, wq, sums, y, ref
        torch.cuda.empty_cache()


def pair_kernels(attention, kernels, q, k, v, o, lse, do, scale, kv_valid):
    """K6 and K7 each alone, launched as ``flash_attention_bwd_bhsd``
    launches them (and not counted), for their separate times."""
    bh, sq, d = q.shape
    kv_len = kv_valid or k.shape[1]
    _, bq, bkv, dc = attention.attention_bwd_plan(kv_len, d)
    lib = kernels.library()
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (bh, sq, k.shape[1], d, kv_len, float(scale), bq, bkv, dc)
    ins = lambda: tuple(t.data_ptr() for t in (q, k, v, do, lse, delta))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dkv = lambda: kernels.check(lib.fdt_flash_bwd_dkv(*ins(), dk.data_ptr(), dv.data_ptr(), *dims, stream()),
                                "flash_bwd_dkv")
    dqk = lambda: kernels.check(lib.fdt_flash_bwd_dq(*ins(), dq.data_ptr(), *dims, stream()), "flash_bwd_dq")
    return dkv, dqk


def sdpa_backward(q, k, v, do, scale):
    """The library yardstick of the backward: ``F.scaled_dot_product_attention``
    on [1, BH, S, D], its dq, dk, dv by ``torch.autograd.grad``."""
    qq, kk, vv = (t[None].detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, scale=scale)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), do[None], retain_graph=True)


def check_attention_bwd(attention, kernels, results):
    """K6+K7 and K8 against ``attention_bwd_reference`` in fp32; at the
    training step's shapes also their times, the plain version's, the
    library's and the bound. Operations as the JAX ``pl.CostEstimate``
    counts them: 10·BH·Sq·KV·D for K8, 5·BH·Sq·KV·D each for K6 and K7.
    Bytes: K8's wrapper reads q, k, v, o, dO, lse and writes dq, dk, dv; K6
    reads q, dO, k, v, lse, Δ and writes dk, dv; K7 the same, writing dq."""
    g = torch.Generator(device="cuda").manual_seed(3)
    for shape in BWD_SHAPES + BWD_RAGGED:
        bh, sq, skv, d, kv_valid = shape
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                       for s in (sq, skv, skv, sq))
        scale = d ** -0.5
        kv_len = kv_valid or skv
        route = attention.attention_bwd_plan(kv_len, d)[0]
        o, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        grads = attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid)
        torch.cuda.synchronize()
        err, mag = [0.0] * 3, [0.0] * 3
        step = max(1, 2 ** 26 // (sq * skv))  # the fp32 reference, a few GiB at a time
        for i in range(0, bh, step):
            sl = slice(i, i + step)
            ref = attention.attention_bwd_reference(
                *(t[sl].float() for t in (q, k, v, o)), lse[sl], do[sl].float(), scale, kv_valid)
            for j, (got, want) in enumerate(zip(grads, ref)):
                err[j] = max(err[j], (got[sl].float() - want).abs().max().item())
                mag[j] = max(mag[j], want.abs().max().item())
            del ref
        del grads
        tol = [ATTN_OUT_TOL * max(1.0, m) for m in mag]
        ms = median_ms(lambda: attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid))
        main = shape in BWD_SHAPES
        times = f"kernel {ms:.4f} ms"
        if main:
            plain = median_ms(lambda: attention.attention_bwd_reference(q, k, v, o, lse, do, scale, kv_valid))
            library = library_ms(lambda: sdpa_backward(q, k, v, do, scale))
            work = bh * sq * kv_len * d
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms"
            if route == "flash_bwd_oneshot":
                bnd = bound(10 * work, 2 * bh * (4 * sq + 4 * skv) * d + 4 * bh * sq)
                times += f", bound {bnd[0]:.4f} ms ({bnd[1]})"
                add_times(results[route], ms, plain, library, bnd)
            else:
                dkv, dqk = pair_kernels(attention, kernels, q, k, v, o, lse, do, scale, kv_valid)
                ms_dkv, ms_dq = median_ms(dkv), median_ms(dqk)
                b_dkv = bound(5 * work, 2 * bh * (2 * sq + 4 * skv) * d + 8 * bh * sq)
                b_dq = bound(5 * work, 2 * bh * (3 * sq + 2 * skv) * d + 8 * bh * sq)
                times += (f"; K6 alone {ms_dkv:.4f} ms (bound {b_dkv[0]:.4f} ms, {b_dkv[1]}), "
                          f"K7 alone {ms_dq:.4f} ms (bound {b_dq[0]:.4f} ms, {b_dq[1]})")
                add_times(results["flash_bwd_dkv"], ms_dkv, plain, library, b_dkv)
                add_times(results["flash_bwd_dq"], ms_dq, plain, library, b_dq)
        print(f"attention backward {route:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} kv_valid={kv_valid}: "
              f"max|err| dq {err[0]:.3e} dk {err[1]:.3e} dv {err[2]:.3e} (tol {tol[0]:.3e} {tol[1]:.3e} "
              f"{tol[2]:.3e}: {ATTN_OUT_TOL} x max(1, max|grad|)); {times}")
        if not all(e <= t for e, t in zip(err, tol)):
            raise AssertionError(f"attention backward disagrees with its plain version at {shape}")
        if route == "flash_bwd_oneshot":
            rows = [(results[route], max(err))]
        else:
            rows = [(results["flash_bwd_dkv"], max(err[1:])), (results["flash_bwd_dq"], err[0])]
        for r, e in rows:
            r["max_abs_err"] = max(r["max_abs_err"], e)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def reset(counters):
    for d in counters:
        for k in d:
            d[k] = 0


def cpu_fp32_copy(state, meta_module: torch.nn.Module) -> torch.nn.Module:
    """``meta_module`` (the same architecture, built on the meta device) on
    the CPU with the weights of ``state``, a state dict: float tensors as
    fp32, int8 weights and their scales as they are, tensor by tensor, so
    that the host holds one fp32 copy and the card no second one."""
    from flash_diffusion_tpu_torch.quant import apply_weights

    meta_module.to_empty(device="cpu")
    apply_weights(meta_module, {k: v.cpu().float() if v.is_floating_point() else v.cpu()
                                for k, v in state.items()})
    return meta_module.eval()


def check_reference(pipe, model: str, label: str = ""):
    """The pipeline's own modules at 128² on one prompt: bf16 on the card
    through the kernels vs an fp32 copy on the CPU through the plain paths
    (with the pipeline's served weights: int8 ones in int8 mode)."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.models.embedders import ConditionerWrapper
    from flash_diffusion_tpu_torch.sample import build_modules

    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("host memory (GiB) before the fp32 copy: " + " | ".join(free.splitlines()[:2]))
    with torch.device("meta"):
        unet, vae, conditioners, _, _ = build_modules(model)
    ref = FlashPipeline(
        cpu_fp32_copy(pipe.state, unet),
        cpu_fp32_copy(pipe.conditioner.state_dict(), ConditionerWrapper(conditioners)),
        cpu_fp32_copy(pipe.vae.state_dict(), vae), pipe.tokenizer_fn, pipe.latent_shape,
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
    print(f"{label or model} reference at 128², 1 prompt: CLIP (fp32 on the card) rel L2 err {errs} (tol 1e-4); "
          f"images (bf16 on the card vs fp32 on the CPU) rel L2 err {img_err:.3e} (tol 0.1), "
          f"max|err| {(got - want).abs().max().item():.3e}")
    if not (max(clip_errs.values()) <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError(f"the card's {label or model} slice disagrees with the fp32 reference on a small input")


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


def png_pixels(png: bytes):
    """(width, height, RGB rows) of a PNG from the port's writer (8-bit RGB,
    one IDAT, filter 0 on every row)."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", png[16:26])
    at = png.index(b"IDAT")
    raw = zlib.decompress(png[at + 4: at + 4 + struct.unpack(">I", png[at - 4: at])[0]])
    if (depth, color) != (8, 2) or len(raw) != height * (1 + 3 * width):
        raise AssertionError(f"not an 8-bit RGB PNG of {width}x{height}")
    return width, height


def write_peft(path: str, tree) -> str:
    """A PEFT adapter file of a port LoRA tree (A as [r, in], B as [out, r])."""
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_file({f"unet.{name}.lora_{x}.weight": ab[leaf].t().contiguous().cpu()
               for name, ab in tree.items() for x, leaf in (("A", "a"), ("B", "b"))}, path)
    return path


def run_int8_serving(counters, card, required):
    """Phase 6: SDXL 1024² int8 with a merged LoRA behind ``InferenceServer``:
    8 clients in a closed loop of HTTP requests, counts reset just before
    and read after. Returns (launches, the pipeline)."""
    from flash_diffusion_tpu_torch.lora import init_lora
    from flash_diffusion_tpu_torch.ops import gemm
    from flash_diffusion_tpu_torch.sample import build_pipeline
    from flash_diffusion_tpu_torch.serving import InferenceServer, ServingConfig

    t0 = time.perf_counter()
    pipe = build_pipeline("sdxl", device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(5)
    tree = init_lora(pipe.denoiser, SERVE_LORA_RANK, g, device="cuda")
    for ab in tree.values():
        ab["b"].normal_(0.0, SERVE_LORA_B_STD, generator=g)
    path = write_peft(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                                   "lora.safetensors"), tree)
    n_lora = len(tree)
    del tree
    t1 = time.perf_counter()
    pipe.load_lora(*pipe.lora_loader(path))
    pipe.quantize("int8")
    torch.cuda.synchronize()
    n_int8 = sum(t.dtype == torch.int8 for t in pipe.state.values())
    print(f"sdxl int8: build {t1 - t0:.2f} s, LoRA load (PEFT file, rank {SERVE_LORA_RANK}, "
          f"{n_lora} layers) + merge + quantize {time.perf_counter() - t1:.2f} s; "
          f"{n_int8} int8 layers; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_int8 != SERVE_INT8_LAYERS:
        raise AssertionError(f"quantize('int8') made {n_int8} int8 layers, not {SERVE_INT8_LAYERS}")
    server = InferenceServer(pipe, ServingConfig(port=0, max_batch=4, linger_ms=SERVE_LINGER_MS,
                                                 batch_sizes=(1, 4), prewarm=True))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        if not server.ready.wait(600):
            raise AssertionError("the server did not come up")
        url = f"http://127.0.0.1:{server.address[1]}"
        get = lambda p: json.loads(urllib.request.urlopen(url + p, timeout=60).read())
        n_req = SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT
        replies, client_s = [None] * n_req, [None] * n_req

        def client(c):
            for i in range(c * SERVE_REQUESTS_PER_CLIENT, (c + 1) * SERVE_REQUESTS_PER_CLIENT):
                body = json.dumps({"prompt": PROMPTS[i % 4], "seed": i, "format": "json"}).encode()
                req = urllib.request.Request(url + "/generate", data=body, method="POST")
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    replies[i] = json.loads(r.read())
                client_s[i] = time.perf_counter() - t

        reset(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        wall = time.perf_counter() - t0
        launches = {k: n for d in counters for k, n in d.items()}
        metrics, health, loras = get("/metrics"), get("/healthz"), get("/loras")
    finally:
        server.shutdown()
        thread.join(60)
    print(f"sdxl int8 serving: {SERVE_CLIENTS} clients × {SERVE_REQUESTS_PER_CLIENT} requests in {wall:.3f} s; "
          f"launches {launches}; /metrics {metrics}; /healthz {health}; /loras {loras}")
    sizes = [png_pixels(base64.b64decode(p)) for r in replies if r for p in r["images_png_b64"]]
    if sizes != [(1024, 1024)] * n_req:
        raise AssertionError(f"expected {n_req} RGB PNGs of 1024x1024, got {len(sizes)}: {set(sizes)}")
    if (metrics["requests"], metrics["images_generated"], metrics["batches_dispatched"], metrics["errors"],
            metrics["batch_occupancy"]) != (n_req, n_req, n_req // 4, 0, 1.0):
        raise AssertionError(f"unexpected /metrics {metrics}")
    if not health["ok"] or list(loras["adapters"]) != ["default"]:
        raise AssertionError(f"unexpected /healthz {health} or /loras {loras}")
    per_dispatch = SERVE_INT8_LAYERS * 4
    if launches["int8_gemm"] != per_dispatch * metrics["batches_dispatched"]:
        raise AssertionError(f"int8 GEMM launched {launches['int8_gemm']} times, not {per_dispatch} per "
                             f"batch-4 dispatch")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the int8 serving path never launched {missing}")
    lat = sorted(client_s)
    q = lambda p: lat[min(n_req - 1, int(p * n_req))]
    warm = []
    for seed in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, seed=[4 * seed + j for j in range(4)])
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    per_batch = statistics.median(warm)
    print(f"sdxl int8 + LoRA 1024² 4-NFE batch 4 on {card}: warm {per_batch:.4f} s/batch (median of {warm}), "
          f"{4 / per_batch:.3f} images/s; {wall / metrics['batches_dispatched']:.4f} s per dispatch under the "
          f"server; request latency over {n_req} requests ({SERVE_CLIENTS} clients in a closed loop): server p50 "
          f"{metrics['latency_p50_s']} s, p95 {metrics['latency_p95_s']} s; client (with PNG and HTTP) p50 "
          f"{q(0.5):.4f} s, p95 {q(0.95):.4f} s, min {lat[0]:.4f} s, max {lat[-1]:.4f} s; "
          f"int8 GEMM launches per batch-4 dispatch "
          f"{launches['int8_gemm'] // metrics['batches_dispatched']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, pipe


def check_batch_invariance(pipe):
    """Phase 6b's second half: a request alone and in a batch of 4 (each
    sample's own seed), at 128²."""
    alone = pipe.generate(PROMPTS[1:2], seed=[21], height=128, width=128)
    batch = pipe.generate(PROMPTS, seed=[20, 21, 22, 23], height=128, width=128)
    err = rel_l2(alone[0].float().cpu(), batch[1].float().cpu())
    other = rel_l2(batch[0].float().cpu(), batch[1].float().cpu())
    print(f"sdxl int8 at 128²: request alone vs slot 1 of a batch of 4, rel L2 {err:.3e} (tol 0.1; another "
          f"seed's image differs by {other:.3e})")
    if not err <= 0.1:
        raise AssertionError("a request's image depends on its batch")


def snapshot(modules):
    return [t.detach().clone() for m in modules for t in m.state_dict().values()]


def run_training(counters, card, required):
    """Phase 5: ``build_trainer("sd15")`` then ``fit`` on synthetic batches
    of 4 at 512², 1 warm step and 3 timed ones, all in stage 1; counts reset
    just before the first step and read after the last."""
    from flash_diffusion_tpu_torch.train import DEFAULT_CONFIG, build_trainer, load_config, synthetic_batches

    t0 = time.perf_counter()
    trainer = build_trainer("sd15", device="cuda", seed=0, config={**load_config(DEFAULT_CONFIG), **TRAIN_OVERRIDES})
    model = trainer.model
    print(f"build_trainer('sd15'): {time.perf_counter() - t0:.2f} s; LoRA {len(trainer.lora)} pairs, "
          f"{sum(t.numel() for ab in trainer.lora.values() for t in ab.values())} parameters")
    frozen_modules = (model.teacher_module, model.vae, model.conditioner)
    frozen = snapshot(frozen_modules)
    lora_b = {k: ab["b"].detach().clone() for k, ab in trainer.lora.items()}
    disc = snapshot([model.discriminator])
    data = synthetic_batches(4, 512, seed=0)

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = trainer.fit(data, max_steps=trainer.step + 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        losses = {k: float(v) for k, v in aux.items()}
        stage = model.stage_for_iteration(trainer.step)
        print(f"train step {trainer.step} (stage {stage}): {dt:.3f} s; " + ", ".join(
            f"{k} {v:.5g}" for k, v in losses.items()))
        if stage != 1 or not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"training step {trainer.step}: stage {stage}, losses {losses}")
        return dt

    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_step()  # warm
    timed = [one_step() for _ in range(3)]
    launches = {k: n for d in counters for k, n in d.items()}
    print(f"training launches over 4 steps {launches} (the forward kernels' counts include the "
          f"recompute of remat and of the checkpointed LPIPS decode in the backward)")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"the training path never launched {missing}")
    if not all(not torch.equal(lora_b[k], ab["b"]) for k, ab in trainer.lora.items()):
        raise AssertionError("a LoRA B factor did not change")
    if all(torch.equal(a, b) for a, b in zip(disc, snapshot([model.discriminator]))):
        raise AssertionError("the discriminator did not change")
    if not all(torch.equal(a, b) for a, b in zip(frozen, snapshot(frozen_modules))):
        raise AssertionError("a frozen module (teacher, VAE or CLIP) changed")
    per_step = statistics.median(timed)
    print(f"sd15 Flash distillation 512² batch 4 on {card}: warm {per_step:.4f} s/step (median of "
          f"{[round(dt, 4) for dt in timed]}), {4 / per_step:.3f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float() if x.is_floating_point() else x.cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def num(v) -> float:
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def rel_l2(got, want):
    return ((got - want).norm() / want.norm()).item()


def check_training_reference():
    """Phase 5b: one ``losses`` and backward of the SD1.5 trainer at 256²
    on the card (bf16, kernels) vs an fp32 copy on the CPU (plain paths)
    with its state dicts, on the same staged batch and draws."""
    from flash_diffusion_tpu_torch.train import DEFAULT_CONFIG, build_trainer, load_config, synthetic_batches

    cfg = {**load_config(DEFAULT_CONFIG), **TRAIN_REF_OVERRIDES}
    dev = build_trainer("sd15", device="cuda", seed=0, config=cfg)
    ref = build_trainer("sd15", device="cpu", seed=0, config=cfg)  # bf16 until its probe has run
    g = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for name in ("teacher_module", "vae", "conditioner", "lpips", "discriminator"):
            getattr(ref.model, name).load_state_dict(getattr(dev.model, name).state_dict())
        for name, ab in dev.lora.items():
            ab["b"].normal_(0.0, TRAIN_REF_LORA_B_STD, generator=g)
            for k in ("a", "b"):
                ref.lora[name][k].copy_(ab[k])
    size = cfg["IMAGE_SIZE"]
    batch = next(synthetic_batches(2, size, seed=5))
    noise = torch.randn(2, size // 8, size // 8, 4, generator=g, device="cuda")
    staged = dev.stage_batch(batch)
    draws = dev.model.draw(dev.generator, 0, staged["__z"])
    lora = lambda tr: [f for ab in tr.lora.values() for f in ab.values()]
    flat = lambda gs: torch.cat([gr.detach().float().cpu().reshape(-1) for gr in gs])
    # the student's own backward: LoRA gradients of <student(x), w>, on the
    # card, then on the CPU in bf16 (plain paths) and in fp32
    x, w = (torch.randn(2, size // 8, size // 8, 4, generator=g, device="cuda") for _ in range(2))
    args = (x, torch.full((2,), 500, device="cuda"), staged["__conds"][1], w)

    def probe(tr, x, t, cond, w):
        out = tr.model._student_forward(x, t, cond).float()
        return flat(torch.autograd.grad((out * w).sum(), lora(tr), materialize_grads=True))

    probes = [probe(dev, *args), probe(ref, *to_cpu(args))]
    ref.model.teacher_module.float()  # the student shares these parameters
    ref.model.vae.float()
    probes.append(probe(ref, *to_cpu(args)))
    with torch.no_grad():
        image = torch.as_tensor(batch["image"])
        z_dev = dev.model._encode({"image": image.cuda()}, noise)
        z_ref = ref.model._encode({"image": image}, noise.cpu())
    d_out = {id(dev): [], id(ref): []}  # the discriminator's three calls: fake (G), fake (D), real
    hooks = [tr.model.discriminator.register_forward_hook(
        lambda _m, _i, out, key=id(tr): d_out[key].append(out.detach().float().cpu())) for tr in (dev, ref)]
    mcfg = ref.model.config
    scales = {"loss/distill": mcfg.distill_loss_scale[0], "loss/dmd": mcfg.dmd_loss_scale[0],
              "loss/gan_g": mcfg.adversarial_loss_scale[0]}
    results = []
    for tr, args in ((dev, (staged, draws, 0)), (ref, (to_cpu(staged), to_cpu(draws), 0))):
        total, aux = tr.model.losses(*args)
        terms = {k: flat(torch.autograd.grad(sc * aux[k], lora(tr), retain_graph=True, materialize_grads=True))
                 for k, sc in scales.items()}
        total.backward()
        results.append((aux, terms))
    for h in hooks:
        h.remove()
    (aux, terms), (ref_aux, ref_terms) = results
    grads = lambda ps: flat([p.grad for p in ps])
    rel = lambda k: abs(num(aux[k]) - num(ref_aux[k])) / abs(num(ref_aux[k]))
    errs = {
        "loss/distill": rel("loss/distill"),
        "loss/dmd": rel("loss/dmd"),
        "loss/gan_d": rel("loss/gan_d"),
        "disc outputs": rel_l2(torch.cat(d_out[id(dev)]), torch.cat(d_out[id(ref)])),
        "lora grads": rel_l2(grads(lora(dev)), grads(lora(ref))),
        "disc grads": rel_l2(grads(dev.model.discriminator.parameters()),
                             grads(ref.model.discriminator.parameters())),
        "vae encode": rel_l2(z_dev.cpu(), z_ref),
    }
    tols = {"loss/distill": 0.05, "loss/dmd": 0.05, "loss/gan_d": 0.05, "disc outputs": 0.05,
            "lora grads": 0.1, "disc grads": 0.1, "vae encode": 0.1}
    print(f"sd15 training reference at {size}², batch 2, start index {draws['start_idx']} of K = 4: card "
          + ", ".join(f"{k} {num(v):.5g}" for k, v in aux.items()) + "; CPU fp32 "
          + ", ".join(f"{k} {num(v):.5g}" for k, v in ref_aux.items()) + "; errors (tol) "
          + ", ".join(f"{k} {e:.3e} ({tols[k]})" for k, e in errs.items()))
    print("  LoRA gradients by scaled G term, rel L2 err (|grad| fp32): " + ", ".join(
        f"{k} {rel_l2(terms[k], ref_terms[k]):.3e} ({ref_terms[k].norm().item():.4g})" for k in scales)
          + f"; the student's own backward against CPU fp32: card bf16 {rel_l2(probes[0], probes[2]):.3e}, "
          f"CPU bf16 (plain paths, no kernels) {rel_l2(probes[1], probes[2]):.3e}")
    if not all(math.isfinite(e) and e <= tols[k] for k, e in errs.items()):
        raise AssertionError("the card's training step disagrees with the fp32 reference on a small input")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels, norms
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
            name = re.search(r"(?<=\d)(flash_(?:fwd|bwd)_\w+?_kernel|layer_norm_kernel|int8_gemm_kernel)(I\w+?E)?E",
                             line)
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
    for _, _, kv, d, kv_valid in BWD_SHAPES + BWD_RAGGED:  # so do the backward plans
        route, bq, bkv, dc = attention.attention_bwd_plan(kv_valid or kv, d)
        dp = -(-d // 16) * 16
        layouts = ([(bq, bkv, dp, bkv, dc, 2, attention._BWD_SCRATCH)] if route == "flash_bwd_oneshot"
                   else [(bq, bkv, dp, bkv, dc, 2, 0), (bq, bkv, dp, bq, dc, 1, 0)])
        for args in layouts:
            if lib.fdt_flash_bwd_smem_bytes(*args) != attention.bwd_smem_bytes(*args):
                raise AssertionError(f"backward shared-memory plan and kernel layout disagree at {args}")

    results = {
        "flash_fwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention.cu",
                                     "flash_diffusion_tpu/ops/attention.py:171"),
        "flash_fwd_stream": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_fwd_mma.cu",
                                    "flash_diffusion_tpu/ops/attention.py:85"),
        "layer_norm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/layer_norm.cu",
                              "flash_diffusion_tpu/ops/norms.py:317"),
        "flash_fwd_oneshot_packed": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention_packed.cu",
                                            "flash_diffusion_tpu/ops/attention.py:292"),
        "flash_bwd_dkv": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                 "flash_diffusion_tpu/ops/attention.py:635"),
        "flash_bwd_dq": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                "flash_diffusion_tpu/ops/attention.py:703"),
        "flash_bwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd_oneshot.cu",
                                     "flash_diffusion_tpu/ops/attention.py:769"),
        "int8_gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/int8_gemm.cu",
                             "flash_diffusion_tpu/ops/gemm.py:171"),
    }
    # phase 2: kernels vs plain at the main paths' shapes
    check_attention(attention, results)
    check_packed(attention, results)
    check_layer_norm(norms, results)
    check_attention_bwd(attention, kernels, results)
    check_int8_gemm(gemm, results)
    torch.cuda.empty_cache()

    # phases 3 and 4: the SD1.5 path through the user's entry point, then
    # its agreement with the fp32 plain reference on a small input
    counters = (attention.LAUNCHES, norms.LAUNCHES, gemm.LAUNCHES)
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
    del pipe
    torch.cuda.empty_cache()

    # phases 5 and 5b: the training step through the user's entry point,
    # then its agreement with the fp32 plain reference on a small input
    by_path["train"] = run_training(counters, card, (
        "flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_oneshot"))
    torch.cuda.empty_cache()
    check_training_reference()
    torch.cuda.empty_cache()

    # phases 6 and 6b: SDXL served over HTTP in int8 with a merged LoRA,
    # then its agreement with the fp32 plain reference and batch invariance
    by_path["sdxl_int8_serve"], pipe = run_int8_serving(counters, card, (
        "flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", "int8_gemm"))
    check_reference(pipe, "sdxl", "sdxl int8 + LoRA")
    check_batch_invariance(pipe)
    del pipe
    torch.cuda.empty_cache()

    for name, r in results.items():
        r["launches"] = sum(n[name] for n in by_path.values())
        r["launches_by_path"] = {path: n[name] for path, n in by_path.items()}
        r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get)
    print(json.dumps({"kernels": [{"name": n, **r} for n, r in results.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
