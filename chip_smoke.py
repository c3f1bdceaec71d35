#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width and depth with random weights
made from a seed: 4-step text-to-image sampling of SD1.5 at 512² and of
SDXL at 1024² (also in the JAX package's two opt-in kernel modes), the
Flash distillation step of SD1.5 at 512², SDXL 1024² served over HTTP in
int8 W8A8 with a merged LoRA, and 4-step sampling of Pixart-α at 1024²
(T5-XXL, the DiT). It fails unless every phase passes:

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of the kernels from ``flash_diffusion_tpu_torch/csrc`` (one nvcc
   per source, all at once; timed), with ptxas' register report; the
   attention kernels' shared-memory plans against the kernels' own
   arithmetic (K1's and K4's at their shapes, K6/K7's and K2's tiles at
   every head dim they take, K8's at every head dim and KV up to 160 and
   256, K10's plan at every FFN shape and tile width, K12's at every FFN
   shape and built variant, K11's at every int8 shape on this card's SMs
   and on 132, and at each split), and no K1, K2, K4, K5, K6, K7, K8, K10,
   K11 or K12 instantiation may spill (the packed K4 and K5, K11's and K12's
   must have a report of their own), nor may K2, K5, K10, K11 or K12 have
   ptxas serialize their wgmma;
2. kernels vs plain: each hand-written kernel against its plain PyTorch
   version at every shape the paths give it (bf16 kernel vs the plain
   version in fp32 on the same inputs), with ragged cases; max abs error
   against the stated tolerance; at the paths' shapes also the kernel's,
   the plain version's and the PyTorch library call's device time (CUDA
   events around 10 queued calls, median of 5 runs) and the bound: the
   larger of the bytes the function moves over 3.35 TB/s and its operations
   (as the JAX ``pl.CostEstimate`` counts them) over 989 TFLOP/s in bf16
   (67 TFLOP/s fp32 for the norms). The library calls are yardsticks only:
   ``F.scaled_dot_product_attention`` (forward for K1, K2, K4; its backward,
   ``torch.autograd.grad`` with ``retain_graph``, for K6–K8; for K5 on the
   [B, H, S, D] views of the packed tensors) and
   ``F.layer_norm`` for K3, ``torch._int_mm`` and the same dequant for the
   int8 GEMM (K11, whose bound counts int8 operations at 1979 TOP/s and whose
   int32 sums are checked equal to the plain version's, its bf16 output to
   one ulp, at every case, each printed with its plan). K3 (LayerNorm) is
   held to ``ops/norms.py layer_norm_gate`` (bf16: every element within
   2^-8·|y| + 2^-16·max|y|, relative L2 within 4e-3; fp32: the summation
   order), also on rows of small variance where eps shows. The whole
   GroupNorm (``group_norm``: the resident kernel in one launch, or K9's
   statistics with the fold, then the apply) is held to ``group_norm_gate``
   at every GroupNorm shape of the paths, in both layouts, with and without
   SiLU (relative to the plain version in fp32; mean and inv to fp64), and
   bit-equal for a sample alone and in its batch and from run to run; K9's
   own entry (``group_norm_stats``) in fp64 (Σx to 1e-5 of Σ|x|, Σx² to
   1e-5), exact alone vs batched; the apply kernel alone (x·ŵ + b̂, SiLU)
   to one bf16 ulp; their library yardsticks are ``torch.var_mean`` and
   ``F.silu(F.group_norm(...))``. K2
   also runs at Pixart's D = 72. K1 (the one-shot forward) is held to
   ``attention_fwd_gate`` (max|out err| within 4e-3 + 2^-8 of max|out|, a
   relative L2 within 4e-3, a mean signed error within 5e-4, lse within
   5e-3) on cases whose keys past ``kv_valid`` are k × 3 and v + 1, and on
   a 77-key case with v + 1 at every key (a zero padding row that leaked
   would show); K2 to the same gate, with ragged and v + 1 cases at D = 64
   and 72 whose Sq and KV are off its tiles. The backward kernels (K6+K7
   or K8, routed by ``attention_bwd_plan``) are held in fp32 against
   ``attention_bwd_reference`` for dq, dk and dv by ``attention_bwd_gate``
   (max|err| within 4e-3 + 2^-6 of max|grad|, relative L2 within 1e-2, and
   dk, dv exactly 0 at rows past ``kv_valid``, whose keys are filled with
   k × 3 and v + 1); K6 and K7 are also timed alone. K4 and K5 (the
   packed one-shot and streaming attention) at SDXL's cross- and
   self-attention shapes and ragged ones, to the same gate without the lse
   term (their ragged cases add 1 to every v, so that a zero-filled key
   past KV leaking into the softmax would show); K10 and K12 (the feed-forward's
   down-projection GEMMs) at SDXL's two feed-forward shapes, ragged M and
   K10's dW shapes, to ``ops/gemm.py gemm_gate`` (|err| within 2^-8 of |y|
   plus 2^-8 of max|y| at every element, relative L2 within 4e-3, mean
   signed error within 1e-4 of rms|y|; library yardsticks ``F.linear``;
   ``torch.mm`` for dW = xᵀ·dy; for K12, which no one PyTorch call
   computes, the unfused gate then ``F.linear``);
3. SD1.5 path: ``build_pipeline("sd15", device="cuda")`` then ``generate``
   of 4 prompts × 4 steps, guidance 0, 512²: the output must be
   [4, 512, 512, 3] and finite, and the launch counts of K1–K3 and of the
   GroupNorm kernels, reset just before, must have grown; then warm wall
   time per batch and images/s;
4. SD1.5 reference: the same modules at 128² on one prompt, on the card in
   bf16 against a copy on the CPU in fp32 (the plain paths), with the same
   latents and step noise: CLIP must agree to 1e-4 and the images to a
   relative L2 error of 0.1;
3b. SDXL path, after the SD1.5 pipeline is freed: ``build_pipeline("sdxl",
   device="cuda")`` then ``generate`` of 4 prompts × 4 steps, guidance 0,
   1024²: [4, 1024, 1024, 3] and finite, and the launch counts of K2, K3,
   K4 and the GroupNorm kernels, reset just before, must have grown; warm
   s/batch, images/s and peak memory;
4b. SDXL reference at 128² on one prompt, as phase 4: both CLIP outputs
   (crossattn and vector) to a relative L2 of 1e-4, the images to 0.1. The
   fp32 CPU copy is built from the modules' state dicts, parameter by
   parameter;
3c. the same SDXL pipeline in the JAX package's opt-in kernel modes, each
   through ``generate`` as in 3b (same seeds): (A)
   ``FLASH_TPU_ATTN_PACKED=1 FLASH_TPU_FFN_FUSED=1``, (B)
   ``FLASH_TPU_FFN_DOWN_GEMM=1``. The launch counts, reset just before,
   must be exact (A: K12 280, K5 280, K10 0, K2 1; B: K10 280, K12 0, K5
   0) and the images within a relative L2 of 5e-2 of the default mode's;
   warm s/batch, images/s and peak memory beside 3b's;
4c. each mode at 512² (the least size where all three kernels run), one
   prompt, one step, on the card against the fp32 CPU copy under the same
   switches (the plain versions): images to 0.1, the mode's kernels
   launched;
5. training, after the serving pipelines are freed: ``build_trainer("sd15",
   device="cuda")`` with ``flash_sd.yaml`` (K = 32, LPIPS distill, DMD,
   hinge GAN, rank-128 LoRA, ``remat`` on) and ``NUM_ITERATIONS_PER_K`` set
   so that every step falls in stage 1 (distill 1.0, DMD 0.3, adversarial
   0.1), then ``fit`` on synthetic batches of 4 at 512²: 1 warm and 3 timed
   steps. Every loss finite; every LoRA B factor and the discriminator
   changed; teacher, VAE and CLIP bit-identical; the launch counts of K1,
   K2, K3, K6, K7, K8 and the GroupNorm kernels, reset just before, grown
   (the forward kernels'
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
   products × 4 steps), with K2, K3, K4 and the GroupNorm kernels launched
   too. Then warm s/batch
   (median of 3 ``generate`` calls), images/s, the 64 requests' latency
   p50/p95 (the server's, and the clients' with PNG and HTTP) and peak
   memory;
6b. the same int8 pipeline at 128² on one prompt against its fp32 CPU copy
   with the same int8 weights (the plain paths), as phases 4/4b; and one
   request's image alone against the same request in a batch of 4
   (per-request seeds), to a relative L2 of 1.5e-2, the contract of
   ``FlashPipeline.generate``: the port's own ops are exact, cuDNN's and
   cuBLAS's algorithms depend on the batch size (measured: 9.8e-3; a wrong
   noise chain gives ~1.3);
7. Pixart-α, after the int8 pipeline is freed: ``build_pipeline("pixart",
   device="cuda")`` (T5-XXL in fp32, the DiT and VAE in bf16, LCM on linear
   betas) then ``generate`` of 4 prompts × 4 steps, guidance 0, 1024²:
   [4, 1024, 1024, 3] and finite, the launch counts of K2, K3 and the
   GroupNorm kernels grown; warm s/batch, images/s and peak memory;
7b. Pixart references: T5-XXL at full width and 2 layers, card (fp32) vs
   its CPU copy, rel. L2 1e-4; the DiT and VAE at full size at 128² on one
   prompt, bf16 on the card vs an fp32 CPU copy on the same T5 output
   (the card's), latents and step noise: images to a relative L2 of 0.1.

The second-to-last line of output is the card's name and power limit; the
line before it lists the kernels as JSON (``launches``: the count over the
paths' runs, ``launches_by_path`` each, the modes of 3c as the paths
``sdxl_packed_fused`` and ``sdxl_down_gemm``; ``ms``, ``plain_ms``,
``library_ms``, ``bound_ms``: sums over the paths' shapes, ``bound_by`` the
bound of the largest share; for K6 and K7 ``plain_ms`` and ``library_ms``
are those of the whole backward, dq, dk and dv); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the port beside
this file, it exits non-zero and prints no result.
"""

import base64
import contextlib
import ctypes
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
    (40, 1000, 1100, 64, 1037), (16, 700, 1500, 72, 1433),  # K2 at SDXL's and Pixart's D, off every tile
]
# v + 1 at every key (kv_valid None): a zero-filled padding row past KV (77
# keys padded to 80; the zero rows of K2's last 128-key tile past 1030 or
# 999 keys) that leaked into the softmax would pull every row's output
# towards 0: by ~2% at 77 keys, by 2–11% at ~1000 keys
ATTENTION_V_SHIFTED = [(32, 4000, 77, 40, None), (40, 1000, 1030, 64, None), (16, 999, 999, 72, None)]
# SDXL at batch 4, 1024²: the self-attention (10 heads at level 1, 20 at
# level 2 and mid; D = 64) and the VAE mid-block over 128² latents' 16384
# tokens
ATTENTION_SHAPES_XL = [
    (40, 4096, 4096, 64, None),
    (80, 1024, 1024, 64, None),
    (4, 16384, 16384, 512, None),
]
# Pixart-α 1024² at batch 4: the DiT's self-attention (16 heads of D = 72,
# padded to 80, over 4096 tokens); its VAE mid-block is SDXL's shape above
ATTENTION_SHAPES_PIXART = [(64, 4096, 4096, 72, None)]
# (b, sq, kv, h, d) of the packed one-shot kernel (K4): SDXL's
# cross-attention at level 1 and at level 2 / mid (batch 4, 77 text tokens),
# plus ragged cases (Sq off the tile, KV 200 and 256, D = 128, batch 1,
# batch 8 as under CFG). The ragged cases add 1 to every v (the packed
# kernels take no ``kv_valid``), so that a zero-filled padding key past KV
# (77 keys pad to 80, 200 to 208) that leaked into the softmax (its score
# 0, not -1e30) would pull every row's output towards 0
PACKED_SHAPES = [(4, 4096, 77, 10, 64), (4, 1024, 77, 20, 64)]
PACKED_RAGGED = [
    (4, 4000, 77, 10, 64), (4, 1024, 200, 20, 64), (2, 1000, 256, 10, 64),
    (2, 1024, 77, 8, 128), (1, 4000, 256, 8, 128), (2, 1000, 200, 8, 128), (1, 4096, 77, 10, 64),
    (8, 1024, 77, 20, 64),
]
# (b, sq, kv, h, d) of the packed streaming kernel (K5) under
# FLASH_TPU_ATTN_PACKED=1: SDXL's self-attention at level 1 and at level 2 /
# mid (batch 4), plus ragged cases (Sq off the tile, KV = 4000 and off the
# tile, batch 1, D = 128), with v + 1 as K4's: a leaked key would pull every
# row's output towards 0 by 0.5% (KV 4000) to 3.3% (KV 1030) of |out| ~ 1
PACKED_STREAM_SHAPES = [(4, 4096, 4096, 10, 64), (4, 1024, 1024, 20, 64)]
PACKED_STREAM_RAGGED = [(4, 4000, 4000, 10, 64), (1, 4096, 4096, 10, 64), (1, 1000, 1030, 20, 64),
                        (2, 700, 1500, 8, 128)]
# [M, K, N] of SDXL's feed-forward down projection at batch 4, 1024² (level
# 1: 640 channels over 4096 tokens; level 2 and mid: 1280 over 1024): K12
# under FLASH_TPU_FFN_FUSED=1 (on [a | g] of [M, 2K]), K10 under
# FLASH_TPU_FFN_DOWN_GEMM=1; ragged: batch 1, M off the 128-row tile (odd
# too), the unit tests' shape; and K10's dW = xᵀ·dy of a backward at those
# shapes ([K, M] · [N, M]ᵀ)
FFN_SHAPES = [(16384, 2560, 640), (4096, 5120, 1280)]
FFN_RAGGED = [(4096, 2560, 640), (1024, 5120, 1280), (4001, 2560, 640), (1032, 2048, 128)]
FFN_DW_SHAPES = [(2560, 16384, 640), (5120, 4096, 1280)]
# (rows, C, dtype): UNet norm1/2/3 at each level, CLIP-L (fp32), plus ragged
LAYER_NORM_SHAPES = [
    (4 * 4096, 320, torch.bfloat16),
    (4 * 1024, 640, torch.bfloat16),
    (4 * 256, 1280, torch.bfloat16),
    (4 * 64, 1280, torch.bfloat16),
    (4 * 77, 768, torch.float32),
]
LAYER_NORM_RAGGED = [(4 * 1024 + 3, 640, torch.bfloat16), (1001, 320, torch.bfloat16)]
# rows of small variance (x ~ 3e-3·N(0, 1), var ≈ eps = 1e-5): a kernel that
# drops eps is off by ~√2 there, and by ~1e-6 at unit scale
LAYER_NORM_SMALL_VAR = [(1001, 320, torch.bfloat16), (4 * 256, 1280, torch.bfloat16), (4 * 77, 768, torch.float32)]
# Pixart: the DiT's affine-free LayerNorms over its 4 × 4096 tokens
LAYER_NORM_SHAPES_PIXART = [(4 * 4096, 1152, torch.bfloat16)]
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
# [B, C, H, W] of every GroupNorm of the paths at batch 4 (bf16): the SD1.5
# UNet's levels at 512², the SDXL UNet's at 1024², the SD VAE decoder at
# 512² (SD1.5) and at 1024² (SDXL, Pixart: the largest, [4, 128, 1024²]);
# ragged N (off the 16-byte step, odd, one element), C = 36 (channels-last
# rows off the 16-byte step) and fp32 (the discriminator's) besides. The training path's UNet runs the SD1.5 shapes
# at batch 4 and 8.
GN_SHAPES = [
    (4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 16, 16), (4, 1280, 8, 8),
    (4, 320, 128, 128), (4, 640, 64, 64), (4, 1280, 32, 32),
    (4, 512, 64, 64), (4, 512, 128, 128), (4, 512, 256, 256), (4, 256, 256, 256), (4, 256, 512, 512),
    (4, 128, 512, 512),
    (4, 512, 512, 512), (4, 256, 1024, 1024), (4, 128, 1024, 1024),
]
GN_RAGGED = [((3, 96, 37, 29), torch.bfloat16), ((2, 64, 4099, 1), torch.bfloat16), ((2, 32, 1, 1), torch.bfloat16),
             ((2, 36, 5, 7), torch.bfloat16), ((4, 512, 2, 2), torch.float32), ((2, 96, 37, 29), torch.float32)]
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
# tolerances, kernel (bf16) vs plain (fp32): the attention forwards (K1,
# K2, K4, K5) are held to ops/attention.py attention_fwd_gate, LayerNorm
# (K3) to ops/norms.py layer_norm_gate, the whole GroupNorm to
# group_norm_gate
# GroupNorm statistics (fp32 sums in another order than the fp64 plain
# version): Σx to GN_STATS_TOL of Σ|x|, Σx² to GN_STATS_TOL relative
GN_STATS_TOL = 1e-5
# a request alone vs in slot 1 of a batch of 4: cuDNN's and cuBLAS's
# batch-size-dependent algorithms (measured on an H100: 9.2e-3 in bf16,
# 9.8e-3 in int8; the contract of FlashPipeline.generate)
BATCH_INVARIANCE_TOL = 1.5e-2
# phases 3c and 4c: the JAX package's opt-in kernel modes of SDXL, as (path,
# switches, the exact launches of a batch-4, 4-step 1024² generate: 70
# feed-forwards and 70 self-attentions a UNet call, the VAE's one K2 call)
SWITCHES = ("FLASH_TPU_ATTN_PACKED", "FLASH_TPU_FFN_FUSED", "FLASH_TPU_FFN_DOWN_GEMM")
SDXL_MODES = [
    ("sdxl_packed_fused", {"FLASH_TPU_ATTN_PACKED": "1", "FLASH_TPU_FFN_FUSED": "1"},
     {"geglu_gemm": 280, "flash_fwd_packed": 280, "gemm": 0, "flash_fwd_stream": 1}),
    ("sdxl_down_gemm", {"FLASH_TPU_FFN_DOWN_GEMM": "1"}, {"gemm": 280, "geglu_gemm": 0, "flash_fwd_packed": 0}),
]
# a mode's images vs the default mode's (same seeds): tanh-gelu rounded
# once, other sums and roundings (the default's own batch-size spread is
# 9.2e-3)
MODE_IMAGE_TOL = 5e-2
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


def check_attention(attention, results, timed=True):
    """K1 (``flash_fwd_oneshot``) and K2 (``flash_fwd_stream``) against the
    plain version in fp32 on the same bf16 inputs, every case printed, then
    a raise listing the failures. Both are held to ``attention_fwd_gate``
    (max|out err| ≤ 4e-3 + 2⁻⁸·max|ref|, |mean err| ≤ 5e-4, max|lse err| ≤
    5e-3). On the ragged cases the keys at or past ``kv_valid`` are
    k × 3 and v + 1, and ATTENTION_V_SHIFTED adds 1 to every v, so that a
    masked key, or a zero-filled padding row past KV, leaking into the
    softmax shows as a mean error. With ``timed``, the kernel's and the plain
    version's times, and at the paths' shapes the library's and the bound."""
    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for shape in ATTENTION_SHAPES + ATTENTION_SHAPES_XL + ATTENTION_SHAPES_PIXART + ATTENTION_RAGGED + ATTENTION_V_SHIFTED:
        bh, sq, skv, d, kv_valid = shape
        q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, skv, skv))
        if kv_valid is not None:
            k[:, kv_valid:] *= 3
            v[:, kv_valid:] += 1
        if shape in ATTENTION_V_SHIFTED:
            v += 1
        scale = d ** -0.5
        kind = attention.attention_plan(kv_valid or skv, d)[0]
        out, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.attention_bhsd_reference(
            q.float(), k.float(), v.float(), scale, kv_valid)
        stats = attention.attention_fwd_errors(out, lse, ref_out, ref_lse)
        del ref_out, ref_lse
        ok, report = attention.attention_fwd_gate(stats)
        err = stats["max_err"]
        checks = f"{'pass' if ok else 'FAIL'}: {report}"
        main = shape in ATTENTION_SHAPES + ATTENTION_SHAPES_XL + ATTENTION_SHAPES_PIXART
        times = ""
        if timed:
            ms = median_ms(lambda: attention.flash_attention_bhsd(q, k, v, scale, kv_valid))
            plain = median_ms(lambda: attention.attention_bhsd_reference(q, k, v, scale, kv_valid))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if timed and main:  # q, k, v, out in bf16 and the fp32 lse; q·kᵀ and p·v
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
            bnd = bound(4 * bh * sq * skv * d, 2 * bh * (2 * sq + 2 * skv) * d + 4 * bh * sq)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
            add_times(results[kind], ms, plain, library, bnd)
        print(f"attention {kind:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} kv_valid={kv_valid}"
              f"{' (k x3, v +1 past it)' if kv_valid else ''}{' (v +1)' if shape in ATTENTION_V_SHIFTED else ''}: "
              f"{checks}{times}")
        if not ok:
            failed.append(shape)
        r = results[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del q, k, v, out, lse
    if failed:
        raise AssertionError(f"attention kernel disagrees with its plain version at {failed}")


def check_packed(attention, results, name, shapes, ragged, seed, timed=True):
    """A packed kernel (K4 ``flash_fwd_oneshot_packed``, K5
    ``flash_fwd_packed``) against the packed plain version (the function of
    both) in fp32 on the same bf16 inputs, every case printed, then a raise
    listing the failures. Both are held to ``attention_fwd_gate`` without
    its lse term (max|out err| ≤ 4e-3 + 2⁻⁸·max|ref|, rel. L2 ≤ 4e-3, |mean
    err| ≤ 5e-4); the ragged cases add 1 to every v, so that a zero-filled
    key past KV leaking into the softmax shows as a mean error. With
    ``timed``, the kernel's and the plain version's times, and at the
    paths' shapes the library's (``F.scaled_dot_product_attention`` on the
    [B, H, S, D] views of the same tensors, no copy) and the bound: q, k,
    v, out in bf16 once (no lse); q·kᵀ and p·v, 4·B·H·Sq·KV·D operations."""
    kernel = attention.flash_attention_packed_stream if name == "flash_fwd_packed" else attention.flash_attention_packed
    g = torch.Generator(device="cuda").manual_seed(seed)
    failed = []
    for b, sq, kv, h, d in shapes + ragged:
        main = (b, sq, kv, h, d) in shapes
        q, k, v = (torch.randn(b, s, h * d, generator=g, device="cuda").to(torch.bfloat16)
                   for s in (sq, kv, kv))
        if not main:
            v += 1
        scale = d ** -0.5
        out = kernel(q, k, v, h, scale)
        torch.cuda.synchronize()
        ref = attention.attention_packed_reference(q.float(), k.float(), v.float(), h, scale)
        stats = attention.attention_fwd_errors(out, None, ref, None)
        del ref
        ok, report = attention.attention_fwd_gate(stats)
        times = ""
        if timed:
            ms = median_ms(lambda: kernel(q, k, v, h, scale))
            plain = median_ms(lambda: attention.attention_packed_reference(q, k, v, h, scale))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if timed and main:
            heads = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
            library = library_ms(lambda: lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), scale=scale))
            bnd = bound(4 * b * h * sq * kv * d, 2 * b * (2 * sq + 2 * kv) * h * d)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
            add_times(results[name], ms, plain, library, bnd)
        print(f"attention {name} b={b} sq={sq:4d} kv={kv:4d} h={h:2d} d={d:3d}{'' if main else ' (v +1)'}: "
              f"{'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append((b, sq, kv, h, d))
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        del q, k, v, out
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{name} kernel disagrees with its plain version at {failed}")


def check_ffn_gemm(gemm, results, timed=True):
    """K12 and K10 against their plain versions in fp32, held to
    ``gemm_gate`` (|err| within 2^-8·|y| + 2^-8·max|y| at every element,
    relative L2 within 4e-3, mean signed error within 1e-4 of rms|y|), and
    the plain version on the kernel's own bf16 inputs (its rounding
    contract; printed); K10 also at its dW shapes. Every case printed, then
    a raise listing the failures. With ``timed``, the kernel's time, and at
    SDXL's shapes the plain version's, the library's (K10: ``F.linear(x, W,
    b)``; K12: no one PyTorch call computes it, so the unfused ``F.linear(a
    * F.gelu(g, "tanh"), W, b)``) and the bound: 2·M·K·N operations, or x
    (K12: a and g), W, b read and y written once in bf16."""
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(True, s) for s in FFN_SHAPES + FFN_RAGGED] + [(False, s) for s in FFN_SHAPES + FFN_RAGGED + FFN_DW_SHAPES]
    failed = []
    for geglu, (m, k, n) in cases:
        name = "geglu_gemm" if geglu else "gemm"
        kernel = gemm.geglu_gemm if geglu else gemm.gemm
        plain_fn = gemm.geglu_down_proj_reference if geglu else gemm.down_proj_gemm_reference
        x = torch.randn(m, 2 * k if geglu else k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(n, generator=g, device="cuda")).to(torch.bfloat16)
        y = kernel(x, w, b)
        torch.cuda.synchronize()
        ref = plain_fn(x.float(), w.float(), b.float())
        stats = gemm.gemm_errors(y, ref)
        ok, report = gemm.gemm_gate(stats)
        contract = (y.float() - plain_fn(x, w, b).float()).abs().max().item()
        del ref
        main = (m, k, n) in FFN_SHAPES
        dw = not geglu and (m, k, n) in FFN_DW_SHAPES
        times = ""
        if timed:
            ms = median_ms(lambda: kernel(x, w, b))
            times = f"; kernel {ms:.4f} ms"
        if timed and (main or dw):
            plain = median_ms(lambda: plain_fn(x, w, b))
            if geglu:
                library = library_ms(lambda: lambda: F.linear(
                    x[:, :k] * F.gelu(x[:, k:], approximate="tanh"), w, b))
            elif dw:  # dW = xᵀ·dy as one product (x here is xᵀ, w is dyᵀ)
                library = library_ms(lambda: lambda: torch.mm(x, w.t()))
            else:
                library = library_ms(lambda: lambda: F.linear(x, w, b))
            bnd = bound(2 * m * k * n, 2 * (x.numel() + w.numel() + n + m * n))
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        what = "dW " if dw else ""
        print(f"{name:10s} {what}M={m:5d} K={k:5d} N={n:4d}: {'pass' if ok else 'FAIL'}: {report}; "
              f"vs the plain version in bf16 {contract:.3e}{times}")
        if not ok:
            failed.append((name, m, k, n))
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        if timed and main:
            add_times(r, ms, plain, library, bnd)
        del x, w, b, y
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"feed-forward GEMM kernel disagrees with its plain version at {failed}")


def check_layer_norm(norms, results, timed=True):
    """K3 against its plain version in fp32 on the same inputs at every
    LayerNorm shape of the paths, ragged rows, and rows of small variance
    (x ~ 3e-3·N(0, 1): var ≈ eps, so that eps shows), held to
    ``layer_norm_gate`` (bf16: every element within 2⁻⁸·|y| + 2⁻¹⁶·max|y|,
    relative L2 within 4e-3, mean signed error within 1e-4·rms(y); fp32: the
    summation order, 1e-5·max|y|); every case printed, then a raise listing
    the failures. With ``timed``, the kernel's and the plain version's times,
    and at the paths' shapes the library's (``F.layer_norm``) and the bound
    (x read and y written once, the affine once)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    main_shapes = LAYER_NORM_SHAPES + LAYER_NORM_SHAPES_XL + LAYER_NORM_SHAPES_PIXART
    cases = [(s, 2.0, 0.5) for s in main_shapes + LAYER_NORM_RAGGED] + [(s, 3e-3, 0.0) for s in LAYER_NORM_SMALL_VAR]
    failed = []
    for (rows, c, dtype), scale, offset in cases:
        x = (torch.randn(rows, c, generator=g, device="cuda") * scale + offset).to(dtype)
        w = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        y = norms.layer_norm(x, w, b)
        torch.cuda.synchronize()
        stats = norms.layer_norm_errors(y, norms.layer_norm_reference(x.float(), w.float(), b.float()))
        ok, report = norms.layer_norm_gate(stats)
        main = (rows, c, dtype) in main_shapes and scale == 2.0
        times = ""
        if timed:
            ms = median_ms(lambda: norms.layer_norm(x, w, b))
            plain = median_ms(lambda: norms.layer_norm_reference(x, w, b))
            times = f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
        if timed and main:  # x and y, weight and bias; Σx, Σx², centre, scale, affine: 7 fp32 ops an element
            library = library_ms(lambda: lambda: F.layer_norm(x, (c,), w, b, 1e-5))
            bnd = bound(7 * rows * c, (2 * rows * c + 2 * c) * x.element_size(), FP32_OPS_PER_S)
            times += f", library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        print(f"layer_norm rows={rows:5d} C={c:4d} {str(dtype)[6:]:8s} x~{scale:g}·N(0,1)+{offset:g}: "
              f"{'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append((rows, c, dtype, scale))
        r = results["layer_norm"]
        r["max_abs_err"] = max(r["max_abs_err"], stats["max_err"])
        if timed and main:
            add_times(r, ms, plain, library, bnd)
    if failed:
        raise AssertionError(f"LayerNorm kernel disagrees with its plain version at {failed}")


def check_group_norm(norms, results, timed=True):
    """The whole GroupNorm (``group_norm``: K9's statistics, the fold, the
    apply, SiLU or not) at every GroupNorm shape of the paths and the
    ragged ones, in both layouts the kernels take (contiguous NCHW and
    channels-last, the layout the paths' convolutions hand on), held to
    ``group_norm_gate``: y with and without SiLU against the plain version
    in fp32 from the same x, weight and bias (bf16: every element within
    2⁻⁸·|y| + 2⁻⁷·max|y|, relative L2 within 7.5e-3, mean signed error within
    2e-3·rms(y)), the per-group mean and inv within 1e-5 of fp64; y in x's
    layout; and exact: a sample alone equal to the same sample in its batch,
    and run to run. K9's own entry (``group_norm_stats``): Σx and Σx²
    against fp64 (GN_STATS_TOL), alone == batched and run == run. The apply
    kernel alone (``group_norm_apply``, SiLU) within one bf16 ulp of the
    plain apply on the same scale and shift. Every case printed, then a
    raise listing the failures. With ``timed``, at the paths' shapes:
    statistics, apply and the whole op's time (plain, library
    ``torch.var_mean`` and ``F.silu(F.group_norm(...))``), and the bounds:
    the statistics read x and write two [B, C] fp32, the apply reads x, w
    and shift and writes y, the whole op reads x and writes y at least once
    each. ``max_abs_err`` of the statistics row is that of Σx/N and Σx²/N,
    the mean and E[x²] the fold takes."""
    g = torch.Generator(device="cuda").manual_seed(6)
    failed = []
    for shape, dtype in [(s, torch.bfloat16) for s in GN_SHAPES] + GN_RAGGED:
        b, c = shape[:2]
        n = shape[2] * shape[3]
        # 32 groups where C allows, else the most that leave a group 32
        # elements: a group of a few elements can have var ≪ eps, and inv up to
        # rsqrt(eps) ≈ 316, where the scale and shift rounded to bf16 (JAX's
        # rounding, the plain version's too) leave y off by an ulp of 316·x;
        # the statistics check below holds the rows of one element
        groups = next(k for k in (32, 16, 8, 4, 2, 1) if c % k == 0 and n * c // k >= 32)
        main = shape in GN_SHAPES and dtype == torch.bfloat16
        x0 = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
        gw = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        gb = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
        w = (1 + 0.1 * torch.randn(b, c, generator=g, device="cuda")).to(dtype)
        shift = (0.1 * torch.randn(b, c, generator=g, device="cuda")).to(dtype)
        rs, rss, mag = (torch.empty(b, c, dtype=torch.float64, device="cuda") for _ in range(3))
        for i in range(b):  # fp64 one sample at a time: a few GiB at the largest shapes
            xi = x0[i].double().reshape(c, n)
            rs[i], rss[i], mag[i] = xi.sum(-1), (xi * xi).sum(-1), xi.abs().sum(-1)
            del xi
        count = n * (c // groups)  # the per-group mean and inv in fp64, from the channel sums
        mean64 = rs.reshape(b, groups, -1).sum(-1) / count
        inv64 = torch.rsqrt(torch.clamp(rss.reshape(b, groups, -1).sum(-1) / count - mean64 * mean64, min=0.0) + 1e-5)
        want64 = (mean64, inv64)
        want = [norms.group_norm_reference(x0.float(), groups, gw.float(), gb.float(), 1e-5, act)[0]
                for act in (None, "silu")]
        for layout in ("NCHW", "NHWC"):
            x = x0 if layout == "NCHW" else x0.to(memory_format=torch.channels_last)
            y, mean, inv = norms.group_norm_forward(x, groups, gw, gb, 1e-5)
            y_act = norms.group_norm(x, groups, gw, gb, 1e-5, act="silu")
            again = norms.group_norm(x, groups, gw, gb, 1e-5, act="silu")
            alone = norms.group_norm(x[1:2], groups, gw, gb, 1e-5, act="silu")
            torch.cuda.synchronize()
            gn_exact = torch.equal(again, y_act) and torch.equal(alone[0], y_act[1])
            layout_ok = y.stride() == x.stride() and y_act.stride() == x.stride()
            stats = norms.group_norm_errors((y, y_act, mean, inv), want, want64)
            gate_ok, report = norms.group_norm_gate(stats)
            kind = norms.group_norm_plan(x.shape, groups, layout == "NHWC", dtype)[0]
            del y, y_act, again, alone, mean, inv
            s, ss = norms.group_norm_stats(x)
            again = norms.group_norm_stats(x)
            alone = norms.group_norm_stats(x[1:2])
            torch.cuda.synchronize()
            exact = (torch.equal(again[0], s) and torch.equal(again[1], ss) and torch.equal(alone[0][0], s[1])
                     and torch.equal(alone[1][0], ss[1]))
            del again, alone
            stats_ok = bool(((s.double() - rs).abs() <= GN_STATS_TOL * mag).all()
                            and ((ss.double() - rss).abs() <= GN_STATS_TOL * rss).all())
            err = max((s.double() - rs).abs().max().item(), (ss.double() - rss).abs().max().item()) / n
            y = norms.group_norm_apply(x, w, shift, "silu")
            ref = norms.group_norm_apply_reference(x, w, shift, "silu")
            torch.cuda.synchronize()
            apply_ok = y.stride() == x.stride() and (within_bf16_ulp(y, ref) if dtype == torch.bfloat16 else bool(
                (y - ref).abs().le(1e-6 * ref.abs().clamp(min=1.0)).all()))
            apply_err = (y.float() - ref.float()).abs().max().item()
            del y, ref
            times = ""
            if timed and main:
                ms_s = median_ms(lambda: norms.group_norm_stats(x))
                ms_a = median_ms(lambda: norms.group_norm_apply(x, w, shift, "silu"))
                whole = median_ms(lambda: norms.group_norm(x, groups, gw, gb, 1e-5, act="silu"))
                plain_s = median_ms(lambda: norms.group_norm_stats_reference(x))
                plain_a = median_ms(lambda: norms.group_norm_apply_reference(x, w, shift, "silu"))
                plain_w = median_ms(lambda: norms.group_norm_reference(x, groups, gw, gb, 1e-5, "silu"))
                times = (f"; statistics {ms_s:.4f} ms (plain {plain_s:.4f}), apply+SiLU {ms_a:.4f} ms "
                         f"(plain {plain_a:.4f}), kernel {whole:.4f} ms the whole group_norm+SiLU "
                         f"(plain {plain_w:.4f})")
            if timed and main and layout == "NHWC":  # the paths' layout: the rows of the kernels line
                lib_s = library_ms(lambda: lambda: torch.var_mean(x.reshape(b, c, n), dim=-1))
                lib_a = library_ms(lambda: lambda: F.silu(F.group_norm(x, groups, gw, gb, 1e-5)))
                nbytes = x.numel() * x.element_size()
                b_s = bound(3 * x.numel(), nbytes + 8 * b * c, FP32_OPS_PER_S)
                b_a = bound(8 * x.numel(), 2 * nbytes + 2 * b * c * x.element_size(), FP32_OPS_PER_S)
                # the whole op: x read once (twice under plan (b)) and y written once
                reads = 1 if kind == "resident" else 2
                b_w = bound(11 * x.numel(), (reads + 1) * nbytes + 2 * c * x.element_size(), FP32_OPS_PER_S)
                add_times(results["group_norm_stats"], ms_s, plain_s, lib_s, b_s)
                add_times(results["group_norm_apply"], ms_a, plain_a, lib_a, b_a)
                if kind == "resident":
                    add_times(results["group_norm_fused"], whole, plain_w, lib_a, b_w)
                times += (f"; library var_mean {fmt_ms(lib_s)}, group_norm+silu {fmt_ms(lib_a)}; bound statistics "
                          f"{b_s[0]:.4f} ({b_s[1]}), apply {b_a[0]:.4f} ({b_a[1]}), whole {b_w[0]:.4f} ({b_w[1]})")
            ok = gate_ok and gn_exact and layout_ok and stats_ok and exact and apply_ok
            if kind == "resident":
                r = results["group_norm_fused"]
                r["max_abs_err"] = max(r["max_abs_err"], stats["y"]["max_err"], stats["silu"]["max_err"])
            print(f"group_norm {str(shape):21s} {str(dtype)[6:]:8s} {layout} G={groups} plan {kind}: "
                  f"{'pass' if ok else 'FAIL'}: "
                  f"{report}; alone == batched and run == run {gn_exact}, y in x's layout {layout_ok}; statistics: "
                  f"Σx, Σx² within {GN_STATS_TOL} {stats_ok} (mean/E[x²] max|err| {err:.3e}), alone == batched "
                  f"and run == run {exact}; apply within one ulp {apply_ok} (max|err| {apply_err:.3e}){times}")
            if not ok:
                failed.append((shape, str(dtype), layout))
            results["group_norm_stats"]["max_abs_err"] = max(results["group_norm_stats"]["max_abs_err"], err)
            results["group_norm_apply"]["max_abs_err"] = max(results["group_norm_apply"]["max_abs_err"],
                                                             apply_err)
            del x, s, ss
        del x0, w, shift, rs, rss, mag, want, want64, mean64, inv64
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"GroupNorm disagrees with its plain version at {failed}")


def within_bf16_ulp(got, want, floor=0.0) -> bool:
    """|got − want| ≤ one bf16 ulp of ``want`` (or ``floor``, where larger)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w), torch.ldexp(torch.ones_like(w), e - 8))
    return bool(((got.float() - w).abs() <= torch.clamp(ulp, min=floor)).all())


def check_int8_gemm(gemm, results, timed=True):
    """K11 at every int8 shape of the SDXL path and the extra cases: its
    int32 sums (the raw-sums epilogue) equal the plain version's; its bf16
    output within one ulp of the plain version's (the epilogue runs in the
    same fp32 order, so exactly equal without gelu; with tanh-gelu, 1e-6
    absolute where 1 + tanh(u) cancels in the negative tail). Every case
    printed with its plan, then a raise listing the failures. With
    ``timed``, the kernel's time, and at the path's shapes the plain
    version's, the library's and the bound: 2·M·K·N int8 operations at
    1979 TOP/s, or xq, wq, the two scales read and the bf16 output written
    once at 3.35 TB/s."""
    g = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
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
        main = (m, k, n) in INT8_SHAPES and not epilogue
        plan = gemm.int8_gemm_plan(m, k, n, sms)
        times = f"; plan split {plan.split}"
        if timed:
            ms = median_ms(lambda: gemm.int8_gemm(xq, sx, wq, sw, bias, act))
            times += f"; kernel {ms:.4f} ms"
        if timed and main:
            plain = median_ms(lambda: gemm.int8_gemm_reference(xq, sx, wq, sw))
            library = library_ms(lambda: lambda: (torch._int_mm(xq, wq.t()).float() * sx[:, None] * sw).to(
                torch.bfloat16))
            bnd = bound(2 * m * k * n, m * k + k * n + 4 * (m + n) + 2 * m * n, INT8_OPS_PER_S)
            times += f", plain {plain:.4f} ms, library {fmt_ms(library)} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
        ok = sums_equal and close
        print(f"int8_gemm M={m:5d} K={k:4d} N={n:5d}{' bias+gelu' if epilogue else ''}: {'pass' if ok else 'FAIL'}: "
              f"int32 sums equal {sums_equal}; bf16 max|err| {err:.3e} (within one ulp{' or 1e-6' if act else ''}: "
              f"{close}){times}")
        if not ok:
            failed.append((m, k, n, epilogue))
        r = results["int8_gemm"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed and main:
            add_times(r, ms, plain, library, bnd)
        del xq, wq, sums, y, ref
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8 GEMM kernel disagrees with its plain version at {failed}")


def pair_kernels(attention, kernels, q, k, v, o, lse, do, scale, kv_valid):
    """K6 and K7 each alone, launched as ``flash_attention_bwd_bhsd``
    launches them (and not counted), for their separate times."""
    bh, sq, d = q.shape
    kv_len = kv_valid or k.shape[1]
    lib = kernels.library()
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (bh, sq, k.shape[1], d, kv_len, float(scale))
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


def check_attention_bwd(attention, kernels, results, timed=True):
    """K6+K7 and K8 against ``attention_bwd_reference`` in fp32, held to
    ``attention_bwd_gate`` (for each of dq, dk, dv: max|err| ≤ 4e-3 +
    2⁻⁶·max|ref|, relative L2 ≤ 1e-2; dk and dv exactly 0 at rows past
    ``kv_valid``). On the ragged cases the keys at or past ``kv_valid`` are
    k × 3 and v + 1, so that any read of them shows. With ``timed``, at the
    training step's shapes also their times, the plain version's, the
    library's and the bound. Operations as the JAX ``pl.CostEstimate``
    counts them: 10·BH·Sq·KV·D for K8, 5·BH·Sq·KV·D each for K6 and K7
    (the kernels do 8 and 6: S and dP are recomputed in each). Bytes: K8's
    wrapper reads q, k, v, o, dO, lse and writes dq, dk, dv; K6 reads q, dO,
    k, v, lse, Δ and writes dk, dv; K7 the same, writing dq. Raises after
    the last shape if any failed."""
    g = torch.Generator(device="cuda").manual_seed(3)
    failed = []
    for shape in BWD_SHAPES + BWD_RAGGED:
        bh, sq, skv, d, kv_valid = shape
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device="cuda").to(torch.bfloat16)
                       for s in (sq, skv, skv, sq))
        if kv_valid is not None:
            k[:, kv_valid:] *= 3
            v[:, kv_valid:] += 1
        scale = d ** -0.5
        kv_len = kv_valid or skv
        route = attention.attention_bwd_plan(kv_len, d)[0]
        o, lse = attention.flash_attention_bhsd(q, k, v, scale, kv_valid)
        grads = attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid)
        torch.cuda.synchronize()
        stats = None
        step = max(1, 2 ** 26 // (sq * skv))  # the fp32 reference, a few GiB at a time
        for i in range(0, bh, step):
            sl = slice(i, i + step)
            ref = attention.attention_bwd_reference(
                *(t[sl].float() for t in (q, k, v, o)), lse[sl], do[sl].float(), scale, kv_valid)
            part = attention.attention_bwd_errors([t[sl] for t in grads], ref, kv_valid)
            stats = part if stats is None else attention.merge_bwd_errors(stats, part)
            del ref
        del grads
        ok, report = attention.attention_bwd_gate(stats)
        err = [s["max_err"] for s in stats]
        main = shape in BWD_SHAPES
        times = ""
        if timed:
            ms = median_ms(lambda: attention.flash_attention_bwd_bhsd(q, k, v, o, lse, do, scale, kv_valid))
            times = f"; kernel {ms:.4f} ms"
        if timed and main:
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
                if library:
                    times += f"; K6 + K7 / library {(ms_dkv + ms_dq) / library:.2f}x"
                add_times(results["flash_bwd_dkv"], ms_dkv, plain, library, b_dkv)
                add_times(results["flash_bwd_dq"], ms_dq, plain, library, b_dq)
        print(f"attention backward {route:17s} bh={bh:2d} sq={sq:5d} kv={skv:5d} d={d:3d} kv_valid={kv_valid}"
              f"{' (k x3, v +1 past it)' if kv_valid else ''}: {'pass' if ok else 'FAIL'}: {report}{times}")
        if not ok:
            failed.append(shape)
        if route == "flash_bwd_oneshot":
            rows = [(results[route], max(err))]
        else:
            rows = [(results["flash_bwd_dkv"], max(err[1:])), (results["flash_bwd_dq"], err[0])]
        for r, e in rows:
            r["max_abs_err"] = max(r["max_abs_err"], e)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attention backward disagrees with its plain version at {failed}")


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


def cpu_reference(pipe, model: str):
    """The pipeline's modules as an fp32 copy on the CPU (the plain paths),
    with the pipeline's served weights (int8 ones in int8 mode)."""
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
    return ref


def check_reference(pipe, model: str, label: str = ""):
    """The pipeline's own modules at 128² on one prompt: bf16 on the card
    through the kernels vs ``cpu_reference``."""
    ref = cpu_reference(pipe, model)
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


def check_mode_references(pipe, counters):
    """Phase 4c: each of ``SDXL_MODES`` at 512² (the least size whose
    640-channel level has 1024 tokens, M = 1024: all three kernels run), one
    prompt, one step (to bound the CPU's time), on the card against the
    fp32 CPU copy under the same switches (the plain versions), same
    latents and noise: images within 0.1, as 4b, and the mode's kernels
    launched on the card."""
    ref = cpu_reference(pipe, "sdxl")
    g = torch.Generator().manual_seed(12)
    latents = torch.randn(1, 64, 64, 4, generator=g)
    noise = [torch.randn(1, 64, 64, 4, generator=g)]
    kw = dict(latents=latents, noise=noise, num_inference_steps=1, height=512, width=512)
    for path, env, exact in SDXL_MODES:
        with switches(env):
            reset(counters)
            got = pipe.generate(PROMPTS[:1], **kw).cpu()
            torch.cuda.synchronize()
            launches = {k: n for d in counters for k, n in d.items()}
            want = ref.generate(PROMPTS[:1], **kw)
        err = rel_l2(got, want)
        ran = {k: launches[k] for k, n in exact.items() if n}
        print(f"sdxl {path} reference at 512², 1 prompt, 1 step: images (bf16 on the card vs fp32 on the CPU, "
              f"same switches) rel L2 err {err:.3e} (tol 0.1), max|err| {(got - want).abs().max().item():.3e}; "
              f"the mode's kernels on the card {ran}")
        if not (err <= 0.1 and torch.isfinite(got).all() and all(ran.values())):
            raise AssertionError(f"the card's sdxl {path} mode disagrees with the fp32 reference at 512²")


def run_path(pipe, model, hw, counters, card, required):
    """One main path through ``generate``: counts reset just before and read
    just after, the launched kernels checked, then warm s/batch. Returns
    (launches, the images of the first run)."""
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
    return launches, images


@contextlib.contextmanager
def switches(env):
    """The JAX package's kernel switches set to ``env`` (the others unset)
    inside the block, as they were after it."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def run_modes(pipe, default_images, counters, card):
    """Phase 3c: SDXL 1024² ``generate`` in each of ``SDXL_MODES`` on the
    pipeline of phase 3b, through ``run_path`` (counts reset just before,
    warm s/batch after): the launch counts exact, the images within
    MODE_IMAGE_TOL of the default mode's. Returns {path: launches}."""
    by_path = {}
    for path, env, exact in SDXL_MODES:
        with switches(env):
            launches, images = run_path(pipe, f"sdxl {path}", 1024, counters, card, [k for k, n in exact.items() if n])
        err = rel_l2(images, default_images)
        wrong = {k: launches[k] for k, n in exact.items() if launches[k] != n}
        print(f"sdxl {path} ({' '.join(f'{k}={v}' for k, v in env.items())}): images vs the default mode's, rel "
              f"L2 {err:.3e} (tol {MODE_IMAGE_TOL}); launch counts {'exact' if not wrong else wrong} "
              f"(expected {exact})")
        if wrong or not err <= MODE_IMAGE_TOL:
            raise AssertionError(f"the sdxl {path} mode launched {wrong} or its images differ by {err:.3e}")
        by_path[path] = launches
        del images
    return by_path


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
    sample's own seed), at 128², held to the contract of
    ``FlashPipeline.generate`` (cuDNN's and cuBLAS's batch-size-dependent
    algorithms; the port's own ops are exact)."""
    alone = pipe.generate(PROMPTS[1:2], seed=[21], height=128, width=128)
    batch = pipe.generate(PROMPTS, seed=[20, 21, 22, 23], height=128, width=128)
    err = rel_l2(alone[0].float().cpu(), batch[1].float().cpu())
    other = rel_l2(batch[0].float().cpu(), batch[1].float().cpu())
    print(f"sdxl int8 at 128²: request alone vs slot 1 of a batch of 4, rel L2 {err:.3e} (tol "
          f"{BATCH_INVARIANCE_TOL}; another seed's image differs by {other:.3e})")
    if not err <= BATCH_INVARIANCE_TOL:
        raise AssertionError("a request's image depends on its batch beyond the contract")


class FixedConditioner(torch.nn.Module):
    """A conditioner that returns one conditioning, whatever the batch:
    phase 7b hands the card's T5 output to the CPU copy through it."""

    def __init__(self, cond):
        super().__init__()
        self.cond = cond

    def forward(self, batch, ucg_keys=None, set_ucg_rate_zero=False):
        return {"cond": self.cond}


def check_pixart_reference(pipe):
    """Phase 7b: T5-XXL at full width and 2 layers on the card (fp32)
    against its CPU copy (rel. L2 1e-4) on 120 ids with a padded mask; then
    the pipeline's DiT and VAE at full size on one prompt at 128² (bf16,
    kernels) against an fp32 CPU copy (plain paths), both on the card's T5
    output and the same latents and step noise (images: rel. L2 0.1)."""
    from flash_diffusion_tpu_torch import FlashPipeline
    from flash_diffusion_tpu_torch.models import T5Encoder, t5_xxl_config
    from flash_diffusion_tpu_torch.sample import build_modules

    cfg = t5_xxl_config(num_layers=2)
    with torch.random.fork_rng(devices=[0]):
        torch.manual_seed(3)
        with torch.device("cuda"):
            t5 = T5Encoder(cfg).eval()
    with torch.device("meta"):
        t5_ref = T5Encoder(cfg)
    t5_ref = cpu_fp32_copy(t5.state_dict(), t5_ref)
    g = torch.Generator().manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (2, 120), generator=g)
    mask = (torch.arange(120)[None] < torch.tensor([[37], [120]])).long()
    with torch.inference_mode():
        t5_err = rel_l2(t5(ids.cuda(), mask.cuda()).cpu(), t5_ref(ids, mask))
    del t5, t5_ref
    torch.cuda.empty_cache()

    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    print("host memory (GiB) before the fp32 copy: " + " | ".join(free.splitlines()[:2]))
    with torch.device("meta"):
        dit, vae, _, _, _ = build_modules("pixart")
    batch = dict(pipe.tokenizer_fn(PROMPTS[:1]))
    batch.update(pipe.size_cond_fn(1, 128, 128))
    with torch.inference_mode():
        cond = pipe._embed(batch)["cond"]
    ref = FlashPipeline(cpu_fp32_copy(pipe.state, dit), FixedConditioner(to_cpu(cond)),
                        cpu_fp32_copy(pipe.vae.state_dict(), vae), pipe.tokenizer_fn, pipe.latent_shape,
                        scheduler_config=pipe.sched_config)
    ref.size_cond_fn = pipe.size_cond_fn
    g = torch.Generator().manual_seed(7)
    latents = torch.randn(1, 16, 16, 4, generator=g)
    noise = [torch.randn(1, 16, 16, 4, generator=g) for _ in range(4)]
    got = pipe.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128).cpu()
    want = ref.generate(PROMPTS[:1], latents=latents, noise=noise, height=128, width=128)
    img_err = rel_l2(got, want)
    print(f"pixart reference: T5-XXL at 2 layers (fp32 on the card vs the CPU) rel L2 err {t5_err:.3e} (tol 1e-4); "
          f"DiT + VAE at 128², 1 prompt, on the card's T5 output: images (bf16 on the card vs fp32 on the CPU) "
          f"rel L2 err {img_err:.3e} (tol 0.1), max|err| {(got - want).abs().max().item():.3e}")
    if not (t5_err <= 1e-4 and img_err <= 0.1 and torch.isfinite(got).all()):
        raise AssertionError("the card's pixart slice disagrees with the fp32 reference on a small input")


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
    for k in SWITCHES:  # each phase sets the modes it drives; the others run the port's defaults
        os.environ.pop(k, None)
    from flash_diffusion_tpu_torch.ops import attention, gemm, kernels, norms
    from flash_diffusion_tpu_torch.sample import build_pipeline

    # phase 1: device and build
    started = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc {kernels.BUILD_INFO['seconds']:.2f} s "
          f"-> {kernels.BUILD_INFO['path']}")
    entry, entries, spill_report, serialized = "", set(), [], []
    if kernels.BUILD_INFO["log"] == "(cached)":
        print("  no ptxas report: the library was built before this run (delete build/kernels to see it)")
    for line in kernels.BUILD_INFO["log"].splitlines():  # ptxas -v: one report per kernel
        if "Compiling entry function" in line:
            name = re.search(r"(?<=\d)(flash_(?:fwd|bwd)_\w+?_kernel|layer_norm_(?:rows|wide)_kernel|int8_gemm_kernel|"
                             r"gemm_sm90_kernel|geglu_gemm_kernel|"
                             r"gn_(?:stats|apply|resident)_n(?:chw|hwc)_kernel)(I\w+?E)?E", line)
            entry = name.group(1) + (name.group(2) or "") if name else line.split("'")[1]
            entries.add(entry)
        elif "wgmma" in line and "serializ" in line:  # products that ptxas could not keep in flight
            print(f"  ptxas {entry}: {line.strip()}")
            serialized.append(f"{entry}: {line.strip()}")
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            if "spill" in line and not re.search(r" 0 bytes spill stores, 0 bytes spill loads", line):
                spill_report.append(f"{entry}: {line.strip()}")
    for _, _, kv, d, _ in ATTENTION_SHAPES + ATTENTION_SHAPES_XL + ATTENTION_SHAPES_PIXART:  # the one-shot plan mirrors the kernel's layout
        kind, bq = attention.attention_plan(kv, d)
        kvp, dp = -(-kv // 16) * 16, -(-d // 16) * 16
        if kind == "flash_fwd_oneshot" and lib.fdt_attn_smem_bytes(bq, kvp, dp) != attention.smem_bytes(bq, kvp, dp):
            raise AssertionError(f"shared-memory plan and kernel layout disagree at kv={kv} d={d}")
    for _, _, kv, _, d in PACKED_SHAPES + PACKED_RAGGED:  # K4: K1's kernel at K1's plan
        bq, kvp = attention.packed_oneshot_tile(kv, d), -(-kv // 16) * 16
        if not lib.fdt_attn_smem_bytes(bq, kvp, d) == attention.smem_bytes(bq, kvp, d) <= attention._SMEM_LIMIT:
            raise AssertionError(f"K4 shared-memory plan and kernel layout disagree at kv={kv} d={d}")
    for d in range(8, 161, 8):  # K8's tiles, at every head dim and KV it could take
        for kv in range(1, 257):
            got = (ctypes.c_int * 5)()
            err = lib.fdt_flash_bwd_oneshot_tiles(kv, d, got)
            want = attention.bwd_oneshot_tiles(kv, d)
            if (err == 0) != (want is not None) or (want is not None and tuple(got) != tuple(want)):
                raise AssertionError(f"K8 tiles at kv={kv} d={d}: kernel {tuple(got)} (error {err}), plan {want}")
    for d in range(8, 513, 8):  # the pair's tiles, at every head dim it takes
        for which, want in enumerate(attention.bwd_pair_tiles(d)):
            got = (ctypes.c_int * 7)()
            kernels.check(lib.fdt_flash_bwd_pair_tiles(which, d, got), "fdt_flash_bwd_pair_tiles")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K{6 + which} tiles at d={d}: kernel {tuple(got)}, plan {tuple(want)}")
    for d in range(8, 513, 8):  # K2's tiles at every head dim: the wgmma kernel's up to 128, the other's above
        want, got = attention.stream_fwd_tiles(d), (ctypes.c_int * 6)()
        err = lib.fdt_flash_fwd_wgmma_tiles(d, got)
        if (err == 0) != (want.route == "wgmma") or (err == 0 and tuple(got) != (
                want.dp, want.bq, want.bkv, want.stages, want.threads, want.smem)):
            raise AssertionError(f"K2 tiles at d={d}: kernel {tuple(got)} (error {err}), plan {want}")
    for m, k, n in FFN_SHAPES + FFN_RAGGED + FFN_DW_SHAPES:  # K10's plan, and every tile width it is built for
        for bn in (None, 112, 128, 160, 224, 256):
            want, got = gemm.gemm_plan(k, n, bn), (ctypes.c_int * 4)()
            kernels.check(lib.fdt_gemm_plan(k, n, bn or 0, got), "fdt_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K10 plan at K={k} N={n} bn={bn}: kernel {tuple(got)}, plan {tuple(want)}")
        for bn, cluster in ((None, None), (160, 1), (128, 1)):  # K12's plan, and its other built variants
            want, got = gemm.geglu_gemm_plan(k, n, bn, cluster), (ctypes.c_int * 5)()
            kernels.check(lib.fdt_geglu_gemm_plan(k, n, bn or 0, cluster or 0, got), "fdt_geglu_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K12 plan at K={k} N={n} ({bn}, {cluster}): kernel {tuple(got)}, plan {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, *_ in [(*s, False) for s in INT8_SHAPES] + INT8_EXTRA:  # K11's plan, here and on 132 SMs
        for on, split in [(c, None) for c in (sms, 132)] + [(sms, s) for s in (1, 2, 4, 8)]:
            want, got = gemm.int8_gemm_plan(m, k, n, on, split), (ctypes.c_int * 6)()
            kernels.check(lib.fdt_int8_gemm_plan(m, n, k, on, split or 0, got), "fdt_int8_gemm_plan")
            if tuple(got) != tuple(want):
                raise AssertionError(f"K11 plan at {(m, k, n)} on {on} SMs (split {split}): kernel {tuple(got)}, "
                                     f"plan {want}")
    spills = [line for line in spill_report if any(k in line for k in (
        "flash_fwd_oneshot_kernel", "flash_fwd_wgmma_kernel", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_oneshot_kernel", "gemm_sm90_kernel", "int8_gemm_kernel"))]
    spills += [line for line in serialized if any(k in line for k in (
        "flash_fwd_wgmma_kernel", "gemm_sm90_kernel", "int8_gemm_kernel"))]
    # instantiations that must have a report of their own, by their template
    # arguments: the packed K4 and K5 (<DP, kPacked = true> of K1's and K2's
    # kernels), K12 (<BN, kCluster, kGeglu = true> of K10's) and K11
    # (<kSplit>)
    own = [f"{kernel}ILi{dp}ELb1E" for kernel in ("flash_fwd_oneshot_kernel", "flash_fwd_wgmma_kernel")
           for dp in (64, 128)]
    own += [f"gemm_sm90_kernelILi{bn}ELi{c}ELb1E" for bn, c in ((160, 8), (160, 4), (160, 1), (128, 1))]
    own += [f"int8_gemm_kernelILb{split}E" for split in (0, 1)]
    missing = [name for name in own if kernels.BUILD_INFO["log"] != "(cached)" and name not in entries]
    if spills or missing:
        raise AssertionError(f"K1/K2/K4/K5/K6/K7/K8/K10/K11/K12 instantiations spill registers, or K2/K5/K10/K11/K12 "
                             f"serialize their wgmma: {spills}; no ptxas report of {missing}")

    results = {
        "flash_fwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention.cu",
                                     "flash_diffusion_tpu/ops/attention.py:171"),
        # D ≤ 128 on the wgmma kernel, above (the VAE's D = 512) on the mma.sync one
        "flash_fwd_stream": dict(new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                         "flash_diffusion_tpu/ops/attention.py:85"),
                                 source_above_d128="flash_diffusion_tpu_torch/csrc/flash_fwd_mma.cu"),
        "layer_norm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/layer_norm.cu",
                              "flash_diffusion_tpu/ops/norms.py:317"),
        # K4 and K5: K1's and K2's kernels instantiated on the packed layout
        "flash_fwd_oneshot_packed": new_row("cuda", "flash_diffusion_tpu_torch/csrc/attention.cu",
                                            "flash_diffusion_tpu/ops/attention.py:292"),
        "flash_fwd_packed": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
                                    "flash_diffusion_tpu/ops/attention.py:223"),
        "flash_bwd_dkv": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                 "flash_diffusion_tpu/ops/attention.py:635"),
        "flash_bwd_dq": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd.cu",
                                "flash_diffusion_tpu/ops/attention.py:703"),
        "flash_bwd_oneshot": new_row("cuda", "flash_diffusion_tpu_torch/csrc/flash_bwd_oneshot.cu",
                                     "flash_diffusion_tpu/ops/attention.py:769"),
        "gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/gemm_sm90.cu", "flash_diffusion_tpu/ops/gemm.py:36"),
        "int8_gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/int8_gemm.cu",
                             "flash_diffusion_tpu/ops/gemm.py:171"),
        # K12: K10's kernel with the GEGLU producer (kGeglu = true)
        "geglu_gemm": new_row("cuda", "flash_diffusion_tpu_torch/csrc/gemm_sm90.cu",
                              "flash_diffusion_tpu/ops/gemm.py:271"),
        "group_norm_stats": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "flash_diffusion_tpu/ops/norms.py:40"),
        # the port's own fused normalize pass: no TPU kernel (JAX leaves
        # x·ŵ + b̂ to XLA, which fuses it into the next convolution)
        "group_norm_apply": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "none (XLA-fused in JAX: flash_diffusion_tpu/ops/norms.py:166)"),
        # the resident GroupNorm: K9's statistics with the fold and the apply
        # that JAX leaves to XLA, in one launch
        "group_norm_fused": new_row("cuda", "flash_diffusion_tpu_torch/csrc/group_norm.cu",
                                    "flash_diffusion_tpu/ops/norms.py:40 (K9, with the fold and apply of "
                                    "norms.py:137-149)"),
    }
    # phase 2: kernels vs plain at the main paths' shapes
    check_attention(attention, results)
    check_packed(attention, results, "flash_fwd_oneshot_packed", PACKED_SHAPES, PACKED_RAGGED, 2)
    check_packed(attention, results, "flash_fwd_packed", PACKED_STREAM_SHAPES, PACKED_STREAM_RAGGED, 10)
    check_layer_norm(norms, results)
    check_group_norm(norms, results)
    check_attention_bwd(attention, kernels, results)
    check_int8_gemm(gemm, results)
    check_ffn_gemm(gemm, results)
    torch.cuda.empty_cache()

    # phases 3 and 4: the SD1.5 path through the user's entry point, then
    # its agreement with the fp32 plain reference on a small input
    counters = (attention.LAUNCHES, norms.LAUNCHES, gemm.LAUNCHES)
    gn = ("group_norm_stats", "group_norm_apply", "group_norm_fused")
    pipe = build_pipeline("sd15", device="cuda", seed=0)
    by_path = {"sd15": run_path(pipe, "sd15", 512, counters, card,
                                ("flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", *gn))[0]}
    check_reference(pipe, "sd15")
    del pipe
    torch.cuda.empty_cache()

    # phases 3b and 4b: the SDXL path, then its reference; 3c and 4c: the
    # same pipeline in the JAX package's opt-in kernel modes (K5 and K12,
    # then K10), then their references
    pipe = build_pipeline("sdxl", device="cuda", seed=0)
    by_path["sdxl"], images = run_path(pipe, "sdxl", 1024, counters, card,
                                       ("flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", *gn))
    check_reference(pipe, "sdxl")
    by_path.update(run_modes(pipe, images, counters, card))
    del images
    check_mode_references(pipe, counters)
    del pipe
    torch.cuda.empty_cache()

    # phases 5 and 5b: the training step through the user's entry point,
    # then its agreement with the fp32 plain reference on a small input
    by_path["train"] = run_training(counters, card, (
        "flash_fwd_oneshot", "flash_fwd_stream", "layer_norm", "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_oneshot", *gn))
    torch.cuda.empty_cache()
    check_training_reference()
    torch.cuda.empty_cache()

    # phases 6 and 6b: SDXL served over HTTP in int8 with a merged LoRA,
    # then its agreement with the fp32 plain reference and batch invariance
    by_path["sdxl_int8_serve"], pipe = run_int8_serving(counters, card, (
        "flash_fwd_stream", "layer_norm", "flash_fwd_oneshot_packed", "int8_gemm", *gn))
    check_reference(pipe, "sdxl", "sdxl int8 + LoRA")
    check_batch_invariance(pipe)
    del pipe
    torch.cuda.empty_cache()

    # phases 7 and 7b: Pixart-α 1024² (T5-XXL in fp32, the DiT), then its
    # references: T5 at full width and 2 layers, the DiT and VAE at full
    # size at 128² on the same T5 output
    pipe = build_pipeline("pixart", device="cuda", seed=0)
    by_path["pixart"] = run_path(pipe, "pixart", 1024, counters, card, ("flash_fwd_stream", "layer_norm", *gn))[0]
    check_pixart_reference(pipe)
    del pipe
    torch.cuda.empty_cache()

    print(f"every phase passed in {time.perf_counter() - started:.1f} s (the kernels' build included)")
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
