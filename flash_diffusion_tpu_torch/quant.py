"""int8 W8A8 inference quantization of the port: per-channel weights,
per-token activations, the products on the int8 GEMM kernel.

Port of ``flash_diffusion_tpu/quant.py`` (``quantize_weight``,
``int8_matmul``, ``quantize_dense``). ``quantize_dense`` turns the float
weights of the UNet's, the DiT's or the MMDiT's ``LoraDense`` layers in a state dict
into int8 codes
with an fp32 per-output-channel scale beside each (``<layer>.weight_scale``);
``apply_weights`` points the module's parameters at such a state; the
layers (``models/layers.py lora_dense``) branch on the int8 weight dtype and
call ``int8_matmul``, which quantizes the activations per token in plain
PyTorch (XLA outside the Pallas kernel in JAX) and multiplies through
``ops/gemm.py int8_gemm``. Inference only: nothing differentiates through
int8 weights. Not ported yet: ``int8_conv`` and the ``QConv`` branch
(reached only by the JAX ``--int8-convs``/``--int8-vae`` tools).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .ops.gemm import int8_gemm

# state-dict name of a quantized layer's per-output-channel weight scale,
# a buffer beside its int8 ``weight``
SCALE_KEY = "weight_scale"

# The layers with an int8 branch (the JAX allowlist of ``quant.py:44-47``
# over the port's names): attention q/k/v/out, the spatial transformers'
# proj_in/proj_out and the feed-forward's two (JAX ff/proj_in and
# ff/proj_out of the GEGLU, ff_in and ff_out of the DiT: 28 × 10 = 280
# layers in Pixart-α), and the MMDiT's context-stream out and feed-forward
# (JAX to_add_out, ff_context_in, ff_context_out: 23 × 9 + 6 = 213 layers in
# SD3-medium; its add_q/k/v_proj stay float, as JAX's allowlist leaves
# them). The leading dot keeps a root-level ``proj_out`` (a DiT's or an
# MMDiT's unembedding head) out, as the JAX depth rule does.
DENSE_INCLUDE = (r"\.(to_q|to_k|to_v|to_out\.0|to_add_out|proj_in|proj_out|ff\.net\.0\.proj|ff\.net\.2"
                 r"|ff_context\.net\.0\.proj|ff_context\.net\.2)$")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float weight [out, in] (or a 1×1 conv's [out, in, 1, 1]) → (int8
    codes of the same shape, fp32 scale [out]), w ≈ codes · scale. Reduces
    over the input dims, as JAX reduces axis 0 of its [in, out] kernel."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.dim())))
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale.reshape(-1, *(1,) * (w.dim() - 1))).clamp(-127, 127)
    return q.to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic quantization of ``x`` [..., K]: (int8 codes
    [..., K], fp32 scale [..., 1]). A division, not a multiplication by a
    reciprocal, and round half to even, as ``jnp.round(xf / s_x)``."""
    xf = x.float()
    s_x = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / s_x).clamp(-127, 127).to(torch.int8), s_x


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """W8A8 product ``x [..., K] · wq [N, K]ᵀ`` in x's dtype: the
    activations quantized per token, the int8 product and its dequant on
    the kernel (bf16 out). An fp32 ``x`` gets fp32 out, as on JAX's XLA
    route; only the plain version (the CPU) computes that."""
    xq, s_x = quantize_activation(x)
    k, n = x.shape[-1], wq.shape[0]
    out_dtype = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    y = int8_gemm(xq.reshape(-1, k), s_x.reshape(-1), wq, w_scale, out_dtype=out_dtype)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def quantize_dense(
    state: Dict[str, torch.Tensor], min_dim: int = 256, include: Optional[str] = DENSE_INCLUDE,
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Quantize the eligible weights of a state dict; returns (new state,
    number quantized). A ``<layer>.weight`` is eligible when it is float,
    2-D (or a 1×1 conv's 4-D), both its dims are ≥ ``min_dim``, and the
    layer's name matches ``include`` (None: any). Each gets int8 codes in
    place of its weight and a ``<layer>.weight_scale``; every other entry
    passes through as the same tensor."""
    inc = re.compile(include) if include else None
    out, count = dict(state), 0
    for key, w in state.items():
        name, _, leaf = key.rpartition(".")
        if leaf != "weight" or not w.is_floating_point():
            continue
        if not (w.dim() == 2 or (w.dim() == 4 and tuple(w.shape[2:]) == (1, 1))):
            continue
        if min(w.shape[0], w.shape[1]) < min_dim:
            continue
        if inc is not None and not inc.search(name):
            continue
        out[key], out[f"{name}.{SCALE_KEY}"] = quantize_weight(w)
        count += 1
    return out, count


def apply_weights(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Point ``module``'s parameters and buffers at ``state``'s tensors (no
    copy, no gradient). A layer whose weight is int8 gets its
    ``weight_scale`` buffer; a layer whose weight is float loses it."""
    for key, t in state.items():
        name, _, leaf = key.rpartition(".")
        if leaf == SCALE_KEY:
            continue
        layer = module.get_submodule(name)
        if leaf in layer._parameters:
            setattr(layer, leaf, nn.Parameter(t, requires_grad=False))
        else:
            setattr(layer, leaf, t)
        if leaf != "weight":
            continue
        scale = state.get(f"{name}.{SCALE_KEY}")
        if scale is not None:
            if SCALE_KEY in layer._buffers:
                setattr(layer, SCALE_KEY, scale)
            else:
                layer.register_buffer(SCALE_KEY, scale)
        elif SCALE_KEY in layer._buffers:
            delattr(layer, SCALE_KEY)
