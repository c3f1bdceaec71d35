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
``ops/gemm.py int8_gemm``. With ``convs=True`` (the JAX ``QConv`` scopes,
``CONV_INCLUDE``) the UNet's resnet and sampler convolutions quantize too:
``int8_conv`` quantizes a conv's input per sample and multiplies its
im2col on the same int8 GEMM kernel, and an upsampler's int8 weight is
dequantized on the fly (``models/layers.py``). Inference only: nothing
differentiates through int8 weights.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .ops.gemm import int8_gemm
from .parallel.mesh import all_reduce_

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
# The convolutions with an int8 branch (the JAX ``QConv`` scopes of
# ``quant.py:51`` over the port's names): ResnetBlock2D's conv1, conv2 and
# conv_shortcut and the samplers' conv (``downsamplers.0.conv`` through
# ``int8_conv``; ``upsamplers.0.conv`` dequantized on the fly). JAX's list
# also names conv_in and conv_out, plain convs in its UNet that no
# ``conv_min_dim`` of 4 latent channels lets through; the port leaves them
# out, since its convs there have no int8 branch either.
CONV_INCLUDE = r"(^|\.)(conv1|conv2|conv_shortcut|conv)$"


def quantize_weight(w: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float weight [out, in] or a conv's [out, in, kh, kw] → (int8 codes
    of the same shape, fp32 scale [out]), w ≈ codes · scale. Reduces over
    every dim but the output channels, as JAX reduces its [in, out] or HWIO
    kernel over all but the last. A conv's codes are laid out channels-last
    (strides of [out, kh, kw, in]), so that ``int8_conv`` reads them as the
    GEMM's [out, kh·kw·in] in JAX's (kh, kw, in) order without a copy.
    With a tensor-parallel ``group`` ``w`` is a row-parallel shard [out,
    in / n], and the amax is the group's: the scale of the whole weight."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.dim())))
    if group is not None:
        all_reduce_(amax, "max", group)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale.reshape(-1, *(1,) * (w.dim() - 1))).clamp(-127, 127).to(torch.int8)
    if w.dim() == 4 and w.shape[2:] != (1, 1):
        q = q.contiguous(memory_format=torch.channels_last)
    return q, scale


def quantize_activation(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic quantization of ``x`` [..., K]: (int8 codes
    [..., K], fp32 scale [..., 1]). A division, not a multiplication by a
    reciprocal, and round half to even, as ``jnp.round(xf / s_x)``. With a
    tensor-parallel ``group`` ``x`` holds the rank's K / n features of
    each token, and the per-token amax is the group's (an all-reduce of
    the max), so that the codes are the slice of the whole K's codes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        all_reduce_(amax, "max", group)
    s_x = amax.clamp_min(1e-8) / 127.0
    return torch.round(xf / s_x).clamp(-127, 127).to(torch.int8), s_x


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, group=None) -> torch.Tensor:
    """W8A8 product ``x [..., K] · wq [N, K]ᵀ`` in x's dtype: the
    activations quantized per token, the int8 product and its dequant on
    the kernel (bf16 out). An fp32 ``x`` gets fp32 out, as on JAX's XLA
    route; only the plain version (the CPU) computes that. ``group``: a
    row-parallel layer's (``quantize_activation``); the caller sums the
    partial products."""
    xq, s_x = quantize_activation(x, group)
    k, n = x.shape[-1], wq.shape[0]
    out_dtype = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    y = int8_gemm(xq.reshape(-1, k), s_x.reshape(-1), wq, w_scale, out_dtype=out_dtype)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def quantize_dense(
    state: Dict[str, torch.Tensor], min_dim: int = 256, include: Optional[str] = DENSE_INCLUDE,
    convs: bool = False, conv_min_dim: int = 128, conv_include: Optional[str] = CONV_INCLUDE,
    tp: Optional[Dict[str, Tuple[int, int, object]]] = None,
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Quantize the eligible weights of a state dict; returns (new state,
    number quantized). A ``<layer>.weight`` is eligible when it is float,
    2-D (or a 1×1 conv's 4-D), both its dims are ≥ ``min_dim``, and the
    layer's name matches ``include`` (None: any); with ``convs``, also a
    conv's 4-D weight whose in and out channels are both ≥
    ``conv_min_dim`` and whose layer matches ``conv_include`` (None: any),
    as JAX picks its ``QConv`` kernels (a 1×1 conv matched by ``include``
    stays a dense layer). Each gets int8 codes in place of its weight and a
    ``<layer>.weight_scale``; every other entry passes through as the same
    tensor. ``tp``: {layer name: (split dim, world size, group)} of the
    layers of a tensor-parallel shard (``pipelines.FlashPipeline.shard_tp``):
    eligibility reads the whole weight's dims, and a row-parallel layer
    (split dim 1, with its group) takes the group's per-channel amax
    (``quantize_weight``); a column-parallel shard holds whole rows, so its
    scales are those rows' scales of the whole weight."""
    inc = re.compile(include) if include else None
    cinc = re.compile(conv_include) if conv_include else None
    out, count = dict(state), 0
    for key, w in state.items():
        name, _, leaf = key.rpartition(".")
        if leaf != "weight" or not w.is_floating_point() or w.dim() not in (2, 4):
            continue
        split, n, group = (tp or {}).get(name, (0, 1, None))
        dims = [w.shape[0], w.shape[1]]
        dims[split] *= n  # the whole weight's
        dense = w.dim() == 2 or (tuple(w.shape[2:]) == (1, 1) and (inc is None or bool(inc.search(name))))
        if dense:
            if min(dims) < min_dim or (inc is not None and not inc.search(name)):
                continue
        elif not convs or min(w.shape[0], w.shape[1]) < conv_min_dim or (cinc is not None
                                                                          and not cinc.search(name)):
            continue
        out[key], out[f"{name}.{SCALE_KEY}"] = quantize_weight(w, group)
        count += 1
    return out, count


def quantize_conv_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample dynamic quantization of a conv input [B, C, H, W]: (int8
    codes in x's layout, fp32 scale [B]), one scale over each sample's C,
    H and W; a division and round half to even, as ``quantize_activation``."""
    xf = x.float()
    s_x = xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    return torch.round(xf / s_x[:, None, None, None]).clamp(-127, 127).to(torch.int8), s_x


def im2col(xq: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
           padding: Tuple[int, int]) -> torch.Tensor:
    """The conv's GEMM rows of int8 codes [B, C, H, W]: [B·Ho·Wo, kh·kw·C],
    rows in (b, ho, wo) order, each row's K in (kh, kw, c) order (JAX's
    HWIO contraction), zero codes in the padding."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    x = xq.permute(0, 2, 3, 1)  # NHWC (a view of a channels-last tensor)
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph))
    b, c = x.shape[0], x.shape[3]
    if (kh, kw) == (1, 1):
        return x[:, ::sh, ::sw].reshape(-1, c)
    cols = x.unfold(1, kh, sh).unfold(2, kw, sw)  # [B, Ho, Wo, C, kh, kw]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """W8A8 conv of ``x`` [B, C, H, W] by int8 codes ``wq`` [N, C, kh, kw]
    (``quantize_weight``'s) with their fp32 scale [N], in x's dtype (bf16
    on the card), NCHW, no bias (the layer adds it after, in the output
    dtype, as JAX does). The activation scale is one a sample
    (``quantize_conv_activation``); the product is the int8 GEMM kernel's
    (``ops/gemm.py int8_gemm``) over ``im2col`` of the codes, with the
    sample's scale on each of its rows and acc·s_x·w_scale in fp32 in the
    epilogue, as JAX computes it. K = kh·kw·C must be a multiple of 32 on
    the card (every UNet conv's is), else the kernel raises."""
    n, c, kh, kw = wq.shape
    b, _, h, w = x.shape
    ho = (h + 2 * padding[0] - kh) // stride[0] + 1
    wo = (w + 2 * padding[1] - kw) // stride[1] + 1
    xq, s_x = quantize_conv_activation(x)
    rows = im2col(xq.contiguous(memory_format=torch.channels_last), (kh, kw), stride, padding)
    w2d = wq.permute(0, 2, 3, 1).reshape(n, kh * kw * c)  # a view of channels-last codes
    out_dtype = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    y = int8_gemm(rows, s_x.repeat_interleave(ho * wo), w2d.contiguous(), w_scale, out_dtype=out_dtype)
    return y.reshape(b, ho, wo, n).permute(0, 3, 1, 2).to(x.dtype)


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
