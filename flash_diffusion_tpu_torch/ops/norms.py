"""Normalization ops: the hand-written LayerNorm kernel and a plain GroupNorm.

Port of ``flash_diffusion_tpu/ops/norms.py``. ``layer_norm`` on a CUDA
tensor launches the kernel of ``csrc/layer_norm.cu`` (the port of the Pallas
``_ln_fwd_kernel``) for every width and row count, or raises; on a CPU
tensor it runs ``layer_norm_reference``, the plain PyTorch version of the
kernel's math (fp32 statistics with var = max(E[x²] − E[x]², 0), normalize
and affine in fp32, one cast on store). Under a gradient it goes through
``LayerNormFunction``, whose forward is that same dispatch and whose
backward is ``layer_norm_backward``, the plain closed-form VJP of the JAX
``_ln_bwd_math`` (JAX has no Pallas LayerNorm backward either). ``group_norm`` is plain PyTorch with
the JAX package's numerics: fp32 Σx and Σx² per channel, folded per group
into one per-channel scale and shift in the input dtype, optional fused SiLU.
It works on channel-first tensors ([B, C, *spatial]), the layout the port's
convolutions run in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

# Launch count of the LayerNorm kernel, raised by one per launch (never on
# the plain path). Reset it by assigning 0.
LAUNCHES = {"layer_norm": 0}


def layer_norm_reference(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of the LayerNorm kernel, over the last dim (fp32 math;
    fp64 for fp64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(acc)
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype)


def _check_cuda_inputs(x, weight, bias):
    if x.device.type != "cuda":
        raise ValueError(f"the LayerNorm kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the LayerNorm kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError("x must be a non-empty contiguous tensor")
    params = [p for p in (weight, bias) if p is not None]
    for p in params:
        if p.device != x.device or not p.is_contiguous() or p.shape != (x.shape[-1],):
            raise ValueError(f"affine params must be contiguous [{x.shape[-1]}] on {x.device}")
        if p.dtype not in (torch.bfloat16, torch.float32) or p.dtype != params[0].dtype:
            raise ValueError("weight and bias must share one dtype, bf16 or fp32")


def layer_norm_backward(
    x: torch.Tensor, weight: Optional[torch.Tensor], dy: torch.Tensor, eps: float,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Closed-form LayerNorm VJP (the JAX ``_ln_bwd_math``): (dx in x's
    dtype, and with ``weight`` the fp32 sums dweight = Σ dy·x̂ and dbias = Σ dy
    over the rows)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dyf = x.to(acc), dy.to(acc)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dyh = dyf * weight.to(acc) if weight is not None else dyf
    m1 = dyh.mean(dim=-1, keepdim=True)
    m2 = (dyh * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (dyh - m1 - xhat * m2)).to(x.dtype)
    if weight is None:
        return dx, None, None
    rows = tuple(range(x.dim() - 1))
    return dx, (dyf * xhat).sum(dim=rows), dyf.sum(dim=rows)


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm whose forward is the kernel (the plain version on the CPU)
    and whose backward is ``layer_norm_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bias_dtype = eps, None if bias is None else bias.dtype
        return _layer_norm_forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, _ = layer_norm_backward(x, weight, dy, ctx.eps)
        _, need_w, need_b, _ = ctx.needs_input_grad
        db = None
        if need_b:  # Σ dy over the rows, in fp32 as in JAX
            acc = torch.promote_types(dy.dtype, torch.float32)
            db = dy.to(acc).sum(dim=tuple(range(dy.dim() - 1))).to(ctx.bias_dtype)
        return dx, dw.to(weight.dtype) if need_w else None, db, None


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 statistics, optional affine.

    CPU tensors take the plain version; CUDA tensors launch the kernel; under
    a gradient either goes through ``LayerNormFunction``."""
    params = [t for t in (x, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return _layer_norm_forward(x, weight, bias, eps)


def _layer_norm_forward(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    _check_cuda_inputs(x, weight, bias)
    c = x.shape[-1]
    y = torch.empty_like(x)
    w_bf16 = any(p is not None and p.dtype == torch.bfloat16 for p in (weight, bias))
    vec = (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_layer_norm(
            x.data_ptr(), ptr(weight), ptr(bias), y.data_ptr(), x.numel() // c, c,
            float(eps), int(x.dtype == torch.bfloat16), int(w_bf16), int(vec),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "layer_norm")
    LAUNCHES["layer_norm"] += 1
    return y


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over [B, C, *spatial] with fp32 statistics and optional SiLU."""
    b, c = x.shape[:2]
    g = num_groups
    x3 = x.reshape(b, c, -1)
    n = x3.shape[-1] * (c // g)
    xf = x3.float()
    s = xf.sum(dim=-1)
    ss = (xf * xf).sum(dim=-1)
    mean = s.reshape(b, g, -1).sum(-1) / n
    var = torch.clamp(ss.reshape(b, g, -1).sum(-1) / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)  # [B, C]
    inv_c = inv.repeat_interleave(c // g, dim=1)
    w32 = weight.float()[None, :]
    w = (inv_c * w32).to(x.dtype)
    shift = (bias.float()[None, :] - mean_c * inv_c * w32).to(x.dtype)
    out = x3 * w[:, :, None] + shift[:, :, None]
    if act == "silu":
        out = F.silu(out)
    return out.reshape(x.shape)
