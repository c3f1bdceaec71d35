"""Normalization ops: the hand-written LayerNorm kernel and a plain GroupNorm.

Port of ``flash_diffusion_tpu/ops/norms.py``. ``layer_norm`` on a CUDA
tensor launches the kernel of ``csrc/layer_norm.cu`` (the port of the Pallas
``_ln_fwd_kernel``) for every width and row count, or raises; on a CPU
tensor it runs ``layer_norm_reference``, the plain PyTorch version of the
kernel's math (fp32 statistics with var = max(E[x²] − E[x]², 0), normalize
and affine in fp32, one cast on store). ``group_norm`` is plain PyTorch with
the JAX package's numerics: fp32 Σx and Σx² per channel, folded per group
into one per-channel scale and shift in the input dtype, optional fused SiLU.
It works on channel-first tensors ([B, C, *spatial]), the layout the port's
convolutions run in.
"""

from __future__ import annotations

from typing import Optional

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
    """Plain version of the LayerNorm kernel, over the last dim."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
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


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 statistics, optional affine.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
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
