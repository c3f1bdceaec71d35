"""Normalization ops: the hand-written LayerNorm and GroupNorm kernels.

Port of ``flash_diffusion_tpu/ops/norms.py``. ``layer_norm`` on a CUDA
tensor launches the kernel of ``csrc/layer_norm.cu`` (the port of the Pallas
``_ln_fwd_kernel``) for every width and row count, or raises; on a CPU
tensor it runs ``layer_norm_reference``, the plain PyTorch version of the
kernel's math (fp32 statistics with var = max(E[x²] − E[x]², 0), normalize
and affine in fp32, one cast on store). Under a gradient it goes through
``LayerNormFunction``, whose forward is that same dispatch and whose
backward is ``layer_norm_backward``, the plain closed-form VJP of the JAX
``_ln_bwd_math`` (JAX has no Pallas LayerNorm backward either).

``group_norm`` works on channel-first tensors ([B, C, *spatial], contiguous
or, as cuDNN hands them on, channels-last; the kernels keep the layout) with
the JAX package's numerics: fp32 Σx and Σx² per channel
(``group_norm_stats``: on a CUDA tensor the statistics kernel of
``csrc/group_norm.cu``, the port of the Pallas ``_gn_stats_kernel``), folded
per group in plain PyTorch into one per-channel scale and shift in the input
dtype (``_gn_fold_stats``, as JAX's), then applied with an optional SiLU in
one pass (``group_norm_apply``: on a CUDA tensor the port's fused apply
kernel of the same file). A CUDA tensor always takes both kernels, or raises; a CPU tensor
takes their plain versions. Under a gradient it goes through
``GroupNormFunction`` (JAX ``_gn_p``): the same forward without the SiLU, and
``group_norm_backward``, the plain closed-form VJP of JAX ``_gn_p_bwd``; the
SiLU follows through autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

# Launch counts of the LayerNorm and GroupNorm kernels, raised by one per
# launch (never on the plain path). Reset them by assigning 0.
LAUNCHES = {"layer_norm": 0, "group_norm_stats": 0, "group_norm_apply": 0}
# How the statistics kernel splits a sample's N: elements of an NCHW (b, c)
# row that one warp sums, and rows of an NHWC (channels-last) sample that
# one block sums. Constants, so that the split, and with it the order of a
# sample's sums, depends on N and the layout alone: never on the batch, the
# slot or the channel count.
GN_CHUNK, GN_NHWC_ROWS = 2048, 512


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


def _nhwc(x: torch.Tensor) -> Optional[bool]:
    """False for a contiguous [B, C, *spatial] tensor, True for a
    channels-last [B, C, H, W] one, None for any other layout."""
    if x.is_contiguous():
        return False
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return True
    return None


def _check_gn_cuda(what: str, x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Raises unless the kernels take x (and the [B, C] params); returns
    whether x is channels-last."""
    if x.device.type != "cuda":
        raise ValueError(f"the GroupNorm {what} kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the GroupNorm {what} kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty [B, C, ...] tensor, got {tuple(x.shape)}")
    nhwc = _nhwc(x)
    if nhwc is None:
        raise ValueError("x must be contiguous or channels-last")
    for t in params:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous() or t.shape != x.shape[:2]:
            raise ValueError(f"the GroupNorm {what} kernel takes contiguous {x.dtype} [B, C] params on {x.device}")
    if x.numel() >= 2**31 * x.shape[0] or x.shape[0] * x.shape[1] >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's 32-bit sizes")
    return nhwc


def _vec16(x: torch.Tensor, nhwc: bool, *tensors: torch.Tensor) -> bool:
    """Whether x's contiguous extent (N, or C when channels-last) takes
    16-byte loads and stores."""
    extent = x.shape[1] if nhwc else x.numel() // (x.shape[0] * x.shape[1])
    return (extent * x.element_size()) % 16 == 0 and all(u.data_ptr() % 16 == 0 for u in (x, *tensors))


def group_norm_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the statistics kernel: per-channel (Σx, Σx²) over
    [B, C, *spatial], each [B, C] in fp32 (fp64 for fp64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.reshape(x.shape[0], x.shape[1], -1).to(acc)
    return xf.sum(dim=-1), (xf * xf).sum(dim=-1)


def group_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (Σx, Σx²) of x [B, C, *spatial], each [B, C]: the
    statistics kernel on a CUDA tensor (contiguous or channels-last, bf16 or
    fp32), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_stats_reference(x)
    nhwc = _check_gn_cuda("statistics", x)
    b, c = x.shape[:2]
    n = x.numel() // (b * c)
    chunk = GN_NHWC_ROWS if nhwc else GN_CHUNK
    parts = -(-n // chunk)
    s = torch.empty((b, c), dtype=torch.float32, device=x.device)
    ss = torch.empty_like(s)
    partial = torch.empty((2, b * c * parts if parts > 1 else 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_group_norm_stats(
            x.data_ptr(), s.data_ptr(), ss.data_ptr(), partial[0].data_ptr(), partial[1].data_ptr(),
            b, c, n, chunk, int(x.dtype == torch.bfloat16), int(nhwc), int(_vec16(x, nhwc)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "group_norm_stats")
    LAUNCHES["group_norm_stats"] += 1
    return s, ss


def group_norm_apply_reference(
    x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, act: Optional[str] = None,
) -> torch.Tensor:
    """Plain version of the apply kernel: x·w + shift with the per-(b, c)
    [B, C] scale and shift in x's dtype (each op rounding to it), then the
    optional SiLU."""
    b, c = x.shape[:2]
    out = x.reshape(b, c, -1) * w[:, :, None] + shift[:, :, None]
    if act == "silu":
        out = F.silu(out)
    return out.reshape(x.shape)


def group_norm_apply(
    x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, act: Optional[str] = None,
) -> torch.Tensor:
    """``group_norm_apply_reference`` in one pass: the apply kernel on a CUDA
    tensor (x contiguous or channels-last, w and shift [B, C] in x's dtype;
    y in x's layout), the plain version on a CPU tensor."""
    if act not in (None, "silu"):
        raise ValueError(f"act {act!r}: None or 'silu'")
    if x.device.type == "cpu":
        return group_norm_apply_reference(x, w, shift, act)
    nhwc = _check_gn_cuda("apply", x, w, shift)
    b, c = x.shape[:2]
    y = torch.empty_like(x)  # keeps x's layout
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_group_norm_apply(
            x.data_ptr(), w.data_ptr(), shift.data_ptr(), y.data_ptr(), b, c, x.numel() // (b * c),
            int(act == "silu"), int(x.dtype == torch.bfloat16), int(nhwc), int(_vec16(x, nhwc, y)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "group_norm_apply")
    LAUNCHES["group_norm_apply"] += 1
    return y


def _gn_fold_stats(s, ss, weight, bias, g: int, n: int, eps: float, dtype):
    """[B, C] channel sums → per-group mean and inv [B, G] → the folded
    per-channel scale and shift [B, C] in ``dtype`` (JAX ``_gn_fold_stats``)."""
    b, c = s.shape
    mean = s.reshape(b, g, -1).sum(-1) / n
    var = torch.clamp(ss.reshape(b, g, -1).sum(-1) / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    inv_c = inv.repeat_interleave(c // g, dim=1)
    w32 = weight.to(s.dtype)[None, :]
    w = (inv_c * w32).to(dtype)
    shift = (bias.to(s.dtype)[None, :] - mean_c * inv_c * w32).to(dtype)
    return w, shift, mean, inv


def _group_norm_forward(x, num_groups, weight, bias, eps, act):
    """(y, mean, inv): the statistics, the fold and the apply, in x's
    layout where the kernels take it (contiguous or channels-last)."""
    if x.device.type != "cpu" and _nhwc(x) is None:
        x = x.contiguous()
    b, c = x.shape[:2]
    s, ss = group_norm_stats(x)
    n = (x.numel() // (b * c)) * (c // num_groups)
    w, shift, mean, inv = _gn_fold_stats(s, ss, weight, bias, num_groups, n, eps, x.dtype)
    return group_norm_apply(x, w, shift, act), mean, inv


def group_norm_backward(
    x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
    dy: torch.Tensor, num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form GroupNorm VJP (JAX ``_gn_p_bwd``) over [B, C, *spatial],
    from the forward's per-group ``mean`` and ``inv`` [B, G]: (dx in x's
    dtype, dweight and dbias as the fp32 sums over batch and space)."""
    b, c = x.shape[:2]
    cg = c // num_groups
    acc = torch.promote_types(x.dtype, torch.float32)
    x3 = x.reshape(b, c, -1).to(acc)
    dy3 = dy.reshape(b, c, -1).to(acc)
    mean_c = mean.to(acc).repeat_interleave(cg, dim=1)[:, :, None]
    inv_c = inv.to(acc).repeat_interleave(cg, dim=1)[:, :, None]
    xhat = (x3 - mean_c) * inv_c
    dyg = dy3 * weight.to(acc)[None, :, None]
    n = x3.shape[-1] * cg
    group_mean = lambda t: (t.reshape(b, num_groups, cg).sum(-1) / n).repeat_interleave(cg, dim=1)[:, :, None]
    m1 = group_mean(dyg.sum(dim=-1))
    m2 = group_mean((dyg * xhat).sum(dim=-1))
    dx = (inv_c * (dyg - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (dy3 * xhat).sum(dim=(0, 2)), dy3.sum(dim=(0, 2))


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm without activation whose forward is the statistics kernel,
    the fold and the apply kernel (their plain versions on the CPU), and
    whose backward is ``group_norm_backward`` (JAX ``_gn_p``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups: int, eps: float):
        y, mean, inv = _group_norm_forward(x, num_groups, weight, bias, eps, None)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.num_groups, ctx.bias_dtype = num_groups, bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        dx, dw, db = group_norm_backward(x, weight, mean, inv, dy, ctx.num_groups)
        need_x, need_w, need_b, _, _ = ctx.needs_input_grad
        return (dx if need_x else None, dw.to(weight.dtype) if need_w else None,
                db.to(ctx.bias_dtype) if need_b else None, None, None)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over [B, C, *spatial] with fp32 statistics and optional SiLU.

    CPU tensors take the plain versions; CUDA tensors launch the statistics
    and apply kernels; under a gradient either goes through
    ``GroupNormFunction``, with the SiLU after it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        y = GroupNormFunction.apply(x, weight, bias, num_groups, eps)
        return F.silu(y) if act == "silu" else y
    return _group_norm_forward(x, num_groups, weight, bias, eps, act)[0]


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation x·(1 + scale) + shift with [B, C] params over [B, S, C]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]
