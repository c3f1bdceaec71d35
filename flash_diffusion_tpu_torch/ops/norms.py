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
the JAX package's numerics: fp32 Σx and Σx² per channel (the port of the
Pallas ``_gn_stats_kernel``), folded per group into one per-channel scale
and shift in the input dtype (JAX's ``_gn_fold_stats``), then applied with
an optional SiLU. On a CUDA tensor only the kernels of
``csrc/group_norm.cu`` run, one or two launches by ``group_norm_plan``: the
resident kernel (all three in one launch), or the statistics kernel with
the fold in its last block, then the apply kernel; a plan the card refuses
raises. On a CPU tensor the plain versions run (``group_norm_reference``).
The statistics alone (``group_norm_stats``) and the apply alone
(``group_norm_apply``) stay public with their plain versions. Under a
gradient it goes through ``GroupNormFunction`` (JAX ``_gn_p``): the same
forward without the SiLU, and ``group_norm_backward``, the plain
closed-form VJP of JAX ``_gn_p_bwd``; the SiLU follows through autograd.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

# Launch counts of the LayerNorm and GroupNorm kernels by (kernel, shape)
# (``kernels.LaunchCounts``): ``group_norm_fused`` is the resident GroupNorm
# (plan (a), one launch), ``group_norm_stats`` the statistics kernel (plan
# (b)'s first launch, or ``group_norm_stats`` alone), ``group_norm_apply``
# the apply kernel (plan (b)'s second launch, or ``group_norm_apply``
# alone). The shape is (rows, C, dtype) for the LayerNorm, ((B, C,
# *spatial), dtype, groups) for the resident and statistics kernels (groups
# None for the statistics alone, which fold nothing), ((B, C, *spatial),
# dtype) for the apply kernel, which takes no groups.
LAUNCHES = kernels.LaunchCounts()
# How the statistics kernel splits an NHWC (channels-last) sample's N
# (``gn_stream_plan``): at least GN_NHWC_ROWS rows a block, and at most
# GN_MAX_PARTS parts (so that the sum over a channel's partials stays
# short); an NCHW row goes to one block. A function of N and the layout
# alone, never of the batch, the slot or the channel count, and with it the
# order of a sample's sums.
GN_NHWC_ROWS, GN_MAX_PARTS = 512, 32
# The resident plan (``gn_resident_plan``): a block's share of a slice in
# shared memory, at most GN_RESIDENT_BYTES (two blocks an SM), in a cluster
# of one of GN_CLUSTERS blocks. Past it the streaming plan was faster on the
# card (``kernel_times.py --kernels k9 --sweep``: e.g. [4, 320, 128²] NCHW
# in clusters of 2 × 160 KB, [4, 256, 256²] NCHW of 8 × 128 KB).
GN_RESIDENT_BYTES, GN_CLUSTERS = 100 * 1024, (1, 2, 4, 8)
_SMEM_LIMIT, _GN_WARPS = 232448, 16  # warps of a resident block
# packs a lane of the LayerNorm row kernel (``layer_norm_plan``): 16-byte
# packs, and packs of one element
LN_PPT, LN_PPT_SCALAR = (1, 2, 4, 5, 6, 8, 9, 10, 16), (1, 2, 4, 8, 16)
# The LayerNorm kernel's gate against the plain version in fp32 on the same
# inputs, per output dtype: (rel, floor, l2, bias) of ``layer_norm_gate``.
# bf16: y rounds once on store, by at most half an ulp (≤ 2⁻⁸·|y|); the
# fp32 statistics differ by their summation order only, far inside the
# floor; the plain version in bf16 gives a relative L2 of ~1.6e-3
# (``test_plain_bf16_layer_norm_sits_inside_the_gate``), and y × 1.01 gives
# 1e-2. fp32: the summation order alone (≲ 1e-6 of max|y|).
LN_GATE = {torch.bfloat16: (2**-8, 2**-16, 4e-3, 1e-4), torch.float32: (0.0, 1e-5, 1e-5, 1e-6)}
# The whole GroupNorm's gate (``group_norm_gate``) against the plain version
# in fp32, per output dtype: (rel, floor, l2, bias) for y, with and without
# SiLU. bf16: the folded scale and shift round to bf16 (JAX's rounding; a
# kernel's fold may land one ulp off the plain fold's), then x·w and + shift
# round, and their terms cancel where y ≈ 0 (the floor); a channel's scale
# rounds once for all its N elements, so the mean error averages over C
# channels only (the bias term). The plain version in bf16 gives a relative
# L2 of ~3.0e-3 (y) and ≤ 4.6e-3 (with SiLU), y × 1.01 ~1.04–1.1e-2
# (``test_plain_bf16_group_norm_sits_inside_the_gate``). fp32: summation
# order. The per-group mean and inv are held to fp64 within GN_STATS_REL of
# |mean| + σ and of inv.
GN_GATE = {torch.bfloat16: (2**-8, 2**-7, 7.5e-3, 2e-3), torch.float32: (0.0, 1e-5, 1e-5, 1e-6)}
GN_STATS_REL = 1e-5


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


def _y_errors(y: torch.Tensor, ref: torch.Tensor, rel: float, chunk: int = 1 << 27) -> dict:
    """The error statistics of ``y`` against ``ref`` in fp64, over slices of
    the leading dim of at most ``chunk`` elements each (a whole fp64 copy of
    a stacked VAE activation would not fit beside it on the card)."""
    step = max(1, chunk // max(1, y[:1].numel()))
    excess, max_err, max_ref, e2, r2, e1 = float("-inf"), 0.0, 0.0, 0.0, 0.0, 0.0
    for i in range(0, y.shape[0], step):
        r = ref[i:i + step].double()
        e = y[i:i + step].double() - r
        excess = max(excess, (e.abs() - rel * r.abs()).max().item())
        max_err, max_ref = max(max_err, e.abs().max().item()), max(max_ref, r.abs().max().item())
        e2, r2, e1 = e2 + e.square().sum().item(), r2 + r.square().sum().item(), e1 + e.sum().item()
        del r, e
    n = y.numel()
    return {"excess": excess, "max_err": max_err, "max_ref": max_ref, "rel_l2": (e2 / r2) ** 0.5,
            "mean_err": e1 / n, "rms_ref": (r2 / n) ** 0.5}


def _y_gate(s: dict, rel: float, floor: float, l2: float, bias: float) -> tuple:
    """(pass, report) of one output's ``_y_errors``: every element within
    ``rel``·|ref| + ``floor``·max|ref|, the relative L2 error within ``l2``,
    the mean signed error within ``bias``·rms(ref)."""
    ok = s["excess"] <= floor * s["max_ref"] and s["rel_l2"] <= l2 and abs(s["mean_err"]) <= bias * s["rms_ref"]
    return ok, (f"max|err| {s['max_err']:.3e}, past {rel:.3g}·|ref| {s['excess']:.3e} (tol "
                f"{floor * s['max_ref']:.3e}) rel L2 {s['rel_l2']:.3e} (tol {l2}) mean err {s['mean_err']:.3e} "
                f"(tol {bias * s['rms_ref']:.3e})")


def layer_norm_errors(y: torch.Tensor, ref: torch.Tensor) -> dict:
    """What ``layer_norm_gate`` reads of the kernel's ``y`` against the plain
    version's ``ref`` in fp32 on the same inputs."""
    return {"dtype": str(y.dtype).replace("torch.", ""), **_y_errors(y, ref, LN_GATE[y.dtype][0])}


def layer_norm_gate(stats: dict) -> tuple:
    """(pass, report) of ``_y_gate`` at the constants of ``LN_GATE`` for y's
    dtype."""
    return _y_gate(stats, *LN_GATE[getattr(torch, stats["dtype"])])


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


def _autocast_on(x: torch.Tensor) -> bool:
    return x.device.type in ("cuda", "cpu") and torch.is_autocast_enabled(x.device.type)


def _fp32_under_autocast(norm, x, *args):
    """``norm(x, *args)`` with autocast off and every tensor in fp32:
    ``torch.autocast`` runs its own normalizations (``F.layer_norm``,
    ``F.group_norm``) in fp32, and so do these ops when a caller autocasts
    (the toy proofs of ``toy_quality.py`` on the card)."""
    with torch.autocast(x.device.type, enabled=False):
        return norm(*(a.float() if isinstance(a, torch.Tensor) else a for a in (x, *args)))


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 statistics, optional affine.

    CPU tensors take the plain version; CUDA tensors launch the kernel; under
    a gradient either goes through ``LayerNormFunction``. Under
    ``torch.autocast`` it runs in fp32 (``_fp32_under_autocast``)."""
    if _autocast_on(x):
        return _fp32_under_autocast(layer_norm, x, weight, bias, eps)
    params = [t for t in (x, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return _layer_norm_forward(x, weight, bias, eps)


@functools.lru_cache(maxsize=None)
def layer_norm_plan(c: int, elem: int, vec: bool) -> Tuple[int, int]:
    """(lanes a row, packs a lane) of the LayerNorm row kernel for rows of
    ``c`` elements of ``elem`` bytes, in 16-byte packs (``vec``) or packs of
    one element; by the width alone. Where a lane count of 32, 16 or 8
    divides the packs into a built count a lane, the lanes cover the row
    exactly (every lane busy: bf16 C = 320 → (8, 5), 640 → (16, 5), 1152 →
    (16, 9), 1280 → (32, 5); fp32 768 → (32, 6), 1280 → (32, 10)); else 32
    lanes of the least built count that covers it; (32, 0) past 16 packs a
    lane: the wide kernel (csrc/layer_norm.cu)."""
    packs = c // (16 // elem) if vec else c
    built = LN_PPT if vec else LN_PPT_SCALAR
    for tpr in (32, 16, 8) if vec else (32,):
        if packs % tpr == 0 and packs // tpr in built:
            return tpr, packs // tpr
    return 32, next((p for p in built if 32 * p >= packs), 0)


def _layer_norm_forward(x, weight, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    _check_cuda_inputs(x, weight, bias)
    c = x.shape[-1]
    y = torch.empty_like(x)
    w_bf16 = any(p is not None and p.dtype == torch.bfloat16 for p in (weight, bias))
    vec = (c * x.element_size()) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, weight, bias)
                                                    if t is not None)
    tpr, ppt = layer_norm_plan(c, x.element_size(), vec)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_layer_norm(
            x.data_ptr(), ptr(weight), ptr(bias), y.data_ptr(), x.numel() // c, c,
            float(eps), int(x.dtype == torch.bfloat16), int(w_bf16), int(vec), tpr, ppt,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "layer_norm")
    LAUNCHES["layer_norm", (x.numel() // c, c, x.dtype)] += 1
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


class StreamPlan(NamedTuple):
    """Plan (b)'s split of a sample's N (``gn_stream_plan``)."""

    chunk: int  # NCHW: elements of a (b, c) row a warp sums; NHWC: rows a block sums
    parts: int  # ceil(N / chunk)


class ResidentPlan(NamedTuple):
    """Plan (a)'s launch (``gn_resident_plan``; csrc/group_norm.cu
    fdt_group_norm_resident)."""

    cluster: int  # blocks of a cluster, 1-8
    channels: int  # NHWC: channels of a slice (whole groups); NCHW: channels a block takes (C/G / cluster)
    rows: int  # NHWC: rows a block takes; NCHW: N (whole rows)
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=None)
def gn_stream_plan(n: int, nhwc: bool) -> StreamPlan:
    """The statistics kernel's split of a sample's N, by N and the layout
    alone. NCHW: one block a (b, c) row, its 8 warps on 8 chunks of whole
    16-byte packs (one part). NHWC: GN_NHWC_ROWS rows a part, more past
    GN_MAX_PARTS parts."""
    if not nhwc:
        return StreamPlan(-(-(-(-n // 8)) // 8) * 8, 1)
    chunk = max(GN_NHWC_ROWS, -(-(-(-n // GN_MAX_PARTS)) // 32) * 32)
    return StreamPlan(chunk, -(-n // chunk))


def _resident_smem(nhwc: bool, cs: int, cg: int, rows: int, boxes: int, elem: int, groups: int) -> int:
    """Dynamic shared memory of a resident block (``ResidentLayout`` in
    csrc/group_norm.cu): the data (cs channels by ``rows``), the warps'
    sums, the block's and the cluster's sums, the scale and shift, the
    groups' mean and inv, the mbarriers and the base's alignment slack."""
    gst = cs * rows * elem + 2 * (_GN_WARPS * cs if nhwc else _GN_WARPS) * 4 + 2 * cs * 4
    gst += 2 * (cs if nhwc else cg) * 4 + 2 * cs * 4
    return -(-(gst + 2 * groups * 4) // 8) * 8 + 8 * (boxes if nhwc else 1) + 128


def gn_resident_plan(n: int, c: int, g: int, nhwc: bool, elem: int) -> Optional[ResidentPlan]:
    """Plan (a) for a GroupNorm of N positions, C channels in G groups, the
    layout and the element size, or None where a group does not fit a
    cluster's shared memory (or its rows are off the 16-byte step). NHWC: a
    slice of the fewest whole groups whose channels make rows of whole
    32-byte sectors (no two clusters share a sector of x or y; ≤ 256
    channels, a TMA box's width, and ≤ 32 16-byte packs, a warp's lanes),
    its rows split over the cluster; NCHW: one
    group, its channels split over the cluster. The least cluster (1, 2, 4,
    8) whose blocks each hold at most GN_RESIDENT_BYTES."""
    if c % g:
        return None
    cg, kv = c // g, 16 // elem
    if nhwc:
        k = next((k for k in range(1, g + 1) if g % k == 0 and k * cg % (2 * kv) == 0), None)
        if (c * elem) % 16 or k is None or k * cg > min(256, 32 * kv):
            return None
        cs = k * cg
        for cluster in GN_CLUSTERS:
            rows = -(-n // cluster)
            boxes = -(-rows // 256)
            data_rows = boxes * (-(-(-(-rows // boxes)) // 8) * 8)
            smem = _resident_smem(True, cs, cg, data_rows, boxes, elem, k)
            if (cluster - 1) * rows < n and data_rows * cs * elem <= GN_RESIDENT_BYTES and smem <= _SMEM_LIMIT:
                return ResidentPlan(cluster, cs, rows, smem)
        return None
    if (n * elem) % 16:
        return None
    for cluster in GN_CLUSTERS:
        cs = cg // cluster
        smem = _resident_smem(False, cs, cg, n, 1, elem, 1)
        if cg % cluster == 0 and cs * n * elem <= GN_RESIDENT_BYTES and smem <= _SMEM_LIMIT:
            return ResidentPlan(cluster, cs, n, smem)
    return None


@functools.lru_cache(maxsize=None)
def group_norm_plan(shape, num_groups: int, nhwc: bool, dtype) -> Tuple[str, tuple]:
    """("resident", ``ResidentPlan``) or ("stream", ``StreamPlan``) for a
    GroupNorm over x of ``shape`` [B, C, *spatial]: by N, C, G, the layout
    and the dtype, never by B (cached: the host runs it at every call)."""
    n = 1
    for d in shape[2:]:
        n *= d
    plan = gn_resident_plan(n, shape[1], num_groups, nhwc, torch.empty((), dtype=dtype).element_size())
    return ("resident", plan) if plan is not None else ("stream", gn_stream_plan(n, nhwc))


# the statistics kernel's arrival counters, by (device, stream): zero
# between launches (the last block to arrive resets its own)
_GN_COUNTERS: dict = {}


def _gn_counters(device: torch.device, stream: int, count: int) -> torch.Tensor:
    t = _GN_COUNTERS.get((device, stream))
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _GN_COUNTERS[(device, stream)] = t
    return t


def _gn_stats_launch(x, nhwc, sums, fold=None, groups=1, eps=0.0):
    """One launch of the statistics kernel over x: the channel sums into
    ``sums`` = (Σx, Σx²) [B, C] fp32, and with ``fold`` = (weight, bias, w,
    shift, mean, inv) the fold into the last four."""
    b, c = x.shape[:2]
    n = x.numel() // (b * c)
    plan = gn_stream_plan(n, nhwc)
    vec = _vec16(x, nhwc)
    tiles = -(-c // (8 * (16 // x.element_size() if vec else 1))) if nhwc else 0
    partial = torch.empty((2, b * c * plan.parts if nhwc else 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    weight = None if fold is None else fold[0]
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_group_norm_stats(
            x.data_ptr(), *(t.data_ptr() for t in sums), *(ptr(t) for t in (fold or (None,) * 6)),
            partial[0].data_ptr(), partial[1].data_ptr(), _gn_counters(x.device, stream, b * (tiles + 1)).data_ptr(),
            b, c, n, groups, plan.chunk, int(x.dtype == torch.bfloat16),
            int(weight is not None and weight.dtype == torch.bfloat16), int(nhwc), int(vec), int(fold is not None),
            float(eps), stream,
        )
    kernels.check(err, "group_norm_stats")
    LAUNCHES["group_norm_stats", (tuple(x.shape), x.dtype, None if fold is None else groups)] += 1


def group_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (Σx, Σx²) of x [B, C, *spatial], each [B, C]: the
    statistics kernel on a CUDA tensor (contiguous or channels-last, bf16 or
    fp32; one launch), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_stats_reference(x)
    nhwc = _check_gn_cuda("statistics", x)
    s = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    ss = torch.empty_like(s)
    _gn_stats_launch(x, nhwc, (s, ss))
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
            int(act == "silu"), int(x.dtype == torch.bfloat16), int(nhwc), int(_vec16(x, nhwc, y, w, shift)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "group_norm_apply")
    LAUNCHES["group_norm_apply", (tuple(x.shape), x.dtype)] += 1
    return y


def _gn_fold_groups(gs, gss, weight, bias, n: int, eps: float, dtype):
    """Per-group sums [B, G] → mean and inv [B, G] → the folded per-channel
    scale and shift [B, C] in ``dtype``."""
    cg = weight.shape[0] // gs.shape[1]
    mean = gs / n
    var = torch.clamp(gss / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)
    inv_c = inv.repeat_interleave(cg, dim=1)
    w32 = weight.to(gs.dtype)[None, :]
    w = (inv_c * w32).to(dtype)
    shift = (bias.to(gs.dtype)[None, :] - mean_c * inv_c * w32).to(dtype)
    return w, shift, mean, inv


def _gn_fold_stats(s, ss, weight, bias, g: int, n: int, eps: float, dtype):
    """[B, C] channel sums → per-group mean and inv [B, G] → the folded
    per-channel scale and shift [B, C] in ``dtype`` (JAX ``_gn_fold_stats``)."""
    b = s.shape[0]
    return _gn_fold_groups(s.reshape(b, g, -1).sum(-1), ss.reshape(b, g, -1).sum(-1), weight, bias, n, eps, dtype)


def group_norm_fold_reference(s, ss, weight, bias, g: int, n: int, eps: float, dtype):
    """The kernels' fold in plain PyTorch: ``_gn_fold_stats`` with each
    group's sums taken in the kernels' fixed order, channel by channel from
    its first, in fp32 (csrc/group_norm.cu group_sums)."""
    b = s.shape[0]
    s3, q3 = s.reshape(b, g, -1), ss.reshape(b, g, -1)
    gs, gss = s3[:, :, 0], q3[:, :, 0]
    for j in range(1, s3.shape[2]):
        gs, gss = gs + s3[:, :, j], gss + q3[:, :, j]
    return _gn_fold_groups(gs, gss, weight, bias, n, eps, dtype)


def group_norm_reference(x, num_groups, weight, bias, eps=1e-5, act=None):
    """Plain version of the whole GroupNorm forward, on any device: (y, mean,
    inv) from the plain statistics, ``_gn_fold_stats`` and the plain apply
    (fp32 statistics; fp64 for fp64 inputs)."""
    b, c = x.shape[:2]
    s, ss = group_norm_stats_reference(x)
    n = (x.numel() // (b * c)) * (c // num_groups)
    w, shift, mean, inv = _gn_fold_stats(s, ss, weight, bias, num_groups, n, eps, x.dtype)
    return group_norm_apply_reference(x, w, shift, act), mean, inv


def group_norm_errors(got, want, want64) -> dict:
    """What ``group_norm_gate`` reads: ``got`` = (y, y with SiLU, mean, inv) of
    the port's ``group_norm`` from one x, weight and bias; ``want`` = the
    same of ``group_norm_reference`` in fp32 (x, weight and bias cast to
    fp32); ``want64`` = its (mean, inv) in fp64."""
    y, y_act, mean, inv = got
    ref, ref_act = want[0], want[1]
    mean64, inv64 = (t.double() for t in want64)
    rel = GN_GATE[y.dtype][0]
    scale = mean64.abs() + 1.0 / inv64  # |mean| + σ of each (sample, group)
    return {"dtype": str(y.dtype).replace("torch.", ""), "y": _y_errors(y, ref, rel),
            "silu": _y_errors(y_act, ref_act, rel),
            "mean_err": ((mean.double() - mean64).abs() / scale).max().item(),
            "inv_err": ((inv.double() - inv64).abs() / inv64).max().item()}


def group_norm_gate(stats: dict) -> tuple:
    """(pass, report): y and y with SiLU each within ``rel``·|ref| +
    ``floor``·max|ref| at every element, a relative L2 error within ``l2``
    and a mean signed error within ``bias``·rms(ref) (``GN_GATE`` for y's
    dtype); mean within ``GN_STATS_REL``·(|mean| + σ) and inv within
    ``GN_STATS_REL``·inv of fp64, per (sample, group)."""
    consts = GN_GATE[getattr(torch, stats["dtype"])]
    ok = stats["mean_err"] <= GN_STATS_REL and stats["inv_err"] <= GN_STATS_REL
    parts = []
    for key in ("y", "silu"):
        key_ok, report = _y_gate(stats[key], *consts)
        ok = ok and key_ok
        parts.append(f"{key}: {report}")
    parts.append(f"mean {stats['mean_err']:.3e}, inv {stats['inv_err']:.3e} of fp64 (tol {GN_STATS_REL})")
    return ok, "; ".join(parts)


def group_norm_forward(x, num_groups, weight, bias, eps=1e-5, act=None):
    """(y, mean, inv) of the GroupNorm forward, without autograd: the
    statistics, the fold and the apply, in x's layout where the kernels take
    it (contiguous or channels-last); the plain version on a CPU tensor.
    ``mean`` and ``inv`` are the per-group fp32 [B, G] that
    ``group_norm_backward`` takes."""
    if x.device.type == "cpu":
        return group_norm_reference(x, num_groups, weight, bias, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"act {act!r}: None or 'silu'")
    if _nhwc(x) is None:
        x = x.contiguous()
    nhwc = _check_gn_cuda("forward", x)
    b, c = x.shape[:2]
    for p in (weight, bias):
        if (p.device != x.device or not p.is_contiguous() or p.shape != (c,) or p.dtype != weight.dtype
                or p.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"weight and bias must be contiguous [{c}] of one dtype, bf16 or fp32, on {x.device}")
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    kind, plan = group_norm_plan(x.shape, num_groups, nhwc, x.dtype)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    if kind == "stream":  # plan (b): the statistics with the fold, then the apply
        w, shift = (torch.empty((b, c), dtype=x.dtype, device=x.device) for _ in range(2))
        sums = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
        _gn_stats_launch(x, nhwc, sums, (weight, bias, w, shift, mean, inv), num_groups, eps)
        return group_norm_apply(x, w, shift, act), mean, inv
    y = torch.empty_like(x)  # plan (a): one launch; y keeps x's layout
    if not all(t.data_ptr() % 16 == 0 for t in (x, y)):
        raise ValueError("the resident GroupNorm kernel takes 16-byte aligned tensors")
    with torch.cuda.device(x.device):
        err = kernels.library().fdt_group_norm_resident(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            b, c, x.numel() // (b * c), num_groups, plan.cluster, plan.channels, plan.rows,
            int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), int(nhwc), int(act == "silu"),
            float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(err, "group_norm (resident)")
    LAUNCHES["group_norm_fused", (tuple(x.shape), x.dtype, num_groups)] += 1
    return y, mean, inv


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
    """GroupNorm without activation whose forward is ``group_norm_forward``
    (the GroupNorm kernels; their plain versions on the CPU), and whose
    backward is ``group_norm_backward`` (JAX ``_gn_p``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups: int, eps: float):
        y, mean, inv = group_norm_forward(x, num_groups, weight, bias, eps, None)
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

    CPU tensors take the plain versions; CUDA tensors launch the GroupNorm
    kernels (one launch or two, ``group_norm_plan``); under a gradient
    either goes through ``GroupNormFunction``, with the SiLU after it. Under
    ``torch.autocast`` it runs in fp32 (``_fp32_under_autocast``)."""
    if _autocast_on(x):
        return _fp32_under_autocast(group_norm, x, num_groups, weight, bias, eps, act)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        y = GroupNormFunction.apply(x, weight, bias, num_groups, eps)
        return F.silu(y) if act == "silu" else y
    return group_norm_forward(x, num_groups, weight, bias, eps, act)[0]


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation x·(1 + scale) + shift with [B, C] params over [B, S, C]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]
